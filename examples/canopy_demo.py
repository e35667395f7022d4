"""Canopy scene demo: red-edge reflectance of vegetation under an
atmosphere, with in-canopy radiation profiles.

Builds a Rayleigh atmosphere over a 3-slab vegetation canopy over dark
soil, sweeps the leaf single-scattering albedo across a PROSPECT-like
red edge (0.25 -> 0.95), and prints TOA reflectance, HDRF, and the
downwelling profile inside the canopy (the light available at each
canopy depth). Mirrors the reference's rt_run_canopy capability
(ref: src/CoreRT/rt_run_canopy.jl:10-487).

Run: PYTHONPATH=. python examples/canopy_demo.py
"""
import numpy as np

import jax

from vsmartmom.util.compile_cache import enable_compile_cache

_backend = jax.default_backend()
if _backend == "cpu":
    jax.config.update("jax_enable_x64", True)
enable_compile_cache()

from vsmartmom.core.canopy import CanopyRTInputs, rt_run_canopy
from vsmartmom.core.rt_run import BandRTInputs
from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom.util.quadrature import rt_set_streams


def main():
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 30.0, [0.0], pol.n)

    # "red edge": leaf albedo from strongly absorbing (red) to strongly
    # scattering (NIR) across the spectral axis
    n_spec = 6
    ssa = np.linspace(0.25, 0.95, n_spec)

    # thin Rayleigh atmosphere above
    n_z = 2
    tau = np.full((n_z, n_spec), 0.04)
    band = BandRTInputs(tau=tau, omega=np.full_like(tau, 0.999),
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.03)])
    canopy = CanopyRTInputs(lai=3.0, rho_l=0.45, tau_l=0.40, chi=0.1,
                            n_layers=3, ssa=ssa)
    soil = {"type": "LambertianSurfaceScalar", "albedo": 0.05}

    R, T, hdr, bhr_uw, bhr_dw, uw, dw = rt_run_canopy(
        pol, quad, band, canopy, [0.0], [0.0], 3, soil,
        sensor_levels=[0, 1, 2, 3])

    print("leaf ssa:          ", " ".join(f"{v:6.2f}" for v in ssa))
    print("TOA reflectance:   ", " ".join(f"{v:6.3f}" for v in R[0, 0]))
    print("HDRF (surface):    ", " ".join(f"{v:6.3f}" for v in hdr[0, 0]))
    print("BHR up/down ratio: ", " ".join(
        f"{u/d:6.3f}" for u, d in zip(bhr_uw, bhr_dw)))
    i_nadir = 0
    print("DIFFUSE downwelling I at canopy interfaces (top->soil; the\n"
          "  direct beam converts to diffuse inside the canopy, so the\n"
          "  profile peaks below the top then decays):")
    for k in range(4):
        print(f"  level {k}:", " ".join(f"{v:8.1e}"
                                        for v in dw[k, i_nadir, 0]))

    # physical checks: reflectance rises along the red edge; light decays
    # downward through the canopy at the absorbing end
    assert np.all(np.diff(R[0, 0]) > 0)
    assert dw[3, 0, 0, 0] < dw[1, 0, 0, 0]
    print("canopy demo OK")


if __name__ == "__main__":
    main()
