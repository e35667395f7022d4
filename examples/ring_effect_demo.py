"""Ring-effect demo: rotational-Raman filling-in of an absorption line.

Runs the Raman-coupled RT over a band with a synthetic absorption feature
and prints the filling-in factor spectrum (the classic Grainger-Ring
signature that motivates the reference's RRS mode).

Run: python examples/ring_effect_demo.py
"""
import numpy as np

import jax

from vsmartmom.util.compile_cache import enable_compile_cache

_backend = jax.default_backend()
if _backend == "cpu":
    jax.config.update("jax_enable_x64", True)
enable_compile_cache()

from vsmartmom.core.rt_run import BandRTInputs, rt_run_band
from vsmartmom.core.rt_raman import rt_run_band_rrs
from vsmartmom.inelastic import make_rrs
from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom.util.quadrature import rt_set_streams


def main():
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.05}

    grid = np.arange(12740.0, 13268.0, 4.0)
    n_spec = len(grid)
    rrs = make_rrs(grid, T=250.0)
    print(f"nSpec={n_spec}  n_Raman={rrs.n_raman}  "
          f"Cabannes fraction={rrs.omega_cabannes:.4f}")

    tau_rayl = np.full((2, n_spec), 0.2)
    line = 2.5 * np.exp(-0.5 * ((grid - grid[n_spec // 2]) / 6.0) ** 2)
    tau = tau_rayl + line[None, :]
    f_rayl = tau_rayl / tau
    band = BandRTInputs(tau=tau,
                        omega=tau_rayl * rrs.omega_cabannes / tau,
                        zw=np.ones((2, 1, n_spec)),
                        greeks=[get_greek_rayleigh(rrs.depol_rayl)])

    R, T, ieR, ieT = rt_run_band_rrs(pol, quad, band, rrs, f_rayl,
                                     [0.0], [0.0], 2, surf)
    fill = ieR[0, 0] / R[0, 0]
    c = n_spec // 2
    print(f"filling-in: continuum {fill[10]:.4f}  line core {fill[c]:.4f} "
          f"(ratio {fill[c] / fill[10]:.2f})")
    assert fill[c] > fill[10]
    print("Ring effect reproduced")


if __name__ == "__main__":
    main()
