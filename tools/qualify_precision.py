"""Qualify f32 matmul precisions on the GPU against the canonical
accuracy gates (6SV1 scalar Rayleigh, Natraj polarized I/Q/U).

The CI gates (tests/test_core_rt.py) run on CPU in f64; this tool re-runs
the same cases on the card in f32 with the XLA engines at each
jax.default_matmul_precision setting ("highest" = IEEE f32; "high" and
"default" let XLA use TF32 tensor-core passes), so the production
configuration itself is validated at the reference's tolerances (6SV1 <
0.006 rel; Natraj I < 0.002, Q/U < 0.008). It also reports the fused
layer-step kernel (IEEE f32, N <= rt_run.KERNEL_MAX_N) against the XLA
engine at that precision.

Usage: python tools/qualify_precision.py [highest high default dev ...]
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(os.path.dirname(__file__), "..", "tests", "data")

VZA_16 = [0.0, 11.4783, 16.2602, 23.0739, 32.8599, 43.9455, 50.2082, 58.6677,
          66.4218, 71.3371, 73.7398, 78.463, 80.7931, 84.2608, 86.5602,
          88.854]

CASES_6SV1 = [
    (1, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.1, 0.0),
    (2, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.1, 0.25),
    (3, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.25, 0.0),
    (4, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.25, 0.25),
    (5, [180, 90, 0], [23.0739, 53.1301, 78.4630], 0.50, 0.0),
    (6, [180, 90, 0], [0.0001, 36.8699, 66.4218], 0.50, 0.25),
]


def main(precisions):
    import jax.numpy as jnp

    from vsmartmom.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    pol = Polarization.from_name("Stokes_IQUV")
    greek = get_greek_rayleigh(0.0)
    results = {}

    for prec in precisions:
        # The accuracy gates' RadauQuad+16-VZA quadrature gives N=148 —
        # beyond the fused kernel's domain, so they run through the XLA
        # engines at the requested precision; the kernel is compared with
        # the XLA engine at the flagship's N separately below
        # (kernel_vs_xla_delta).
        #
        # "dev"-prefixed tokens qualify the direct/diffuse split engine
        # (core.rt doubling_dev/interaction_dev): "dev_highest" = split
        # algebra at IEEE f32, "dev_high" = split algebra at "high".
        if prec.startswith("dev"):
            xla_prec = {"dev": "highest", "dev_highest": "highest",
                        "dev_high": "high"}[prec]
            kw = dict(dtype=jnp.float32, solver="schulz",
                      doubling_engine="xla_dev", matmul_precision=xla_prec)
        else:
            # plain tokens pin the PLAIN XLA engine (rt_run_band's "auto"
            # now resolves to xla_dev at these N — measuring that would
            # mask the plain path this artifact documents)
            kw = dict(dtype=jnp.float32, solver="schulz",
                      doubling_engine="xla", matmul_precision=prec)

        r_trues = np.asarray(json.load(open(f"{DATA}/6sv1_r_trues.json")))
        worst6 = 0.0
        for ci, azs, szas, tau, rho in CASES_6SV1:
            for sza_i, sza in enumerate(szas):
                for az_i, az in enumerate(azs):
                    quad = rt_set_streams("RadauQuad", 20, sza, VZA_16,
                                          pol.n)
                    band = BandRTInputs(
                        tau=np.full((1, 2), tau), omega=np.ones((1, 2)),
                        zw=np.ones((1, 1, 2)), greeks=[greek])
                    R, _ = rt_run_band(
                        pol, quad, band, VZA_16, [az] * 16, 3,
                        {"type": "LambertianSurfaceScalar", "albedo": rho},
                        **kw)
                    r_model = R[:, 0, 0] / quad.mu0
                    r_true = r_trues[ci - 1, sza_i, az_i]
                    worst6 = max(worst6,
                                 float(np.max(np.abs(r_true - r_model)
                                              / r_true)))

        d = np.load(f"{DATA}/natraj_trues.npz")
        I_t, Q_t, U_t = d["I_trues"], d["Q_trues"], d["U_trues"]
        mu = np.array([0.02, 0.06, 0.10, 0.16, 0.20, 0.28, 0.32, 0.40, 0.52,
                       0.64, 0.72, 0.84, 0.92, 0.96, 0.98, 1.00])
        vza = np.degrees(np.arccos(mu))
        sza = np.degrees(np.arccos(0.2))
        quad = rt_set_streams("RadauQuad", 20, sza, vza, pol.n)
        band = BandRTInputs(tau=np.full((1, 2), 0.5), omega=np.ones((1, 2)),
                            zw=np.ones((1, 1, 2)), greeks=[greek])
        I_m = np.zeros((16, 7)); Q_m = np.zeros((16, 7)); U_m = np.zeros((16, 7))
        for j, phi in enumerate(np.arange(0.0, 181.0, 30.0)):
            R, _ = rt_run_band(pol, quad, band, vza, [phi] * 16, 3,
                               {"type": "LambertianSurfaceScalar",
                                "albedo": 0.0}, **kw)
            I_m[:, j], Q_m[:, j], U_m[:, j] = R[:, 0, 0], R[:, 1, 0], R[:, 2, 0]
        i_err = float(np.max(np.abs(I_t - I_m) / I_t))
        q_mask = Q_m >= 0.01
        q_err = float(np.max(np.abs(Q_t - Q_m)[q_mask] / np.abs(Q_t)[q_mask]))
        u_mask = U_m >= 0.01
        with np.errstate(invalid="ignore"):
            u_err = float(np.nanmax(np.abs(U_t - U_m)[u_mask]
                                    / np.abs(U_t)[u_mask]))
        # fused-kernel equivalence vs the XLA engine at the kernel's N
        delta = _kernel_vs_xla_delta(prec)
        ok = (worst6 < 0.006 and i_err < 0.002 and q_err < 0.008
              and u_err < 0.008)
        results[prec] = dict(sv6=worst6, natraj_i=i_err, natraj_q=q_err,
                             natraj_u=u_err, kernel_vs_xla_delta=delta,
                             gates_pass=ok)
        print(json.dumps({"precision": prec, **results[prec]}))
    return results


def _kernel_vs_xla_delta(prec, n_spec=512):
    """Max |pallas_step - xla| / max |xla| of the Fourier-0 source field at
    the flagship's N = 15 (Stokes-I), XLA products at ``prec`` (the
    kernel's own products are IEEE f32), on this device."""
    import jax
    import __graft_entry__ as g
    from vsmartmom.core.rt_run import _fourier_step, build_layer_schedules

    args, static = g._example_inputs(n_spec=n_spec, n_quad_half=12,
                                     n_stokes=1, n_z=6, dtype=np.float32)
    nd, sched, _ = build_layer_schedules(args["tau"], args["omega"],
                                         float(args["min_qp_mu"]), "schulz")
    xla_prec = {"dev": "highest", "dev_highest": "highest",
                "dev_high": "high"}.get(prec, prec)

    def run(engine):
        comp, _ = _fourier_step(
            *(jax.device_put(args[k]) for k in
              ("tau", "omega", "zw", "z_pp_c", "z_mp_c", "qp", "wt",
               "d_vec", "i0_vec")),
            args["albedo"], None, args["mu0"], args["mu0_node"],
            args["min_qp_mu"],
            i_mu0_n=static["i_mu0_n"], n_stokes=static["n_stokes"],
            is_m0=True, n_spec=n_spec, solver="schulz", ndoubl_static=nd,
            ns_schedule=sched, doubling_engine=engine,
            matmul_precision=xla_prec)
        return np.asarray(comp.j_m)
    a = run("pallas_step")
    b = run("xla_dev" if prec.startswith("dev") else "xla")
    return float(np.abs(a - b).max() / np.abs(b).max())


if __name__ == "__main__":
    main(sys.argv[1:] or ["highest", "high"])
