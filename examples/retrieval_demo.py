"""Gauss-Newton retrieval demo: recover (AOD scaling, surface albedo, gas
scaling) from synthetic radiances with jacfwd Jacobians.

Mirrors the reference's OCO-2 linearization prototype
(ref: test/prototyping/AD_OCO2_test.jl:71-160) with a synthetic truth in
place of the L1b granule (no instrument data ships with either repo).

Run: python examples/retrieval_demo.py
"""
import numpy as np

import jax
import jax.numpy as jnp

from vsmartmom.util.compile_cache import enable_compile_cache

_backend = jax.default_backend()
if _backend == "cpu":
    jax.config.update("jax_enable_x64", True)
enable_compile_cache()

from vsmartmom.core.autodiff import gauss_newton, make_radiance_fn
from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom.util.quadrature import rt_set_streams
from vsmartmom.util.timing import print_timer


def main():
    n_z, n_spec = 5, 64
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 12, 40.0, [0.0, 30.0],
                          pol.n)

    rng = np.random.default_rng(0)
    tau_scat = np.full((n_z, n_spec), 0.05)
    tau_abs0 = rng.uniform(0.05, 0.8, (n_z, n_spec))

    # On the GPU, run the retrieval THROUGH the engine rt_run's "auto"
    # picks (the fused layer-step kernel computes the primal and its
    # custom_jvp, the XLA-twin tangent, carries the Jacobian) — the analog
    # of the reference differentiating its CUBLAS path via Dual overloads
    # (ref: gpu_batched.jl:100-151). On CPU keep the exact f64 LU path.
    engine_kw = {}
    if _backend != "cpu":
        from vsmartmom.core.rt_run import (build_layer_schedules,
                                           choose_engine)
        tau0 = tau_scat + tau_abs0
        nd, sched, scheds = build_layer_schedules(
            tau0, tau_scat / tau0, float(np.min(quad.qp_mu)), "schulz")
        engine_kw = dict(dtype=jnp.float32, solver="schulz",
                         doubling_engine=choose_engine(
                             _backend, jnp.float32, len(quad.qp_mu_n), True),
                         layer_schedules=scheds, ndoubl_static=nd,
                         ns_schedule=sched)
    fn = make_radiance_fn(pol, quad, [get_greek_rayleigh(0.028)],
                          [0.0, 30.0], [0.0, 90.0], 3, n_z, n_spec,
                          **engine_kw)

    dt = engine_kw.get("dtype", jnp.float64)

    def forward(x):
        """State: [log AOD-like scaling, albedo, log gas scaling]."""
        tau = (jnp.asarray(tau_scat, dt) * jnp.exp(x[0])
               + jnp.asarray(tau_abs0, dt) * jnp.exp(x[2]))
        omega = jnp.asarray(tau_scat, dt) * jnp.exp(x[0]) / tau
        zw = jnp.ones((n_z, 1, n_spec), dt)
        return fn(tau, omega, zw, x[1]).ravel()

    x_true = jnp.array([0.3, 0.25, -0.1])
    y_meas = forward(x_true)
    y_noisy = y_meas * (1.0 + 1e-5 * rng.standard_normal(y_meas.shape))

    x_hat, hist = gauss_newton(lambda x: forward(x) - y_noisy,
                               jnp.array([0.0, 0.1, 0.0], dt), n_iter=6)
    print("truth:    ", np.asarray(x_true))
    print("retrieved:", np.asarray(x_hat))
    print("chi2 history:", [f"{h:.3e}" for h in hist])
    print_timer()
    atol = 1e-3 if dt == jnp.float64 else 5e-3
    assert np.allclose(np.asarray(x_hat), np.asarray(x_true), atol=atol)
    print("retrieval OK")


if __name__ == "__main__":
    main()
