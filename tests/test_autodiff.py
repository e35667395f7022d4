"""Forward-AD gates: jacfwd through the full RT == finite differences,
and a Gauss-Newton toy retrieval recovers (AOD-like, albedo) state.

ref: the reference's linearization demo test/prototyping/AD_OCO2_test.jl
and the dual-number batched-linear-algebra overloads gpu_batched.jl:100-151.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vsmartmom.core.autodiff import gauss_newton, make_radiance_fn
from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
from vsmartmom.util.quadrature import rt_set_streams

VZA = [0.0, 45.0]
VAZ = [0.0, 90.0]


def _setup(n_z=3, n_spec=4):
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 40.0, VZA, pol.n)
    fn = make_radiance_fn(pol, quad, [get_greek_rayleigh(0.0)], VZA, VAZ,
                          2, n_z, n_spec)
    rng = np.random.default_rng(0)
    tau_scat = np.full((n_z, n_spec), 0.1)
    tau_abs = rng.uniform(0.0, 0.4, (n_z, n_spec))
    tau = jnp.asarray(tau_scat + tau_abs)
    omega = jnp.asarray(tau_scat) / tau
    zw = jnp.ones((n_z, 1, n_spec))
    return fn, tau, omega, zw


def test_jacfwd_matches_finite_differences():
    fn, tau, omega, zw = _setup()

    def f(x):
        # x = (log-AOD-like scaling of tau, albedo)
        scale = jnp.exp(x[0])
        t = tau * scale
        return fn(t, omega, zw, x[1])[0, 0, :]     # nadir I spectrum

    x0 = jnp.array([0.1, 0.2])
    J = jax.jacfwd(f)(x0)
    eps = 1e-6
    for k in range(2):
        dx = np.zeros(2)
        dx[k] = eps
        fd = (np.asarray(f(x0 + dx)) - np.asarray(f(x0 - dx))) / (2 * eps)
        np.testing.assert_allclose(np.asarray(J[:, k]), fd, rtol=2e-5,
                                   atol=1e-10)


def test_gauss_newton_retrieval():
    """Recover (tau-scaling, albedo) from synthetic 'measured' radiances."""
    fn, tau, omega, zw = _setup()

    x_true = jnp.array([0.25, 0.3])

    def forward(x):
        return fn(tau * jnp.exp(x[0]), omega, zw, x[1]).ravel()

    y_meas = forward(x_true)

    def residual(x):
        return forward(x) - y_meas

    x_hat, hist = gauss_newton(residual, jnp.array([0.0, 0.1]), n_iter=6)
    np.testing.assert_allclose(np.asarray(x_hat), np.asarray(x_true),
                               atol=1e-6)
    assert hist[-1] < hist[0] * 1e-8


def _setup_engine(engine, n_z=3, n_spec=4, dtype=jnp.float32):
    """Radiance fn on a production engine with static schedules built
    from the representative profile (rt_run.build_layer_schedules)."""
    from vsmartmom.core.rt_run import build_layer_schedules
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 40.0, VZA, pol.n)
    rng = np.random.default_rng(0)
    tau_scat = np.full((n_z, n_spec), 0.1)
    tau_abs = rng.uniform(0.0, 0.4, (n_z, n_spec))
    tau = tau_scat + tau_abs
    omega = tau_scat / tau
    nd, sched, scheds = build_layer_schedules(
        tau, omega, float(np.min(quad.qp_mu)), "schulz")
    fn = make_radiance_fn(pol, quad, [get_greek_rayleigh(0.0)], VZA, VAZ,
                          2, n_z, n_spec, dtype=dtype, solver="schulz",
                          doubling_engine=engine, layer_schedules=scheds,
                          ndoubl_static=nd, ns_schedule=sched)
    return fn, (jnp.asarray(tau, dtype), jnp.asarray(omega, dtype),
                jnp.ones((n_z, 1, n_spec), dtype))


@pytest.mark.parametrize("engine", ["xla_dev", "pallas_step_interpret"])
def test_jacfwd_through_production_engines(engine):
    """jacfwd through the production engines — the xla_dev split-form
    path natively, the fused layer-step kernel via its custom_jvp (kernel
    primal, XLA-twin tangent) — gated against f64 finite differences of
    the default CPU path (ref: the reference differentiates its
    production CUBLAS path, gpu_batched.jl:100-151)."""
    fn, (tau, omega, zw) = _setup_engine(engine)

    def f(x):
        return fn(tau * jnp.exp(x[0]), omega, zw, x[1])[0, 0, :]

    x0 = jnp.array([0.1, 0.2], jnp.float32)
    J = np.asarray(jax.jacfwd(f)(x0))
    assert np.all(np.isfinite(J)) and np.abs(J).max() > 0

    # f64 finite-difference truth from the default (LU/f64) path
    fn64, _ = _setup(n_z=3, n_spec=4)[0], None
    tau64, omega64, zw64 = (jnp.asarray(np.asarray(a), jnp.float64)
                            for a in (tau, omega, zw))

    def f64(x):
        return fn64(tau64 * jnp.exp(x[0]), omega64, zw64, x[1])[0, 0, :]

    eps = 1e-6
    for k in range(2):
        dx = np.zeros(2)
        dx[k] = eps
        fd = (np.asarray(f64(jnp.asarray(x0 + dx, jnp.float64)))
              - np.asarray(f64(jnp.asarray(x0 - dx, jnp.float64)))) / (2 * eps)
        # f32 engine + frozen quantized discretization vs f64 traced path:
        # agreement to ~1e-3 relative pins the tangent rule (a wrong sign
        # or missing term would be O(1))
        np.testing.assert_allclose(J[:, k], fd, rtol=0, atol=2e-3 * np.abs(fd).max())
