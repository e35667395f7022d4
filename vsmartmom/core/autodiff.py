"""Forward-mode differentiability through the full RT pipeline.

The reference threads ForwardDiff dual numbers through custom CUBLAS
overloads (ref: CoreRT/tools/gpu_batched.jl:100-151) and demonstrates
Jacobians w.r.t. a retrieval state vector (test/prototyping/AD_OCO2_test.jl).
In JAX the whole jitted RT step is natively differentiable — this module
provides an end-to-end differentiable radiance function and a Gauss-Newton
helper mirroring the reference's retrieval loop.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from vsmartmom.core.rt_run import _fourier_step_body
from vsmartmom.scattering.phase import Polarization, compute_Z_moments
from vsmartmom.util.quadrature import QuadPoints, nearest_point


def make_radiance_fn(pol: Polarization, quad: QuadPoints, greeks, vza, vaz,
                     max_m: int, n_z: int, n_spec: int,
                     dtype=jnp.float64, solver: str = "lu",
                     doubling_engine: str = "xla",
                     layer_schedules=None, ndoubl_static=None,
                     ns_schedule=None, matmul_precision: str = "highest"):
    """Build a jittable, differentiable radiance function.

    Returns f(tau, omega, zw, albedo) -> R of shape (n_vza, n_stokes,
    nSpec): the same Fourier-moment loop as rt_run_band, with the azimuthal
    synthesis inside jax so jacfwd/jvp flow end-to-end. Z matrices are
    geometry constants (independent of the optical-state inputs).

    ``doubling_engine``/``layer_schedules``: run the production engines
    under AD (ref: the reference differentiates its production CUBLAS path
    via Dual overloads, gpu_batched.jl:100-151). "xla_dev" is natively
    differentiable; the fused layer-step kernel ("pallas_step")
    differentiates through its custom_jvp (kernel primal, XLA-twin
    tangent — pallas/layer_step_kernel.py). Static schedules
    must be precomputed from a representative profile
    (rt_run.build_layer_schedules) because tau/omega are traced here; the
    Jacobian is then of the model at that frozen discretization — exactly
    the retrieval use case. Products run at ``matmul_precision``, as in
    rt_run_band.
    """
    n = len(quad.qp_mu_n)
    n_stokes = pol.n
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)

    i0_vec = np.zeros(n)
    i0_vec[quad.i_mu0_n:quad.i_mu0_n + n_stokes] = pol.i0
    d_vec = np.tile(pol.d, quad.n_quad)
    mu0_node = float(quad.qp_mu_n[quad.i_mu0_n])
    min_qp_mu = float(np.min(quad.qp_mu))

    z_pp, z_mp = [], []
    for m in range(max_m):
        zpps, zmps = [], []
        for gc in greeks:
            a, b = compute_Z_moments(pol, quad.qp_mu, gc, m)
            zpps.append(a)
            zmps.append(b)
        z_pp.append(jnp.asarray(np.stack(zpps), dtype))
        z_mp.append(jnp.asarray(np.stack(zmps), dtype))

    # host-precomputed azimuthal synthesis weights: (max_m, n_vza, n_stokes)
    # and view-angle gather indices
    big_cs = np.zeros((max_m, len(vza), n_stokes))
    i_mu_idx = np.array([nearest_point(quad.qp_mu, np.cos(np.deg2rad(v)))
                         for v in vza])
    for m in range(max_m):
        w = 0.5 if m == 0 else 1.0
        for i in range(len(vza)):
            cm = np.cos(np.deg2rad(m * vaz[i]))
            sm = np.sin(np.deg2rad(m * vaz[i]))
            big_cs[m, i] = w * np.array([cm, cm, sm, sm][:n_stokes])

    qp = jnp.asarray(quad.qp_mu_n, dtype)
    wt = jnp.asarray(quad.wt_mu_n, dtype)
    dv = jnp.asarray(d_vec, dtype)
    i0 = jnp.asarray(i0_vec, dtype)
    csw = jnp.asarray(big_cs, dtype)
    gather = jnp.asarray(np.stack([n_stokes * i_mu_idx + k
                                   for k in range(n_stokes)], axis=1))

    @jax.jit
    @jax.default_matmul_precision(matmul_precision)
    def radiance(tau, omega, zw, albedo):
        R = jnp.zeros((len(vza), n_stokes, n_spec), dtype)
        for m in range(max_m):
            comp, _ = _fourier_step_body(
                tau, omega, zw, z_pp[m], z_mp[m], qp, wt, dv, i0,
                albedo, None, jnp.asarray(quad.mu0, dtype),
                jnp.asarray(mu0_node, dtype), jnp.asarray(min_qp_mu, dtype),
                None, i_mu0_n=quad.i_mu0_n, n_stokes=n_stokes,
                is_m0=(m == 0), n_spec=n_spec, solver=solver,
                doubling_engine=doubling_engine,
                layer_schedules=layer_schedules,
                ndoubl_static=ndoubl_static, ns_schedule=ns_schedule,
                matmul_precision=matmul_precision)
            j_m = comp.j_m[:, gather]            # (nSpec, n_vza, n_stokes)
            R = R + csw[m][:, :, None] * jnp.transpose(j_m, (1, 2, 0))
        return R

    return radiance


def gauss_newton(residual_fn, x0, n_iter: int = 5, damping: float = 0.0):
    """Tiny Gauss-Newton driver with jacfwd Jacobians
    (mirrors test/prototyping/AD_OCO2_test.jl:71-160)."""
    x = jnp.asarray(x0)
    history = []
    jac = jax.jacfwd(residual_fn)
    for _ in range(n_iter):
        r = residual_fn(x)
        K = jac(x)
        A = K.T @ K + damping * jnp.eye(x.shape[0])
        x = x - jnp.linalg.solve(A, K.T @ r)
        history.append(float(jnp.sum(r**2)))
    return x, history
