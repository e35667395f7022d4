"""Multi-sensor RT: radiances at arbitrary atmospheric levels.

Sensors sit at layer interfaces s = 0 (TOA) .. nZ (BOA). For each sensor the
atmosphere splits into a *top* composite (layers above) and a *bot* composite
(layers below + surface); the up/downwelling radiance at the interface
follows from coupling the two slabs:

    dwJ = (I - R_top^{+-} R_bot^{-+})^{-1} (J_top^+ + R_top^{+-} J_bot^-)
    uwJ = (I - R_bot^{-+} R_top^{+-})^{-1} (J_bot^- + R_bot^{-+} J_top^+)

ref: src/CoreRT/rt_run_multisensor.jl:14-192,
     src/CoreRT/CoreKernel/interlayer_flux.jl:7-25,
     src/CoreRT/CoreKernel/rt_kernel_multisensor.jl (top/bot composition).

Design: instead of the reference's per-sensor mutable top/bot
composite pairs updated inside the layer loop (1.5k LoC), we run the layer
scan in *segments* between consecutive sensor levels — forward from TOA for
the top composites, reverse from the surface for the bot composites — so
each atmospheric layer is still built exactly once per direction and
everything stays inside one jit.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from vsmartmom.core.rt import (bmv, interaction, make_added_layer,
                               make_rsolve, vacuum_layer)
from vsmartmom.core.rt_run import BandRTInputs, default_solver
from vsmartmom.core.surface import (brdf_surface_layer,
                                    lambertian_surface_layer)
from vsmartmom.scattering.phase import Polarization, compute_Z_moments
from vsmartmom.util.quadrature import QuadPoints, nearest_point


@partial(jax.jit, static_argnames=("i_mu0_n", "n_stokes", "is_m0", "n_spec",
                                   "solver", "sensor_levels"))
def _fourier_step_ms(tau, omega, zw, z_pp_c, z_mp_c, qp, wt, d_vec, i0_vec,
                     albedo, spectral_albedo, mu0, mu0_node, min_qp_mu,
                     rho_brdf=None,
                     *, i_mu0_n, n_stokes, is_m0, n_spec, solver,
                     sensor_levels):
    with jax.default_matmul_precision("highest"):
        return _fourier_step_ms_body(
            tau, omega, zw, z_pp_c, z_mp_c, qp, wt, d_vec, i0_vec, albedo,
            spectral_albedo, mu0, mu0_node, min_qp_mu, rho_brdf,
            i_mu0_n=i_mu0_n, n_stokes=n_stokes, is_m0=is_m0, n_spec=n_spec,
            solver=solver, sensor_levels=sensor_levels)


def _fourier_step_ms_body(tau, omega, zw, z_pp_c, z_mp_c, qp, wt, d_vec,
                          i0_vec, albedo, spectral_albedo, mu0, mu0_node,
                          min_qp_mu, rho_brdf,
                          *, i_mu0_n, n_stokes, is_m0, n_spec, solver,
                          sensor_levels):
    rsolve = make_rsolve(solver)
    dtype = tau.dtype
    n = qp.shape[0]
    n_z = tau.shape[0]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (n_spec, n, n))
    wct02 = jnp.asarray(0.5 if is_m0 else 0.25, dtype)
    wct2 = wt / 2.0 if is_m0 else wt / 4.0

    tau_sum_all = jnp.concatenate(
        [jnp.zeros((1, tau.shape[1]), dtype), jnp.cumsum(tau, axis=0)],
        axis=0)

    def layer(iz_inputs):
        tau_z, omega_z, zw_z, tau_sum_z = iz_inputs
        z_pp = jnp.einsum("kn,kij->nij", zw_z, z_pp_c)
        z_mp = jnp.einsum("kn,kij->nij", zw_z, z_mp_c)
        return make_added_layer(
            tau_z, omega_z, z_pp, z_mp, tau_sum_z, qp, wct2, wct02,
            i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec, min_qp_mu, eye,
            rsolve=rsolve)

    def seg_inputs(lo, hi):
        return (tau[lo:hi], omega[lo:hi], zw[lo:hi], tau_sum_all[lo:hi])

    # --- top composites: forward segments TOA -> each sensor level --------
    tops = {}
    comp = vacuum_layer(n_spec, n, dtype)
    prev = 0
    for s in sorted(sensor_levels):
        if s > prev:
            def fwd(c, inp):
                return interaction(c, layer(inp), eye, rsolve=rsolve), None
            comp, _ = jax.lax.scan(fwd, comp, seg_inputs(prev, s))
            prev = s
        tops[s] = comp

    # --- bot composites: reverse segments surface -> each sensor level ---
    if rho_brdf is not None:
        surf = brdf_surface_layer(rho_brdf, n_spec, qp, wt, i0_vec,
                                  tau_sum_all[-1], mu0, dtype)
    else:
        surf = lambertian_surface_layer(
            albedo, n_spec, n_stokes, qp, wt, i0_vec, tau_sum_all[-1], mu0,
            is_m0, dtype, spectral_albedo=spectral_albedo)
    bots = {}
    acc = surf
    prev = n_z
    for s in sorted(sensor_levels, reverse=True):
        if s < prev:
            def bwd(c, inp):
                # prepend layer on top of the accumulated bottom slab
                return interaction(layer(inp), c, eye, rsolve=rsolve), None
            acc, _ = jax.lax.scan(bwd, acc, seg_inputs(s, prev),
                                  reverse=True)
            prev = s
        bots[s] = acc

    # --- interlayer flux coupling per sensor ------------------------------
    def lsolve_vec(a, v):
        """a^{-1} v for batched (nSpec, N, N) a and (nSpec, N) v."""
        return rsolve(v[:, None, :], a.transpose(0, 2, 1))[:, 0, :]

    uw, dw = [], []
    for s in sensor_levels:
        top, bot = tops[s], bots[s]
        a_dw = eye - jnp.einsum("nij,njk->nik", top.r_pm, bot.r_mp)
        dw_j = lsolve_vec(a_dw, top.j_p + bmv(top.r_pm, bot.j_m))
        a_uw = eye - jnp.einsum("nij,njk->nik", bot.r_mp, top.r_pm)
        uw_j = lsolve_vec(a_uw, bot.j_m + bmv(bot.r_mp, top.j_p))
        uw.append(uw_j)
        dw.append(dw_j)
    return jnp.stack(uw), jnp.stack(dw)     # (nSensor, nSpec, N)


def rt_run_band_ms(pol: Polarization, quad: QuadPoints, band: BandRTInputs,
                   vza, vaz, max_m: int, surface,
                   sensor_levels: Sequence[int], dtype=jnp.float64,
                   solver: str = None):
    """Multi-sensor forward run for one band.

    sensor_levels: layer-interface indices, 0 = TOA .. nZ = BOA.
    Returns (uwJ, dwJ) of shape (nSensor, n_vza, n_stokes, nSpec)
    (ref: rt_run_multisensor.jl:14-192 rt_run_test_ms).
    """
    if solver is None:
        solver = default_solver(jax.default_backend())
    n_spec = band.tau.shape[1]
    n = len(quad.qp_mu_n)
    n_stokes = pol.n
    n_z = band.tau.shape[0]
    sensor_levels = tuple(int(s) for s in sensor_levels)
    assert all(0 <= s <= n_z for s in sensor_levels), "bad sensor level"
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)

    i0_vec = np.zeros(n)
    i0_vec[quad.i_mu0_n:quad.i_mu0_n + n_stokes] = pol.i0
    d_vec = np.tile(pol.d, quad.n_quad)
    mu0_node = float(quad.qp_mu_n[quad.i_mu0_n])
    min_qp_mu = float(np.min(quad.qp_mu))

    albedo = 0.0
    spectral_albedo = None
    is_brdf = surface["type"] in ("rpvSurfaceScalar", "RossLiSurfaceScalar")
    if surface["type"] == "LambertianSurfaceScalar":
        albedo = float(surface["albedo"])
    elif surface["type"] == "LambertianSurfaceSpectrum":
        spectral_albedo = jnp.asarray(surface["albedo"], dtype)
    elif surface["type"] == "LambertianSurfaceLegendre":
        from vsmartmom.core.brdf import legendre_spectral_albedo
        spectral_albedo = jnp.asarray(
            legendre_spectral_albedo(surface["legendre_coeff"], n_spec),
            dtype)
    elif not is_brdf:
        raise NotImplementedError(surface["type"])

    uw_out = np.zeros((len(sensor_levels), len(vza), n_stokes, n_spec))
    dw_out = np.zeros_like(uw_out)

    to_dev = lambda x: jnp.asarray(x, dtype)
    for m in range(max_m):
        z_pp_list, z_mp_list = [], []
        for gc in band.greeks:
            zpp, zmp = compute_Z_moments(pol, quad.qp_mu, gc, m)
            z_pp_list.append(zpp)
            z_mp_list.append(zmp)

        rho_brdf = None
        if is_brdf:
            from vsmartmom.core.brdf import brdf_fourier_matrix
            rho_brdf = to_dev(brdf_fourier_matrix(surface, quad.qp_mu, m,
                                                  n_stokes))

        uw_j, dw_j = _fourier_step_ms(
            to_dev(band.tau), to_dev(band.omega), to_dev(band.zw),
            to_dev(np.stack(z_pp_list)), to_dev(np.stack(z_mp_list)),
            to_dev(quad.qp_mu_n), to_dev(quad.wt_mu_n), to_dev(d_vec),
            to_dev(i0_vec), jnp.asarray(albedo, dtype), spectral_albedo,
            jnp.asarray(quad.mu0, dtype), jnp.asarray(mu0_node, dtype),
            jnp.asarray(min_qp_mu, dtype), rho_brdf,
            i_mu0_n=quad.i_mu0_n, n_stokes=n_stokes, is_m0=(m == 0),
            n_spec=n_spec, solver=solver, sensor_levels=sensor_levels)
        uw_j = np.asarray(uw_j)
        dw_j = np.asarray(dw_j)

        # azimuthal synthesis (ref: tools/postprocessing_vza_ms.jl)
        weight = 0.5 if m == 0 else 1.0
        for i in range(len(vza)):
            i_mu = nearest_point(quad.qp_mu, np.cos(np.deg2rad(vza[i])))
            sl = slice(n_stokes * i_mu, n_stokes * (i_mu + 1))
            cm = np.cos(np.deg2rad(m * vaz[i]))
            sm = np.sin(np.deg2rad(m * vaz[i]))
            big_cs = weight * np.array([cm, cm, sm, sm][:n_stokes])
            uw_out[:, i] += big_cs[None, :, None] * uw_j[:, :, sl].transpose(0, 2, 1)
            dw_out[:, i] += big_cs[None, :, None] * dw_j[:, :, sl].transpose(0, 2, 1)

    return uw_out, dw_out


def rt_run_ms(model, sensor_levels: Sequence[int], i_band: int = 0,
              dtype=None):
    """Multi-sensor run from an RTModel (mirrors rt_run_test_ms)."""
    from vsmartmom.core.api import build_band_inputs
    if dtype is None:
        dtype = (jnp.float32 if model.params.float_type == "Float32"
                 else jnp.float64)
    band = build_band_inputs(model, i_band)
    return rt_run_band_ms(model.pol, model.quad_points, band,
                          model.obs_geom.vza, model.obs_geom.vaz,
                          model.params.max_m,
                          model.params.surfaces[i_band], sensor_levels,
                          dtype=dtype)
