"""Vegetation-canopy RT: directional cross-section (G) layers.

The reference's experimental canopy mode (ref: src/CoreRT/rt_run_canopy.jl,
CoreKernel/elemental_canopy.jl, types.jl:613-624
CoreDirectionalScatteringOpticalProperties) attenuates along each stream
with the Ross projection factor G(mu) — the mean leaf-area cross-section
seen from direction mu — and scatters with a bi-Lambertian leaf phase
function (the reference pulls both from CanopyOptics.jl; here they are
implemented directly: Ross-Goudriaan G and the classic uniform-LAD
bi-Lambertian area scattering phase function, Shultis & Myneni 1988).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dataclasses import dataclass
from typing import Optional, Sequence

from vsmartmom.core.rt import (LayerRT, bmv, doubling, doubling_number,
                               rsolve_lu)
from vsmartmom.scattering.phase import GreekCoefs


def ross_g(mu, chi: float = 0.0):
    """Ross-Goudriaan projection factor G(mu) for a leaf angle
    distribution parameterized by chi (0 = spherical -> G = 0.5;
    chi -> +1 planophile, chi -> -1 erectophile).
    """
    mu = np.asarray(mu, dtype=np.float64)
    chi = float(np.clip(chi, -0.4, 0.6))
    phi1 = 0.5 - 0.633 * chi - 0.33 * chi**2
    phi2 = 0.877 * (1.0 - 2.0 * phi1)
    return phi1 + phi2 * mu


def bilambertian_greek(rho_l: float, tau_l: float,
                       n_moments: int = 16) -> tuple:
    """Greek (Legendre-beta) expansion of the bi-Lambertian uniform-LAD
    area scattering phase function

        Gamma(beta) = (rho+tau)/(3 pi) (sin b - b cos b) + tau/3 cos b

    normalized so the 0th moment of p = 4 Gamma / (rho + tau) is 1.
    Returns (GreekCoefs (intensity-only), ssa = rho_l + tau_l).
    """
    from numpy.polynomial.legendre import leggauss, legvander
    assert rho_l >= 0 and tau_l >= 0 and rho_l + tau_l <= 1.0
    x, w = leggauss(256)                     # x = cos(beta)
    b = np.arccos(x)
    gamma = ((rho_l + tau_l) / (3.0 * np.pi)
             * (np.sin(b) - b * np.cos(b)) + tau_l / 3.0 * np.cos(b))
    p = 4.0 * gamma / max(rho_l + tau_l, 1e-12)
    ls = np.arange(n_moments)
    beta = (2 * ls + 1) / 2.0 * (legvander(x, n_moments - 1).T @ (w * p))
    beta = beta / beta[0]
    z = np.zeros(n_moments)
    gc = GreekCoefs(alpha=z, beta=beta, gamma=z, delta=beta.copy(),
                    epsilon=z, zeta=z)
    return gc, rho_l + tau_l


def elemental_directional(dtau, omega, z_pp, z_mp, g_proj, qp, wct2, wct02,
                          tau_sum, i0_vec, i_mu0_n, n_stokes, mu0_node):
    """Single-scattering init with per-stream projection factors G(mu).

    G == 1 reduces exactly to rt.elemental. ref: elemental_canopy.jl
    get_canopy_elem_rt!/..._SFI! (:63-160); dtau/omega (nSpec,),
    g_proj (N,) per Stokes-replicated stream.

    ``tau_sum`` is the EFFECTIVE (already projection-weighted) optical
    depth above this layer along the solar beam: plain atmospheric tau
    plus G(mu0)-weighted LAI of any canopy layers above — the caller
    composes mixed scenes (rt_run_canopy) by accumulating it.
    """
    dt = dtau[:, None, None]
    om = omega[:, None, None]
    mu_i = qp[:, None]
    mu_j = qp[None, :]
    g_i = g_proj[:, None]
    g_j = g_proj[None, :]
    same_mu = mu_i == mu_j
    eye = jnp.eye(qp.shape[0], dtype=bool)
    col_mask = wct2 > 1e-8

    # Scattering carries the incident-direction projection G(Omega_j): the
    # leaf area intercepts ~G(Omega') of the incoming beam and scatters
    # omega_leaf of it; our Z is a beta_0 = 1-normalized phase matrix (the
    # reference's CanopyOptics Gamma absorbs this factor instead). Without
    # it the effective per-path albedo is omega/G > 1 and doubling
    # diverges.
    r_mp = (om * g_j * z_mp * (mu_j / (mu_i * g_j + mu_j * g_i))
            * wct2[None, None, :]
            * (-jnp.expm1(-dt * (g_i / mu_i + g_j / mu_j))))
    r_mp = jnp.where(col_mask[None, None, :], r_mp, 0.0)

    exp_i = jnp.exp(-dt * g_i / mu_i)
    t_diag = exp_i * (1.0 + om * g_i * z_pp * (dt / mu_i)
                      * wct2[None, None, :])
    denom = jnp.where(same_mu, 1.0, mu_i * g_j - mu_j * g_i)
    exp_diff = (jnp.exp(-dt * g_j / mu_j)
                * jnp.expm1(dt * (g_j / mu_j - g_i / mu_i)))
    t_off = om * g_j * z_pp * (mu_j / denom) * wct2[None, None, :] * exp_diff
    t_pp = jnp.where(same_mu[None, :, :],
                     jnp.where(eye[None, :, :], t_diag, 0.0), t_off)
    t_pp = jnp.where(col_mask[None, None, :], t_pp,
                     jnp.where(eye[None, :, :],
                               exp_i * jnp.ones_like(t_pp), 0.0))

    # SFI sources with G-projected solar attenuation
    n_spec = dtau.shape[0]
    z_pp_i0 = bmv(jnp.broadcast_to(z_pp, (n_spec,) + z_pp.shape[-2:]),
                  jnp.broadcast_to(i0_vec, (n_spec, i0_vec.shape[0])))
    z_mp_i0 = bmv(jnp.broadcast_to(z_mp, (n_spec,) + z_mp.shape[-2:]),
                  jnp.broadcast_to(i0_vec, (n_spec, i0_vec.shape[0])))
    idx = jnp.arange(qp.shape[0])
    in_block = (idx >= i_mu0_n) & (idx < i_mu0_n + n_stokes)
    g0 = g_proj[i_mu0_n]

    mu_iv = qp[None, :]
    g_iv = g_proj[None, :]
    dt_v = dtau[:, None]
    denom0 = jnp.where(in_block[None, :], 1.0,
                       mu_iv * g0 - mu0_node * g_iv)
    exp_diff0 = (jnp.exp(-dt_v * g0 / mu0_node)
                 * jnp.expm1(dt_v * (g0 / mu0_node - g_iv / mu_iv)))
    j_p = jnp.where(
        in_block[None, :],
        (dt_v / mu_iv) * jnp.exp(-dt_v * g_iv / mu_iv),
        (mu0_node / denom0) * exp_diff0)
    j_p = wct02 * omega[:, None] * g0 * z_pp_i0 * j_p
    j_m = (wct02 * omega[:, None] * g0 * z_mp_i0
           * (mu0_node / (mu_iv * g0 + mu0_node * g_iv))
           * (-jnp.expm1(-dt_v * (g_iv / mu_iv + g0 / mu0_node))))

    atten = jnp.exp(-tau_sum / mu0_node)[:, None]
    return r_mp, t_pp, j_p * atten, j_m * atten


def make_canopy_layer(tau, omega, z_pp, z_mp, g_proj, tau_sum, qp, wct2,
                      wct02, i0_vec, i_mu0_n, n_stokes, mu0_node, mu0,
                      d_vec, min_qp_mu, eye, rsolve=rsolve_lu) -> LayerRT:
    """Canopy slab: directional elemental + doubling (ref:
    rt_kernel.jl:248-267 G-aware dtau/expk)."""
    dtype = tau.dtype
    tau_scat_max = jnp.max(tau * omega)
    # Elemental step 0.004*min(mu): single-scatter error O((dtau/mu)^2)
    # stays < ~3e-5 of radiance (measured f64), 2 fewer doublings/layer
    # than the reference's 0.001 factor.
    dtau_max = jnp.minimum(tau_scat_max, 0.004 * min_qp_mu)
    ndoubl = doubling_number(dtau_max, tau_scat_max)
    scale = 2.0 ** ndoubl.astype(dtype)
    dtau = tau / scale
    g0 = g_proj[i_mu0_n]
    expk = jnp.exp(-dtau * g0 / mu0)

    r_mp, t_pp, j_p, j_m = elemental_directional(
        dtau, omega, z_pp, z_mp, g_proj, qp, wct2, wct02, tau_sum,
        i0_vec, i_mu0_n, n_stokes, mu0_node)

    r_f = d_vec[None, :, None] * r_mp
    jm_f = d_vec[None, :] * j_m
    r_f, t_pp, j_p, jm_f = doubling(r_f, t_pp, j_p, jm_f, expk, ndoubl,
                                    eye, rsolve=rsolve)
    r_mp = d_vec[None, :, None] * r_f
    j_m = d_vec[None, :] * jm_f
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    return LayerRT(r_mp=r_mp, r_pm=sgn * r_mp, t_pp=t_pp, t_mm=sgn * t_pp,
                   j_p=j_p, j_m=j_m)


@dataclass(frozen=True)
class CanopyRTInputs:
    """A vegetation canopy slab for rt_run_canopy.

    lai: total leaf-area index of the canopy; split uniformly over
    ``n_layers`` slabs (distinct slabs matter only for in-canopy sensor
    levels — the doubling inside one slab is already exact).
    rho_l/tau_l: leaf hemispherical reflectance/transmittance (set the
    bi-Lambertian phase-function shape and the default single-scattering
    albedo rho_l + tau_l). ``ssa``: optional spectral override of the
    leaf albedo, scalar or (nSpec,) (the hyperspectral knob; the phase
    shape stays from rho_l/tau_l). chi: Ross-Goudriaan leaf-angle
    parameter (0 = spherical LAD, G = 0.5). ``g_override``: fix G(mu)
    to a constant (G = 1 reduces the canopy to a plain atmospheric
    layer with the bi-Lambertian phase — the reduction gate).
    """
    lai: float
    rho_l: float
    tau_l: float
    chi: float = 0.0
    n_layers: int = 1
    ssa: Optional[object] = None
    n_moments: int = 16
    g_override: Optional[float] = None


@jax.default_matmul_precision("highest")
def rt_run_canopy(pol, quad, band, canopy: CanopyRTInputs, vza, vaz,
                  max_m: int, surface, dtype=None, solver: str = "lu",
                  sensor_levels: Optional[Sequence[int]] = None):
    """Full canopy scene: atmosphere layers above a vegetation canopy over
    a (bi-)Lambertian soil, with HDRF/BHR outputs and optional in-canopy
    sensor levels.

    ref: src/CoreRT/rt_run_canopy.jl:10-487 — the reference appends one
    CoreDirectionalScatteringOpticalProperties canopy slab below the
    atmospheric layers, runs the same Fourier/layer machinery with
    G-projected attenuation, composes the soil BRDF, and synthesizes
    R/T/hdr/bhr. Here the canopy may be split into n_layers slabs and
    interior interfaces can be observed via the multisensor interlayer
    coupling ((I - R_top R_bot)^{-1}, ref: interlayer_flux.jl:7-25).

    band: atmospheric BandRTInputs ABOVE the canopy (nZ may be 0 for a
    bare canopy scene). surface: soil, same dict as rt_run_band
    (bi-Lambertian soil = LambertianSurfaceScalar).
    sensor_levels: canopy interface indices (0 = canopy top ...
    n_layers = soil top) at which to return (uw, dw) radiance fields.
    Products run at "highest" precision (IEEE f32), as in rt_run_band.

    Returns (R, T, hdr, bhr_uw, bhr_dw[, uw, dw]): R/T/hdr shaped
    (n_vza, n_stokes, nSpec); bhr_* (nSpec,); uw/dw
    (n_sensor, nSpec, N).
    """
    from vsmartmom.core.rt import interaction, make_added_layer, \
        make_rsolve, vacuum_layer
    from vsmartmom.core.surface import brdf_surface_layer, \
        lambertian_surface_layer
    from vsmartmom.core.brdf import brdf_fourier_matrix
    from vsmartmom.scattering.phase import compute_Z_moments
    from vsmartmom.util.quadrature import nearest_point

    if dtype is None:
        dtype = jnp.float64 if jax.config.read("jax_enable_x64") \
            else jnp.float32
    rsolve = make_rsolve(solver)
    n_spec = band.tau.shape[1]
    n_z_atm = band.tau.shape[0]
    n = len(quad.qp_mu_n)
    n_stokes = pol.n
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)

    d_vec = jnp.asarray(np.tile(pol.d, n // n_stokes), dtype)
    i0_vec_np = np.zeros(n)
    i0_vec_np[quad.i_mu0_n:quad.i_mu0_n + n_stokes] = pol.i0
    i0_vec = jnp.asarray(i0_vec_np, dtype)
    qp = jnp.asarray(quad.qp_mu_n, dtype)
    wt = jnp.asarray(quad.wt_mu_n, dtype)
    mu0 = jnp.asarray(quad.mu0, dtype)
    mu0_node = float(quad.qp_mu_n[quad.i_mu0_n])
    min_qp_mu = float(np.min(quad.qp_mu))
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (n_spec, n, n))

    # canopy geometry/optics (spectrally uniform phase, optional spectral
    # ssa) — the reference builds these once per moment from CanopyOptics
    if canopy.g_override is not None:
        g_proj = jnp.full(n, float(canopy.g_override), dtype)
    else:
        g_proj = jnp.asarray(ross_g(np.asarray(quad.qp_mu_n), canopy.chi),
                             dtype)
    g0 = float(g_proj[quad.i_mu0_n])
    gc_can, ssa_default = bilambertian_greek(canopy.rho_l, canopy.tau_l,
                                             canopy.n_moments)
    ssa_c = jnp.broadcast_to(
        jnp.asarray(ssa_default if canopy.ssa is None else canopy.ssa,
                    dtype), (n_spec,))
    tau_slab = jnp.full((n_spec,), canopy.lai / canopy.n_layers, dtype)

    # effective (projection-weighted) beam path above each interface
    tau_atm_tot = jnp.asarray(np.asarray(band.tau).sum(axis=0), dtype)
    tau_sum_atm = np.concatenate(
        [np.zeros((1, n_spec)), np.cumsum(np.asarray(band.tau), axis=0)],
        axis=0)
    lai_above = [g0 * canopy.lai / canopy.n_layers * k
                 for k in range(canopy.n_layers + 1)]
    tau_sum_soil = tau_atm_tot + lai_above[-1]

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

    sensors = sorted(sensor_levels) if sensor_levels else []
    assert all(0 <= s <= canopy.n_layers for s in sensors), \
        "sensor levels are canopy interface indices 0..n_layers"
    r_sfi = np.zeros((len(vza), n_stokes, n_spec))
    t_sfi = np.zeros((len(vza), n_stokes, n_spec))
    hdr = np.zeros((len(vza), n_stokes, n_spec))
    bhr_uw = np.zeros(n_spec)
    bhr_dw = np.zeros(n_spec)
    uw_out = np.zeros((len(sensors), len(vza), n_stokes, n_spec))
    dw_out = np.zeros_like(uw_out)

    for m in range(max_m):
        wct02 = jnp.asarray(0.5 if m == 0 else 0.25, dtype)
        wct2 = wt / 2.0 if m == 0 else wt / 4.0
        z_list = [compute_Z_moments(pol, quad.qp_mu, gck, m)
                  for gck in band.greeks]
        z_pp_c = jnp.asarray(np.stack([z[0] for z in z_list]), dtype)
        z_mp_c = jnp.asarray(np.stack([z[1] for z in z_list]), dtype)
        zc_pp, zc_mp = compute_Z_moments(pol, quad.qp_mu, gc_can, m)
        zc_pp = jnp.asarray(zc_pp, dtype)[None]
        zc_mp = jnp.asarray(zc_mp, dtype)[None]

        def atm_layer(iz):
            zw_z = jnp.asarray(band.zw[iz], dtype)
            z_pp = jnp.einsum("kn,kij->nij", zw_z, z_pp_c)
            z_mp = jnp.einsum("kn,kij->nij", zw_z, z_mp_c)
            return make_added_layer(
                jnp.asarray(band.tau[iz], dtype),
                jnp.asarray(band.omega[iz], dtype), z_pp, z_mp,
                jnp.asarray(tau_sum_atm[iz], dtype), qp, wct2, wct02,
                i0_vec, quad.i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                min_qp_mu, eye, rsolve=rsolve)

        def canopy_layer(k):
            return make_canopy_layer(
                tau_slab, ssa_c, zc_pp, zc_mp, g_proj,
                tau_atm_tot + lai_above[k], qp, wct2, wct02, i0_vec,
                quad.i_mu0_n, n_stokes, mu0_node, mu0, d_vec, min_qp_mu,
                eye, rsolve=rsolve)

        # TOA -> soil composition (atmosphere, then canopy slabs)
        comp = vacuum_layer(n_spec, n, dtype)
        tops = {}
        for iz in range(n_z_atm):
            comp = interaction(comp, atm_layer(iz), eye, rsolve=rsolve)
        if 0 in sensors:
            tops[0] = comp
        for k in range(canopy.n_layers):
            comp = interaction(comp, canopy_layer(k), eye, rsolve=rsolve)
            if (k + 1) in sensors:
                tops[k + 1] = comp

        # soil
        rho_brdf = (jnp.asarray(
            brdf_fourier_matrix(surface, quad.qp_mu, m, n_stokes), dtype)
            if is_brdf else None)
        if rho_brdf is not None:
            surf = brdf_surface_layer(rho_brdf, n_spec, qp, wt, i0_vec,
                                      tau_sum_soil, mu0, dtype)
        else:
            surf = lambertian_surface_layer(
                albedo, n_spec, n_stokes, qp, wt, i0_vec, tau_sum_soil,
                mu0, m == 0, dtype, spectral_albedo=spectral_albedo)

        # bottom composites for interior sensors (soil upward)
        if sensors:
            bots = {}
            acc = surf
            for k in range(canopy.n_layers - 1, -1, -1):
                if (k + 1) in sensors:
                    bots[k + 1] = acc
                acc = interaction(canopy_layer(k), acc, eye, rsolve=rsolve)
            if 0 in sensors:
                bots[0] = acc

        comp = interaction(comp, surf, eye, rsolve=rsolve)
        hdr_j_m = np.asarray(bmv(surf.r_mp, comp.j_p) + surf.j_m)

        # --- azimuthal synthesis (same as rt_run_band) -------------------
        j_m = np.asarray(comp.j_m)
        j_p = np.asarray(comp.j_p)
        weight = 0.5 if m == 0 else 1.0
        for i in range(len(vza)):
            i_mu = nearest_point(quad.qp_mu, np.cos(np.deg2rad(vza[i])))
            sl = slice(n_stokes * i_mu, n_stokes * (i_mu + 1))
            cm = np.cos(np.deg2rad(m * vaz[i]))
            sm = np.sin(np.deg2rad(m * vaz[i]))
            big_cs = weight * np.array([cm, cm, sm, sm][:n_stokes])
            r_sfi[i] += big_cs[:, None] * j_m[:, sl].T
            t_sfi[i] += big_cs[:, None] * j_p[:, sl].T
            hdr[i] += big_cs[:, None] * hdr_j_m[:, sl].T
        if m == 0:
            qw = (quad.qp_mu_n * quad.wt_mu_n)[::n_stokes]
            bhr_uw[:] = hdr_j_m[:, ::n_stokes] @ qw
            direct = i0_vec_np[quad.i_mu0_n] * np.exp(
                -np.asarray(tau_sum_soil) / mu0_node) * mu0_node
            bhr_dw[:] = j_p[:, ::n_stokes] @ qw + direct

        # --- in-canopy sensors: interlayer flux coupling -----------------
        # (ref: interlayer_flux.jl:7-25; synthesis as rt_run_band_ms)
        for si, s in enumerate(sensors):
            top, bot = tops[s], bots[s]
            a_dw = eye - jnp.einsum("nij,njk->nik", top.r_pm, bot.r_mp)
            dw_j = np.asarray(rsolve(
                (top.j_p + bmv(top.r_pm, bot.j_m))[:, None, :],
                a_dw.transpose(0, 2, 1))[:, 0, :])
            a_uw = eye - jnp.einsum("nij,njk->nik", bot.r_mp, top.r_pm)
            uw_j = np.asarray(rsolve(
                (bot.j_m + bmv(bot.r_mp, top.j_p))[:, None, :],
                a_uw.transpose(0, 2, 1))[:, 0, :])
            for i in range(len(vza)):
                i_mu = nearest_point(quad.qp_mu,
                                     np.cos(np.deg2rad(vza[i])))
                sl = slice(n_stokes * i_mu, n_stokes * (i_mu + 1))
                cm = np.cos(np.deg2rad(m * vaz[i]))
                sm = np.sin(np.deg2rad(m * vaz[i]))
                big_cs = weight * np.array([cm, cm, sm, sm][:n_stokes])
                uw_out[si, i] += big_cs[:, None] * uw_j[:, sl].T
                dw_out[si, i] += big_cs[:, None] * dw_j[:, sl].T

    out = [r_sfi, t_sfi, hdr, bhr_uw, bhr_dw]
    if sensors:
        out += [uw_out, dw_out]
    return tuple(out)
