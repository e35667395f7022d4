"""User-facing rt_run on an RTModel (mirrors the reference's entry point).

ref: src/CoreRT/rt_run.jl:19-230 and
     src/CoreRT/LayerOpticalProperties/compEffectiveLayerProperties.jl
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from vsmartmom.core.model import RTModel
from vsmartmom.core.rt_run import BandRTInputs, rt_run_band


def build_band_inputs(model: RTModel, i_band: int,
                      omega_cabannes: float = 1.0) -> BandRTInputs:
    """Mix Rayleigh + aerosols + gas absorption into core layer optical
    properties (tau, omega, component mixing weights).

    ref: compEffectiveLayerProperties.jl:1-85 (constructCoreOpticalProperties
    + createAero). The delta-BGE-truncated aerosols enter with
    tau' = (1 - f_t * ssa) tau and ssa' = (1 - f_t) ssa / (1 - f_t * ssa).
    """
    tau_rayl = model.tau_rayl[i_band]          # (nSpec, nZ)
    tau_abs = model.tau_abs[i_band]            # (nSpec, nZ)
    tau_aer = model.tau_aer[i_band]            # (nAer, nZ)
    n_spec, n_z = tau_rayl.shape
    n_aer = tau_aer.shape[0]

    # scattering components: Rayleigh first, then aerosols
    scat = np.zeros((n_z, 1 + n_aer, n_spec))
    scat[:, 0, :] = (tau_rayl * omega_cabannes).T
    tau_total = tau_rayl.T.copy()              # (nZ, nSpec)
    greeks = [model.greek_rayleigh]
    for i in range(n_aer):
        optics = model.aerosol_optics[i_band][i]
        f_t, ssa = optics.f_t, optics.ssa
        tau_mod = (1.0 - f_t * ssa) * tau_aer[i]        # (nZ,)
        ssa_mod = (1.0 - f_t) * ssa / (1.0 - f_t * ssa)
        tau_total += tau_mod[:, None]
        scat[:, 1 + i, :] = (tau_mod * ssa_mod)[:, None]
        greeks.append(optics.greek_coefs)
    tau_total += tau_abs.T

    scat_sum = scat.sum(axis=1)                          # (nZ, nSpec)
    omega = scat_sum / tau_total
    with np.errstate(invalid="ignore", divide="ignore"):
        zw = np.where(scat_sum[:, None, :] > 0,
                      scat / np.maximum(scat_sum[:, None, :], 1e-300), 0.0)
    return BandRTInputs(tau=tau_total, omega=omega, zw=zw, greeks=greeks)


def band_spec_lim(model: RTModel, bands: Sequence[int]):
    """Index ranges of each band on the concatenated spectral axis.

    ref: the reference's bandSpecLim bookkeeping (rt_run.jl:66-74,
    types.jl:665-670). Returns a list of ``slice`` objects.
    """
    lims, lo = [], 0
    for ib in bands:
        n = len(model.params.spec_bands[ib])
        lims.append(slice(lo, lo + n))
        lo += n
    return lims


def concat_band_inputs(model: RTModel, bands: Sequence[int]) -> BandRTInputs:
    """Concatenate several bands onto ONE spectral axis (single jit).

    ref: the reference's ``*`` band-concatenation operator on
    CoreScatteringOpticalProperties (types.jl:665-687) + bandSpecLim.
    Aerosol optics are wavelength-dependent, so each band contributes its
    own Z components; the mixing-weight rows are zero outside the band's
    spectral range, which keeps the on-device Z assembly exact.
    """
    parts = [build_band_inputs(model, ib) for ib in bands]
    n_z = parts[0].tau.shape[0]
    n_specs = [p.tau.shape[1] for p in parts]
    n_tot = sum(n_specs)

    tau = np.concatenate([p.tau for p in parts], axis=1)
    omega = np.concatenate([p.omega for p in parts], axis=1)

    # shared Rayleigh row + per-band aerosol component rows
    greeks = [parts[0].greeks[0]]
    k_tot = 1 + sum(len(p.greeks) - 1 for p in parts)
    zw = np.zeros((n_z, k_tot, n_tot))
    k = 1
    lo = 0
    for p, n_s in zip(parts, n_specs):
        zw[:, 0, lo:lo + n_s] = p.zw[:, 0, :]
        n_aer = len(p.greeks) - 1
        zw[:, k:k + n_aer, lo:lo + n_s] = p.zw[:, 1:, :]
        greeks.extend(p.greeks[1:])
        k += n_aer
        lo += n_s
    return BandRTInputs(tau=tau, omega=omega, zw=zw, greeks=greeks)


def _concat_surface(model: RTModel, bands: Sequence[int]):
    """Surface for the band-concatenated run: per-band Lambertian surfaces
    merge into one spectral-albedo vector; identical BRDF surfaces across
    every band pass through unchanged (their Fourier rho matrices are
    spectrally constant, so the concat axis is transparent to them).
    Returns None when bands mix BRDF types/parameters (per-band fallback).
    """
    from vsmartmom.core.brdf import legendre_spectral_albedo
    surfaces = model.params.surfaces
    per_band = [surfaces[min(ib, len(surfaces) - 1)] for ib in bands]
    if any(s["type"] in ("rpvSurfaceScalar", "RossLiSurfaceScalar")
           for s in per_band):
        if all(s == per_band[0] for s in per_band[1:]):
            return per_band[0]
        return None
    chunks = []
    for ib, s in zip(bands, per_band):
        n_s = len(model.params.spec_bands[ib])
        if s["type"] == "LambertianSurfaceScalar":
            chunks.append(np.full(n_s, float(s["albedo"])))
        elif s["type"] == "LambertianSurfaceSpectrum":
            chunks.append(np.asarray(s["albedo"], np.float64))
        elif s["type"] == "LambertianSurfaceLegendre":
            chunks.append(legendre_spectral_albedo(s["legendre_coeff"], n_s))
        else:
            return None
    return {"type": "LambertianSurfaceSpectrum",
            "albedo": np.concatenate(chunks)}


def rt_run(model: RTModel, i_band: Union[int, Sequence[int]] = 0,
           dtype=None, rs_type=None, **band_kw):
    """Run the forward RT simulation for the given band(s).

    ``rs_type`` selects inelastic (Raman) coupling, mirroring the
    reference's rt_run(RS_type, model, iBand) dispatch (ref:
    rt_run.jl:19-41):
      None or "noRS"         — elastic only; returns (R_SFI, T_SFI)
      "RRS"                  — rotational Raman built for each band's grid
      "VS_0to1" / "VS_1to0"  — vibrational Raman groups on each band's grid
      an inelastic spec / list of specs (RRS / AbsoluteRaman) — used as-is
    With Raman, returns (R_SFI, T_SFI, ieR_SFI, ieT_SFI): the elastic
    (Cabannes) radiances plus first-order Raman corrections.

    Shapes (n_vza, n_stokes, nSpec); multiple bands are concatenated along
    the spectral axis (ref: bandSpecLim bookkeeping in rt_run.jl:66-74).
    ``band_kw`` (elastic runs): passed to rt_run_band — ``solver``,
    ``doubling_engine``, ``matmul_precision``, ``mesh``.
    """
    import jax.numpy as jnp
    if dtype is None:
        dtype = jnp.float32 if model.params.float_type == "Float32" else jnp.float64
    bands = [i_band] if isinstance(i_band, int) else list(i_band)
    elastic_only = rs_type is None or rs_type == "noRS"

    # Elastic multi-band: concatenate bands onto ONE spectral axis so the
    # layer scan jits once and batches across bands (ref: rt_run.jl:66-74
    # bandSpecLim; types.jl:665-687 optical-property concatenation).
    # Falls back to per-band runs only when bands mix different BRDFs.
    if elastic_only and len(bands) > 1:
        surface = _concat_surface(model, bands)
        if surface is not None:
            band = concat_band_inputs(model, bands)
            return rt_run_band(
                model.pol, model.quad_points, band, model.obs_geom.vza,
                model.obs_geom.vaz, model.params.max_m, surface, dtype=dtype,
                **band_kw)

    outs = []
    for ib in bands:
        # reuse the last surface when fewer are given than bands
        # (the reference's VS configs do this)
        surfaces = model.params.surfaces
        surface = surfaces[min(ib, len(surfaces) - 1)]
        if elastic_only:
            band = build_band_inputs(model, ib)
            outs.append(rt_run_band(
                model.pol, model.quad_points, band, model.obs_geom.vza,
                model.obs_geom.vaz, model.params.max_m, surface,
                dtype=dtype, **band_kw))
            continue

        from vsmartmom.core.rt_raman import rt_run_band_rrs
        if isinstance(rs_type, str):
            from vsmartmom.inelastic import make_rrs, make_vs
            from vsmartmom.inelastic.rrs import make_rrs_profile
            grid = np.asarray(model.params.spec_bands[ib], np.float64)
            T_mean = float(np.mean(model.profile.T))
            if rs_type == "RRS":
                # per-layer temperature weights (ref: raman_atmo_prop.jl
                # builds Raman properties from each layer's T)
                specs = [make_rrs_profile(grid, model.profile.T)]
            elif rs_type in ("VS_0to1", "VS_1to0"):
                specs = make_vs(grid, T=T_mean, direction=rs_type[3:])
            else:
                raise ValueError(f"unknown rs_type {rs_type!r}")
        else:
            specs = rs_type if isinstance(rs_type, (list, tuple)) \
                else [rs_type]

        cab = min((getattr(s, "omega_cabannes", 1.0) for s in specs),
                  default=1.0)
        band = build_band_inputs(model, ib, omega_cabannes=cab)
        # Raman source strength: full Rayleigh fraction of the layer
        f_rayl = (model.tau_rayl[ib].T
                  / np.maximum(band.tau, 1e-300)).astype(np.float64)
        outs.append(rt_run_band_rrs(
            model.pol, model.quad_points, band, specs, f_rayl,
            model.obs_geom.vza, model.obs_geom.vaz, model.params.max_m,
            surface, dtype=dtype))
    return tuple(np.concatenate([o[i] for o in outs], axis=-1)
                 for i in range(len(outs[0])))
