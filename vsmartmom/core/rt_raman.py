"""Inelastic (Raman) doubling-adding RT core.

Design. The reference implements ~2000 lines of index-shifted
CUDA kernels for the Raman-coupled doubling/adding equations
(ref: src/CoreRT/CoreKernel/{elemental,doubling,interaction}_inelastic.jl
 and the concatenated-band variants *_inelastic_plus.jl).
The key observation used here: the ``ie*`` arrays are *first-order
perturbations*, and every one of those update rules is exactly the elastic
adding algebra applied to upper-triangular 2x2 block operators

    O = [[E(n1), ie(n1, dn)], [0, E(n0)]],  n0 = src(dn, n1)

whose diagonal blocks are the elastic operators at the output (n1) and
source (n0) wavelengths and whose off-diagonal block is the Raman coupling.
Block products/inverses give the mixed-wavelength rules mechanically:

    (X Y)_ie   = X_1 Y_ie + X_ie Y_0
    ((I-M)^-1)_ie = (I-M_1)^-1 M_ie (I-M_0)^-1

so the whole inelastic core is ~10 algebraic lines per operation, vmapped
over the Raman shift axis, with the "n0" operands obtained by gathering the
elastic arrays along the spectral axis. (The reference hand-expanded these
products; two of its expansions contain ordering/sign slips on commutator
terms — doubling_inelastic.jl:104-118, elemental_inelastic.jl:131-136 —
which the systematic block algebra avoids; we verify against brute-force
composition of the full (2N x 2N) block matrices in tests.)

Coupling representation (unifies RRS / RRS_plus / VS_plus / RVRS): each
Raman "shift" row dn carries a per-output source-index map src[dn, n1], a
validity mask, and a per-output weight w[dn, n1].  For plain RRS the map is
the banded roll n1 + shift[dn] with a scalar weight (ref:
Inelastic/types.jl RRS i_lambda1lambda0/omega_lambda1lambda0); for the
concatenated-band ``_plus`` modes it holds absolute indices into the
concatenated spectral axis (ref: Inelastic/types.jl RRS_plus/VS_*_plus
i_lambda1lambda0_all, raman_atmo_prop.jl:211-244).

Shapes: elastic arrays (nSpec, N, N) / (nSpec, N); ie arrays carry a
leading Raman-shift axis (nR, nSpec, N, N) / (nR, nSpec, N).
"""
from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from vsmartmom.core.rt import (LayerRT, bmm, bmv, doubling_number, elemental,
                               interaction, make_rsolve, vacuum_layer)
from vsmartmom.core.rt_run import default_solver


#: Default precision of the ie products (see bmm_ie; PERF.md has the
#: f32-vs-f64 errors and times of "highest" and "high" on an H100).
IE_PRECISION = "highest"


def bmm_ie(a, b):
    """Batched matmul for the first-order (ie) operands. The ie operators
    are perturbation-scale (no ~1.0 transmission diagonal rides these
    products), so a reduced-precision product's absolute floor is small
    RELATIVE to the ie result. Env VSM_RAMAN_IE_PRECISION: highest
    (IEEE f32) | high | default (the backend's fastest f32 mode, TF32 on
    the GPU); IE_PRECISION when unset. Read at trace time."""
    prec = {"highest": lax.Precision.HIGHEST, "high": lax.Precision.HIGH,
            "default": lax.Precision.DEFAULT}[
        os.environ.get("VSM_RAMAN_IE_PRECISION", IE_PRECISION)]
    return jnp.matmul(a, b, precision=prec)


class IELayer(NamedTuple):
    """First-order Raman coupling operators, leading axis = Raman shift."""
    r_mp: jnp.ndarray
    r_pm: jnp.ndarray
    t_pp: jnp.ndarray
    t_mm: jnp.ndarray
    j_p: jnp.ndarray
    j_m: jnp.ndarray


def zero_ie(n_r: int, n_spec: int, n: int, dtype) -> IELayer:
    zm = jnp.zeros((n_r, n_spec, n, n), dtype)
    zv = jnp.zeros((n_r, n_spec, n), dtype)
    return IELayer(zm, zm, zm, zm, zv, zv)


# --- source-index coupling maps ---------------------------------------------

def coupling_rows_from_shifts(shifts, n_spec: int):
    """Banded rolls: src[dn, n1] = n1 + shifts[dn] (clipped), plus mask."""
    idx = jnp.arange(n_spec)
    src = idx[None, :] + jnp.asarray(shifts)[:, None]
    valid = (src >= 0) & (src < n_spec)
    return jnp.clip(src, 0, n_spec - 1).astype(jnp.int32), valid


def _as_rows(shift, n_spec: int):
    """Scalar/1-D int shift(s) -> (src, valid) rows; pass tuples through."""
    if isinstance(shift, tuple):
        return shift
    s = jnp.asarray(shift)
    if s.ndim == 0:
        src, valid = coupling_rows_from_shifts(s[None], n_spec)
        return src[0], valid[0]
    if s.ndim == 1 and jnp.issubdtype(s.dtype, jnp.integer):
        return coupling_rows_from_shifts(s, n_spec)
    raise TypeError("shift must be int scalar/vector or (src, valid) tuple")


def take0(x, src, valid):
    """x evaluated at the source index map (zero outside the grid)."""
    y = jnp.take(x, src, axis=0, mode="clip")
    return jnp.where(valid.reshape(valid.shape + (1,) * (x.ndim - 1)),
                     y, 0.0)


def take0_id(a, src, valid, eye):
    """Like take0 for (I - B)-type matrices: identity outside the grid,
    keeping the batched solves nonsingular (the ie operands there are zero
    anyway, so the result is unaffected)."""
    y = jnp.take(a, src, axis=0, mode="clip")
    return jnp.where(valid[:, None, None], y, eye)


def roll0(x, s):
    """x evaluated at source index n + s (zero outside the grid)."""
    n = x.shape[0]
    y = jnp.roll(x, -s, axis=0)
    idx = jnp.arange(n)
    valid = (idx + s >= 0) & (idx + s < n)
    return jnp.where(valid.reshape((n,) + (1,) * (x.ndim - 1)), y, 0.0)


def roll0_id(a, s, eye):
    """Identity-outside variant of roll0 (see take0_id)."""
    n = a.shape[0]
    y = jnp.roll(a, -s, axis=0)
    idx = jnp.arange(n)
    valid = (idx + s >= 0) & (idx + s < n)
    return jnp.where(valid[:, None, None], y, eye)


# --- inelastic elemental (single scattering) --------------------------------

def ie_elemental(shift, w_shift, dtau, f_rayl, tau_sum, z_pp_r, z_mp_r,
                 qp, wct2, wct02, i0_vec, i_mu0_n, n_stokes, mu0_node):
    """Raman-coupled single-scattering operators for ONE shift dn.

    ``shift`` is an int offset or an (src, valid) index-map row; ``w_shift``
    a scalar or per-output (nSpec,) coupling weight.  Two-wavelength
    generalization of the elastic elemental expressions: incident light
    attenuates with dtau0 (source wavelength), scattered light with dtau1
    (ref: elemental_inelastic.jl:93-162, 320-383; smooth equal-dtau limits
    implemented with expm1 instead of branch thresholds).
    Returns (ier_mp, iet_pp, iej_p, iej_m) for output wavelengths n1.
    """
    n_spec = dtau.shape[0]
    src, valid = _as_rows(shift, n_spec)
    dt1 = dtau[:, None, None]
    dt0_s = take0(dtau, src, valid)
    # coupling strength: w(output) * Rayleigh-scatter fraction at source
    f0 = w_shift * take0(f_rayl, src, valid)
    dt0 = dt0_s[:, None, None]
    cpl = f0[:, None, None]
    mu_i = qp[:, None]
    mu_j = qp[None, :]
    eye_b = jnp.eye(qp.shape[0], dtype=bool)
    col_mask = wct2 > 1e-8

    # R^-+: cpl Z^-+ (mu_j dt0 / (mu_i dt0 + mu_j dt1)) (1 - e^{-dt1/mu_i - dt0/mu_j}) w_j
    denom_r = mu_i * dt0 + mu_j * dt1
    r_ie = (cpl * z_mp_r * (mu_j * dt0 / jnp.where(denom_r == 0, 1.0,
                                                   denom_r))
            * (-jnp.expm1(-(dt1 / mu_i + dt0 / mu_j)))
            * wct2[None, None, :])
    r_ie = jnp.where(col_mask[None, None, :], r_ie, 0.0)

    # T^++ off-diagonal: cpl Z^++ mu_j dt0 (e^{-dt1/mu_i} - e^{-dt0/mu_j})
    #                    / (mu_i dt0 - mu_j dt1) w_j
    num_t = jnp.exp(-dt1 / mu_i) - jnp.exp(-dt0 / mu_j)
    den_t = mu_i * dt0 - mu_j * dt1
    small = jnp.abs(den_t) < 1e-30
    t_off = (cpl * z_pp_r * mu_j * dt0
             * jnp.where(small, 0.0, num_t / jnp.where(small, 1.0, den_t))
             * wct2[None, None, :])
    # diagonal (mu_i == mu_j): smooth limit dt0 (e^{-dt1/mu} - e^{-dt0/mu})
    #                          / (dt0 - dt1) -> (dt0/mu) e^{-dt0/mu}
    dd = (dt0 - dt1) / mu_i
    ratio = jnp.where(jnp.abs(dd) > 1e-10,
                      jnp.expm1(dd) / jnp.where(jnp.abs(dd) > 1e-10, dd, 1.0),
                      1.0 + dd / 2.0)
    t_diag = cpl * z_pp_r * (dt0 / mu_i) * jnp.exp(-dt0 / mu_i) * ratio \
        * wct2[None, None, :]
    same_mu = mu_i == mu_j
    t_ie = jnp.where(same_mu[None, :, :],
                     jnp.where(eye_b[None, :, :], t_diag, 0.0), t_off)
    t_ie = jnp.where(col_mask[None, None, :], t_ie, 0.0)

    # --- SFI sources ---
    z_pp_i0 = z_pp_r @ i0_vec                 # (N,)
    z_mp_i0 = z_mp_r @ i0_vec
    idx = jnp.arange(qp.shape[0])
    in_block = (idx >= i_mu0_n) & (idx < i_mu0_n + n_stokes)

    mu_iv = qp[None, :]
    dt1v = dtau[:, None]
    dt0v = dt0_s[:, None]
    cplv = f0[:, None]

    # in-block: dt0 (e^{-dt1/mu} - e^{-dt0/mu}) / (dt0 - dt1)
    ddv = (dt0v - dt1v) / mu_iv
    ratio_v = jnp.where(jnp.abs(ddv) > 1e-10,
                        jnp.expm1(ddv) / jnp.where(jnp.abs(ddv) > 1e-10,
                                                   ddv, 1.0),
                        1.0 + ddv / 2.0)
    jp_in = (dt0v / mu_iv) * jnp.exp(-dt0v / mu_iv) * ratio_v
    # out-of-block: mu0 dt0 (e^{-dt1/mu_i} - e^{-dt0/mu0}) / (mu_i dt0 - mu0 dt1)
    num_j = jnp.exp(-dt1v / mu_iv) - jnp.exp(-dt0v / mu0_node)
    den_j = mu_iv * dt0v - mu0_node * dt1v
    small_j = jnp.abs(den_j) < 1e-30
    jp_out = mu0_node * dt0v * jnp.where(
        small_j, 0.0, num_j / jnp.where(small_j, 1.0, den_j))
    iej_p = (wct02 * cplv * z_pp_i0[None, :]
             * jnp.where(in_block[None, :], jp_in, jp_out))

    denom_m = mu_iv * dt0v + mu0_node * dt1v
    iej_m = (wct02 * cplv * z_mp_i0[None, :]
             * (mu0_node * dt0v / jnp.where(denom_m == 0, 1.0, denom_m))
             * (-jnp.expm1(-(dt1v / mu_iv + dt0v / mu0_node))))

    atten = jnp.exp(-take0(tau_sum, src, valid) / mu0_node)[:, None]
    return r_ie, t_ie, iej_p * atten, iej_m * atten


# --- Raman-coupled doubling -------------------------------------------------

def raman_doubling(r, t, jp, jm, ek, ier, iet, iejp, iejm, shifts, ndoubl,
                   eye, rsolve, ns_schedule=None):
    """Joint elastic + first-order-Raman doubling (flipped space).

    Elastic recursion identical to rt.doubling; ie updates are the
    off-diagonal blocks of the same algebra (see module docstring).
    ``shifts``: int (nR,) banded offsets or a ((nR, nSpec) src,
    (nR, nSpec) valid) tuple. ``ns_schedule``: optional static per-step
    Newton-Schulz iteration counts (the elastic engine's scheduled-NS
    lever, ns_doubling_schedule) — statically unrolled; thin early steps
    then solve with 0-1 iterations instead of the solver's fixed count.
    """
    srcs, valids = _as_rows(shifts, r.shape[0])
    # schulz exposes materialize_m: build the (pointwise-batched) inverse
    # field ONCE per step and gather it per shift — bitwise-identical to
    # re-running the solve at the gathered points, at a fraction of the
    # matmuls (M(gather(A)) == gather(M(A)), since the Newton-Schulz field
    # is pointwise in the spectral batch). LU has no cheap M; it keeps the
    # per-shift solve. (Packing the per-shift products into one operand
    # materializes the concatenations in device memory, as in the elastic
    # XLA interaction path; the products stay separate here.)
    def body(_, state, rsolve=rsolve,
             m_fn=getattr(rsolve, "materialize_m", None)):
        r, t, jp, jm, ek, ier, iet, iejp, iejm = state
        a = eye - bmm(r, r)
        if m_fn is None:
            m = None
            tt = rsolve(t, a)
        else:
            m = m_fn(a)
            tt = bmm(t, m)
        j1p = jp * ek[:, None]
        j1m = jm * ek[:, None]
        u1 = jp + bmv(r, j1m)
        u2 = j1m + bmv(r, jp)
        # r t is needed by the elastic update AND, gathered at the source
        # wavelengths, by every shift row (gather commutes with the
        # pointwise-in-spectrum product: r0 t0 == take0(r t)) — compute it
        # once instead of once per shift.
        rt = bmm(r, t)

        def one_shift(src, valid, ier_s, iet_s, iejp_s, iejm_s):
            t0 = take0(t, src, valid)
            rr_off = bmm_ie(r, ier_s) + bmm_ie(ier_s, take0(r, src, valid))
            x = bmm_ie(tt, rr_off) + iet_s
            if m is None:
                tt_off = rsolve(x, take0_id(a, src, valid, eye))
            else:
                tt_off = bmm_ie(x, take0_id(m, src, valid, eye))

            ier_n = ier_s + bmm_ie(tt, bmm_ie(r, iet_s) + bmm_ie(ier_s, t0)) \
                + bmm_ie(tt_off, take0(rt, src, valid))
            iet_n = bmm_ie(tt, iet_s) + bmm_ie(tt_off, t0)

            iej1p = iejp_s * ek[:, None]
            iej1m = iejm_s * ek[:, None]
            u1_off = iejp_s + bmv(r, iej1m) + bmv(ier_s,
                                                  take0(j1m, src, valid))
            u2_off = iej1m + bmv(r, iejp_s) + bmv(ier_s,
                                                  take0(jp, src, valid))
            iejp_n = iej1p + bmv(tt, u1_off) + bmv(tt_off,
                                                   take0(u1, src, valid))
            iejm_n = iejm_s + bmv(tt, u2_off) + bmv(tt_off,
                                                    take0(u2, src, valid))
            return ier_n, iet_n, iejp_n, iejm_n

        ier, iet, iejp, iejm = jax.vmap(one_shift)(srcs, valids, ier, iet,
                                                   iejp, iejm)

        jm = jm + bmv(tt, u2)
        jp = j1p + bmv(tt, u1)
        r = r + bmm(tt, rt)
        t = bmm(tt, t)
        return (r, t, jp, jm, ek * ek, ier, iet, iejp, iejm)

    state = (r, t, jp, jm, ek, ier, iet, iejp, iejm)
    if ns_schedule is not None:
        for it in ns_schedule:
            rs = make_rsolve("schulz", int(it))
            state = body(None, state, rsolve=rs,
                         m_fn=rs.materialize_m)
    else:
        state = lax.fori_loop(0, ndoubl, body, state)
    return state


def raman_make_added_layer(tau, omega, z_pp, z_mp, z_pp_r, z_mp_r, tau_sum,
                           f_rayl, shifts, w_shifts, gids, qp, wct2, wct02,
                           i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                           min_qp_mu, eye, rsolve, ndoubl_static=None,
                           ns_schedule=None):
    """One atmospheric layer: elastic + Raman elemental, joint doubling.

    ref: rt_kernel.jl:278-343 (RRS path). Returns (LayerRT, IELayer).
    ``shifts`` banded ints or (src, valid) rows; ``w_shifts`` (nR,) scalars
    or (nR, nSpec) per-output weights. ``ndoubl_static``/``ns_schedule``:
    host-precomputed static doubling count + per-step NS iteration counts
    (the elastic engine's scheduled-NS lever) — statically unrolled.
    """
    dtype = tau.dtype
    n_spec = tau.shape[0]
    srcs, valids = _as_rows(shifts, n_spec)
    if ndoubl_static is not None:
        ndoubl = int(ndoubl_static)
        scale = 2.0 ** ndoubl
    else:
        tau_scat_max = jnp.max(tau * omega)
        # Elemental step 0.004*min(mu): single-scatter error O((dtau/mu)^2)
        # stays < ~3e-5 of radiance (measured f64), 2 fewer doublings/layer
        # than the reference's 0.001 factor.
        dtau_max = jnp.minimum(tau_scat_max, 0.004 * min_qp_mu)
        ndoubl = doubling_number(dtau_max, tau_scat_max)
        scale = 2.0 ** ndoubl.astype(dtype)
    dtau = tau / scale
    expk = jnp.exp(-dtau / mu0)

    r_mp, t_pp, j_p, j_m = elemental(
        dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
        i0_vec, i_mu0_n, n_stokes, mu0_node)

    def one_shift(src, valid, w, g):
        # per-group Raman phase matrix (g indexes the (G, N, N) stacks)
        return ie_elemental((src, valid), w, dtau, f_rayl, tau_sum,
                            z_pp_r[g], z_mp_r[g], qp, wct2, wct02, i0_vec,
                            i_mu0_n, n_stokes, mu0_node)
    ier, iet, iejp, iejm = jax.vmap(one_shift)(srcs, valids, w_shifts, gids)

    # D-flip, joint doubling, unflip (rows live on the output side).
    dv = d_vec[None, :, None]
    dvv = d_vec[None, :]
    r_f = dv * r_mp
    jm_f = dvv * j_m
    ier_f = dv[None] * ier
    iejm_f = dvv[None] * iejm
    r_f, t_pp, j_p, jm_f, _, ier_f, iet, iejp, iejm_f = raman_doubling(
        r_f, t_pp, j_p, jm_f, expk, ier_f, iet, iejp, iejm_f,
        (srcs, valids), ndoubl, eye, rsolve, ns_schedule=ns_schedule)
    r_mp = dv * r_f
    j_m = dvv * jm_f
    ier = dv[None] * ier_f
    iejm = dvv[None] * iejm_f

    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    elastic = LayerRT(r_mp=r_mp, r_pm=sgn * r_mp, t_pp=t_pp,
                      t_mm=sgn * t_pp, j_p=j_p, j_m=j_m)
    ie = IELayer(r_mp=ier, r_pm=sgn[None] * ier, t_pp=iet,
                 t_mm=sgn[None] * iet, j_p=iejp, j_m=iejm)
    return elastic, ie


# --- Raman-coupled interaction (adding) -------------------------------------

def raman_interaction(comp, comp_ie, added, added_ie, shifts, eye, rsolve):
    """Compose composite (top) with added (bottom), elastic + first order.

    Off-diagonal block algebra of rt.interaction
    (ref: interaction_inelastic.jl:230-342).
    """
    srcs, valids = _as_rows(shifts, comp.r_mp.shape[0])
    m_fn = getattr(rsolve, "materialize_m", None)   # see raman_doubling
    a1 = eye - bmm(added.r_mp, comp.r_pm)
    if m_fn is None:
        m1 = None
        t01 = rsolve(comp.t_mm, a1)
    else:
        m1 = m_fn(a1)
        t01 = bmm(comp.t_mm, m1)
    v1 = bmv(added.r_mp, comp.j_p) + added.j_m
    w1 = bmm(added.r_mp, comp.t_pp)

    a2 = eye - bmm(comp.r_pm, added.r_mp)
    if m_fn is None:
        m2 = None
        t21 = rsolve(added.t_pp, a2)
    else:
        m2 = m_fn(a2)
        t21 = bmm(added.t_pp, m2)
    v2 = comp.j_p + bmv(comp.r_pm, added.j_m)
    w2 = bmm(comp.r_pm, added.t_mm)

    def one_shift(src, valid, c_ie, a_ie):
        tk = lambda x: take0(x, src, valid)
        m1_off = bmm_ie(a_ie.r_mp, tk(comp.r_pm)) + bmm_ie(added.r_mp, c_ie.r_pm)
        x1 = bmm_ie(t01, m1_off) + c_ie.t_mm
        t01_off = (rsolve(x1, take0_id(a1, src, valid, eye))
                   if m1 is None
                   else bmm_ie(x1, take0_id(m1, src, valid, eye)))
        v1_off = (bmv(a_ie.r_mp, tk(comp.j_p))
                  + bmv(added.r_mp, c_ie.j_p) + a_ie.j_m)
        iejm = c_ie.j_m + bmv(t01, v1_off) + bmv(t01_off, tk(v1))
        w1_off = bmm_ie(a_ie.r_mp, tk(comp.t_pp)) + bmm_ie(added.r_mp, c_ie.t_pp)
        ier_mp = c_ie.r_mp + bmm_ie(t01, w1_off) + bmm_ie(t01_off, tk(w1))
        iet_mm = bmm_ie(t01, a_ie.t_mm) + bmm_ie(t01_off, tk(added.t_mm))

        m2_off = bmm_ie(c_ie.r_pm, tk(added.r_mp)) + bmm_ie(comp.r_pm, a_ie.r_mp)
        x2 = bmm_ie(t21, m2_off) + a_ie.t_pp
        t21_off = (rsolve(x2, take0_id(a2, src, valid, eye))
                   if m2 is None
                   else bmm_ie(x2, take0_id(m2, src, valid, eye)))
        v2_off = (c_ie.j_p + bmv(c_ie.r_pm, tk(added.j_m))
                  + bmv(comp.r_pm, a_ie.j_m))
        iejp = a_ie.j_p + bmv(t21, v2_off) + bmv(t21_off, tk(v2))
        iet_pp = bmm_ie(t21, c_ie.t_pp) + bmm_ie(t21_off, tk(comp.t_pp))
        w2_off = bmm_ie(c_ie.r_pm, tk(added.t_mm)) + bmm_ie(comp.r_pm, a_ie.t_mm)
        ier_pm = a_ie.r_pm + bmm_ie(t21, w2_off) + bmm_ie(t21_off, tk(w2))
        return IELayer(ier_mp, ier_pm, iet_pp, iet_mm, iejp, iejm)

    ie_new = jax.vmap(one_shift)(srcs, valids, comp_ie, added_ie)

    elastic_new = LayerRT(
        r_mp=comp.r_mp + bmm(t01, w1),
        r_pm=added.r_pm + bmm(t21, w2),
        t_pp=bmm(t21, comp.t_pp),
        t_mm=bmm(t01, added.t_mm),
        j_p=added.j_p + bmv(t21, v2),
        j_m=comp.j_m + bmv(t01, v1))
    return elastic_new, ie_new


# --- full RRS forward driver ------------------------------------------------

@partial(jax.jit, static_argnames=("i_mu0_n", "n_stokes", "is_m0", "n_spec",
                                   "solver", "layer_schedules"))
def _fourier_step_rrs(tau, omega, zw, z_pp_c, z_mp_c, z_pp_r, z_mp_r,
                      f_rayl, srcs, valids, w_shifts, gids, qp, wt, d_vec,
                      i0_vec, albedo, mu0, mu0_node, min_qp_mu,
                      *, i_mu0_n, n_stokes, is_m0, n_spec, solver,
                      layer_schedules=None):
    """One Fourier moment of the Raman-coupled RT: joint elastic+ie layer
    scan, Lambertian surface (no Raman at the surface).
    ref: rt_run.jl RRS path + rt_kernel.jl:278-343.

    ``layer_schedules``: per-layer static (ndoubl, NS-schedule, ni) from
    rt_run.build_layer_schedules — bucketed exactly like the elastic
    engines, replacing the traced-ndoubl while_loop with statically
    unrolled scheduled-NS doubling (thin early steps solve with 0-1 NS
    iterations instead of the solver's fixed 4; measured the dominant
    non-shift cost of the RRS path).
    """
    with jax.default_matmul_precision("highest"):
        rsolve = make_rsolve(solver)
        dtype = tau.dtype
        n = qp.shape[0]
        n_r = srcs.shape[0]
        eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (n_spec, n, n))
        wct02 = jnp.asarray(0.5 if is_m0 else 0.25, dtype)
        wct2 = wt / 2.0 if is_m0 else wt / 4.0

        tau_sum_all = jnp.concatenate(
            [jnp.zeros((1, tau.shape[1]), dtype),
             jnp.cumsum(tau, axis=0)], axis=0)

        # per-layer Raman weights (nZ, nR, nSpec) ride the scan; a global
        # (nR, nSpec) w_shifts is closed over instead (no broadcast copy)
        w_layered = w_shifts.ndim == 3

        def scan_body(carry, inputs, _nd=None, _sched=None):
            comp, comp_ie = carry
            if w_layered:
                tau_z, omega_z, zw_z, f_rayl_z, tau_sum_z, w_z = inputs
            else:
                tau_z, omega_z, zw_z, f_rayl_z, tau_sum_z = inputs
                w_z = w_shifts
            z_pp = jnp.einsum("kn,kij->nij", zw_z, z_pp_c)
            z_mp = jnp.einsum("kn,kij->nij", zw_z, z_mp_c)
            added, added_ie = raman_make_added_layer(
                tau_z, omega_z, z_pp, z_mp, z_pp_r, z_mp_r, tau_sum_z,
                f_rayl_z, (srcs, valids), w_z, gids, qp, wct2, wct02,
                i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec, min_qp_mu,
                eye, rsolve, ndoubl_static=_nd, ns_schedule=_sched)
            comp, comp_ie = raman_interaction(comp, comp_ie, added,
                                              added_ie, (srcs, valids),
                                              eye, rsolve)
            return (comp, comp_ie), None

        init = (vacuum_layer(n_spec, n, dtype),
                zero_ie(n_r, n_spec, n, dtype))
        xs = (tau, omega, zw, f_rayl, tau_sum_all[:-1])
        if w_layered:
            xs = xs + (w_shifts,)
        if layer_schedules is not None and solver == "schulz":
            buckets = []          # (nd, sched, start, count)
            for iz, (nd_z, sched_z, _ni) in enumerate(layer_schedules):
                sc = tuple(sched_z) if sched_z is not None else None
                if buckets and buckets[-1][0] == nd_z \
                        and buckets[-1][1] == sc:
                    buckets[-1] = buckets[-1][:3] + (buckets[-1][3] + 1,)
                else:
                    buckets.append((nd_z, sc, iz, 1))
            carry = init
            for nd_z, sched_z, start, count in buckets:
                sl = slice(start, start + count)
                carry, _ = jax.lax.scan(
                    partial(scan_body, _nd=nd_z, _sched=sched_z), carry,
                    tuple(x[sl] for x in xs))
            comp, comp_ie = carry
        else:
            (comp, comp_ie), _ = jax.lax.scan(scan_body, init, xs)

        from vsmartmom.core.surface import lambertian_surface_layer
        surf = lambertian_surface_layer(
            albedo, n_spec, n_stokes, qp, wt, i0_vec, tau_sum_all[-1], mu0,
            is_m0, dtype)
        surf_ie = zero_ie(n_r, n_spec, n, dtype)
        comp, comp_ie = raman_interaction(comp, comp_ie, surf, surf_ie,
                                          (srcs, valids), eye, rsolve)
        # sum coupling over all Raman shifts for the SFI outputs
        return comp, comp_ie.j_p.sum(axis=0), comp_ie.j_m.sum(axis=0)


def build_coupling(specs, n_spec: int):
    """Normalize inelastic coupling specs into dense per-output rows.

    Each spec is an ``inelastic.rrs.RRS`` (banded: i_shift/w_shift, with an
    optional band_range restricting outputs+sources to a sub-grid of the
    concatenated axis) or an ``inelastic.plus.AbsoluteRaman`` (absolute
    i_out/i_src/w rows).  Returns numpy (srcs, valids, ws, gids) with
    shapes (nR, nSpec) x3 + (nR,).
    """
    srcs, valids, ws, gids = [], [], [], []
    idx = np.arange(n_spec)
    for g, s in enumerate(specs):
        if hasattr(s, "i_out"):                 # absolute coupling rows
            src = np.full(n_spec, int(s.i_src), np.int32)
            w = np.zeros(n_spec)
            np.add.at(w, np.asarray(s.i_out, np.int64), np.asarray(s.w))
            srcs.append(src)
            valids.append(np.ones(n_spec, bool))
            ws.append(w)
            gids.append(g)
            continue
        lo, hi = (0, n_spec)
        if getattr(s, "band_range", None) is not None:
            lo, hi = s.band_range
        in_band = (idx >= lo) & (idx < hi)
        for shift, w_s in zip(s.i_shift, np.asarray(s.w_shift).T):
            # w_s: scalar (global) or (nZ,) per-layer weights for this shift
            src = idx + int(shift)
            valid = in_band & (src >= lo) & (src < hi)
            srcs.append(np.clip(src, 0, n_spec - 1).astype(np.int32))
            valids.append(valid)
            if np.ndim(w_s) == 0:
                ws.append(np.where(valid, w_s, 0.0))
            else:
                ws.append(np.where(valid[None, :], w_s[:, None], 0.0))
            gids.append(g)
    ws = np.stack(ws)
    if ws.ndim == 3:                       # (nR, nZ, nSpec) -> (nZ, nR, nSpec)
        ws = ws.transpose(1, 0, 2)
    return (np.stack(srcs), np.stack(valids), ws,
            np.asarray(gids, np.int32))


def _raman_layer_schedules(tau, omega, min_qp_mu):
    """Exact (unquantized) per-layer static doubling schedules for the
    Raman scan: nd matches the traced doubling_number per layer, with the
    per-step NS iteration schedule of ns_doubling_schedule. Returns a
    tuple of (nd, sched, ni=4) 3-tuples or None on any non-static input
    (the traced path then applies)."""
    from vsmartmom.core.rt import ns_doubling_schedule
    if not (isinstance(tau, np.ndarray) and isinstance(omega, np.ndarray)):
        return None
    tau_scat = np.max(tau * omega, axis=1)
    if not np.all(np.isfinite(tau_scat)) or not np.any(tau_scat > 0):
        return None
    dm = np.minimum(np.maximum(tau_scat, 1e-30), 0.004 * min_qp_mu)
    nd = np.maximum(np.ceil(np.log2(np.maximum(tau_scat / dm, 1.0))),
                    0).astype(int)
    return tuple(
        (int(k), ns_doubling_schedule(float(ts), min_qp_mu, int(k)), 4)
        for k, ts in zip(nd, tau_scat))


def rt_run_band_rrs(pol, quad, band, rrs, f_rayl, vza, vaz, max_m: int,
                    surface, dtype=jnp.float64, solver=None):
    """Forward run with Raman coupling (RRS / VS / RVRS / ``_plus`` groups)
    for one band or a concatenated multi-band spectral axis.

    rrs: a single inelastic coupling spec (inelastic.rrs.RRS, the specs
    from make_vs, or inelastic.plus.AbsoluteRaman) or a list of them — each
    contributes its own source-index rows and Raman phase matrix.
    f_rayl: (nZ, nSpec) Rayleigh-scattering fraction tau_rayl/tau_total per
    layer. Returns (R, T, ieR, ieT), each (n_vza, n_stokes, nSpec): elastic
    (Cabannes) radiances and the first-order Raman corrections
    (ref: rt_run.jl:219-226 return R_SFI.., ieR_SFI..).
    """
    from vsmartmom.scattering.phase import compute_Z_moments
    from vsmartmom.util.quadrature import nearest_point

    if solver is None:
        solver = default_solver(jax.default_backend())
    specs = rrs if isinstance(rrs, (list, tuple)) else [rrs]
    n_spec = band.tau.shape[1]
    n = len(quad.qp_mu_n)
    n_stokes = pol.n
    vza = np.asarray(vza, dtype=np.float64)
    vaz = np.asarray(vaz, dtype=np.float64)

    # Optional static per-layer doubling schedules (VSM_RAMAN_SCHED=1,
    # schulz only). UNLIKE the elastic engines' builder these are NOT
    # quantized up: every extra doubling step multiplies the per-shift
    # work by nR (~170 rows), so exact-nd buckets keep the traced path's
    # step counts and add the scheduled-NS savings. The default is the
    # traced-ndoubl fori_loop, whose while-loop buffer aliasing suits the
    # large ie carry; which is faster on the GPU is not measured yet.
    layer_schedules = None
    if solver == "schulz" and os.environ.get("VSM_RAMAN_SCHED") == "1":
        layer_schedules = _raman_layer_schedules(
            np.asarray(band.tau), np.asarray(band.omega),
            float(np.min(quad.qp_mu)))

    i0_vec = np.zeros(n)
    i0_vec[quad.i_mu0_n:quad.i_mu0_n + n_stokes] = pol.i0
    d_vec = np.tile(pol.d, quad.n_quad)
    mu0_node = float(quad.qp_mu_n[quad.i_mu0_n])
    min_qp_mu = float(np.min(quad.qp_mu))

    assert surface["type"] == "LambertianSurfaceScalar", \
        "Raman runs support Lambertian surfaces (as the reference)"
    albedo = float(surface["albedo"])

    R = np.zeros((len(vza), n_stokes, n_spec))
    T = np.zeros_like(R)
    ieR = np.zeros_like(R)
    ieT = np.zeros_like(R)

    to_dev = lambda x: jnp.asarray(x, dtype)
    srcs_np, valids_np, ws_np, gids_np = build_coupling(specs, n_spec)
    srcs = jnp.asarray(srcs_np)
    valids = jnp.asarray(valids_np)
    w_shifts = to_dev(ws_np)
    gids = jnp.asarray(gids_np)

    for m in range(max_m):
        z_pp_list, z_mp_list = [], []
        for gc in band.greeks:
            zpp, zmp = compute_Z_moments(pol, quad.qp_mu, gc, m)
            z_pp_list.append(zpp)
            z_mp_list.append(zmp)
        z_pp_r, z_mp_r = [], []
        for s in specs:
            a, b = compute_Z_moments(pol, quad.qp_mu, s.greek_raman, m)
            z_pp_r.append(a)
            z_mp_r.append(b)

        comp, iejp_sum, iejm_sum = _fourier_step_rrs(
            to_dev(band.tau), to_dev(band.omega), to_dev(band.zw),
            to_dev(np.stack(z_pp_list)), to_dev(np.stack(z_mp_list)),
            to_dev(np.stack(z_pp_r)), to_dev(np.stack(z_mp_r)),
            to_dev(f_rayl), srcs, valids, w_shifts, gids,
            to_dev(quad.qp_mu_n), to_dev(quad.wt_mu_n), to_dev(d_vec),
            to_dev(i0_vec), jnp.asarray(albedo, dtype),
            jnp.asarray(quad.mu0, dtype), jnp.asarray(mu0_node, dtype),
            jnp.asarray(min_qp_mu, dtype),
            i_mu0_n=quad.i_mu0_n, n_stokes=n_stokes, is_m0=(m == 0),
            n_spec=n_spec, solver=solver, layer_schedules=layer_schedules)

        j_m = np.asarray(comp.j_m)
        j_p = np.asarray(comp.j_p)
        ie_m = np.asarray(iejm_sum)
        ie_p = np.asarray(iejp_sum)
        weight = 0.5 if m == 0 else 1.0
        for i in range(len(vza)):
            i_mu = nearest_point(quad.qp_mu, np.cos(np.deg2rad(vza[i])))
            sl = slice(n_stokes * i_mu, n_stokes * (i_mu + 1))
            cm = np.cos(np.deg2rad(m * vaz[i]))
            sm = np.sin(np.deg2rad(m * vaz[i]))
            big_cs = weight * np.array([cm, cm, sm, sm][:n_stokes])
            R[i] += big_cs[:, None] * j_m[:, sl].T
            T[i] += big_cs[:, None] * j_p[:, sl].T
            ieR[i] += big_cs[:, None] * ie_m[:, sl].T
            ieT[i] += big_cs[:, None] * ie_p[:, sl].T

    return R, T, ieR, ieT


# --- inelastic multi-sensor (interior-level radiances with Raman) -----------

def ie_interlayer_flux(top, top_ie, bot, bot_ie, shifts, eye, rsolve):
    """Up/downwelling radiance at the interface between a top and bottom
    composite, elastic + first-order Raman.

    Elastic coupling (ref: CoreKernel/interlayer_flux.jl:7-25):
        dwJ = (I - R_top^{+-} R_bot^{-+})^{-1} (J_top^+ + R_top^{+-} J_bot^-)
        uwJ = (I - R_bot^{-+} R_top^{+-})^{-1} (J_bot^- + R_bot^{-+} J_top^+)
    The ie terms are the off-diagonal blocks of the same algebra applied to
    the 2x2 block operators (module docstring), replacing the reference's
    hand-expanded RS paths in interaction_multisensor.jl.
    Returns (uw, dw, ie_uw, ie_dw); ie_* carry the Raman-shift axis.
    """
    srcs, valids = _as_rows(shifts, top.r_mp.shape[0])

    def lsolve(a, v):
        return rsolve(v[:, None, :], a.transpose(0, 2, 1))[:, 0, :]

    a_dw = eye - bmm(top.r_pm, bot.r_mp)
    dw = lsolve(a_dw, top.j_p + bmv(top.r_pm, bot.j_m))
    a_uw = eye - bmm(bot.r_mp, top.r_pm)
    uw = lsolve(a_uw, bot.j_m + bmv(bot.r_mp, top.j_p))

    def one_shift(src, valid, t_ie, b_ie):
        tk = lambda x: take0(x, src, valid)
        m_ie_dw = bmm(t_ie.r_pm, tk(bot.r_mp)) + bmm(top.r_pm, b_ie.r_mp)
        ie_u_dw = (t_ie.j_p + bmv(t_ie.r_pm, tk(bot.j_m))
                   + bmv(top.r_pm, b_ie.j_m))
        ie_dw = lsolve(a_dw, ie_u_dw + bmv(m_ie_dw, tk(dw)))
        m_ie_uw = bmm(b_ie.r_mp, tk(top.r_pm)) + bmm(bot.r_mp, t_ie.r_pm)
        ie_u_uw = (b_ie.j_m + bmv(b_ie.r_mp, tk(top.j_p))
                   + bmv(bot.r_mp, t_ie.j_p))
        ie_uw = lsolve(a_uw, ie_u_uw + bmv(m_ie_uw, tk(uw)))
        return ie_uw, ie_dw

    ie_uw, ie_dw = jax.vmap(one_shift)(srcs, valids, top_ie, bot_ie)
    return uw, dw, ie_uw, ie_dw


@partial(jax.jit, static_argnames=("i_mu0_n", "n_stokes", "is_m0", "n_spec",
                                   "solver", "sensor_levels"))
def _fourier_step_rrs_ms(tau, omega, zw, z_pp_c, z_mp_c, z_pp_r, z_mp_r,
                         f_rayl, srcs, valids, w_shifts, gids, qp, wt,
                         d_vec, i0_vec, albedo, mu0, mu0_node, min_qp_mu,
                         *, i_mu0_n, n_stokes, is_m0, n_spec, solver,
                         sensor_levels):
    """One Fourier moment of the Raman-coupled multi-sensor RT: segmented
    forward/reverse scans carrying (elastic, ie) composites, then the
    ie-aware interlayer-flux coupling per sensor.
    ref: rt_run_multisensor.jl + interaction_multisensor.jl RS paths."""
    with jax.default_matmul_precision("highest"):
        rsolve = make_rsolve(solver)
        dtype = tau.dtype
        n = qp.shape[0]
        n_z = tau.shape[0]
        n_r = srcs.shape[0]
        eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (n_spec, n, n))
        wct02 = jnp.asarray(0.5 if is_m0 else 0.25, dtype)
        wct2 = wt / 2.0 if is_m0 else wt / 4.0

        tau_sum_all = jnp.concatenate(
            [jnp.zeros((1, tau.shape[1]), dtype),
             jnp.cumsum(tau, axis=0)], axis=0)

        w_layered = w_shifts.ndim == 3

        def layer(inputs):
            if w_layered:
                tau_z, omega_z, zw_z, f_rayl_z, tau_sum_z, w_z = inputs
            else:
                tau_z, omega_z, zw_z, f_rayl_z, tau_sum_z = inputs
                w_z = w_shifts
            z_pp = jnp.einsum("kn,kij->nij", zw_z, z_pp_c)
            z_mp = jnp.einsum("kn,kij->nij", zw_z, z_mp_c)
            return raman_make_added_layer(
                tau_z, omega_z, z_pp, z_mp, z_pp_r, z_mp_r, tau_sum_z,
                f_rayl_z, (srcs, valids), w_z, gids, qp, wct2, wct02,
                i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec, min_qp_mu,
                eye, rsolve)

        def seg_inputs(lo, hi):
            out = (tau[lo:hi], omega[lo:hi], zw[lo:hi], f_rayl[lo:hi],
                   tau_sum_all[lo:hi])
            if w_layered:
                out = out + (w_shifts[lo:hi],)
            return out

        tops = {}
        carry = (vacuum_layer(n_spec, n, dtype),
                 zero_ie(n_r, n_spec, n, dtype))
        prev = 0
        for s in sorted(sensor_levels):
            if s > prev:
                def fwd(c, inp):
                    lay, lay_ie = layer(inp)
                    return raman_interaction(c[0], c[1], lay, lay_ie,
                                             (srcs, valids), eye,
                                             rsolve), None
                carry, _ = jax.lax.scan(fwd, carry, seg_inputs(prev, s))
                prev = s
            tops[s] = carry

        from vsmartmom.core.surface import lambertian_surface_layer
        surf = lambertian_surface_layer(
            albedo, n_spec, n_stokes, qp, wt, i0_vec, tau_sum_all[-1], mu0,
            is_m0, dtype)
        bots = {}
        acc = (surf, zero_ie(n_r, n_spec, n, dtype))
        prev = n_z
        for s in sorted(sensor_levels, reverse=True):
            if s < prev:
                def bwd(c, inp):
                    lay, lay_ie = layer(inp)
                    return raman_interaction(lay, lay_ie, c[0], c[1],
                                             (srcs, valids), eye,
                                             rsolve), None
                acc, _ = jax.lax.scan(bwd, acc, seg_inputs(s, prev),
                                      reverse=True)
                prev = s
            bots[s] = acc

        uw, dw, ie_uw, ie_dw = [], [], [], []
        for s in sensor_levels:
            u, d, iu, idw = ie_interlayer_flux(
                tops[s][0], tops[s][1], bots[s][0], bots[s][1],
                (srcs, valids), eye, rsolve)
            uw.append(u)
            dw.append(d)
            ie_uw.append(iu.sum(axis=0))
            ie_dw.append(idw.sum(axis=0))
        return (jnp.stack(uw), jnp.stack(dw),
                jnp.stack(ie_uw), jnp.stack(ie_dw))


def rt_run_band_rrs_ms(pol, quad, band, rrs, f_rayl, vza, vaz, max_m: int,
                       surface, sensor_levels, dtype=jnp.float64,
                       solver=None):
    """Multi-sensor forward run with Raman coupling.

    sensor_levels: layer-interface indices, 0 = TOA .. nZ = BOA.
    Returns (uwJ, dwJ, ie_uwJ, ie_dwJ), each
    (nSensor, n_vza, n_stokes, nSpec).
    ref: rt_run_multisensor.jl rt_run_test_ms with RS types +
    postprocessing_vza_ms.jl ieJ accumulation.
    """
    from vsmartmom.scattering.phase import compute_Z_moments
    from vsmartmom.util.quadrature import nearest_point

    if solver is None:
        solver = default_solver(jax.default_backend())
    specs = rrs if isinstance(rrs, (list, tuple)) else [rrs]
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

    assert surface["type"] == "LambertianSurfaceScalar", \
        "Raman runs support Lambertian surfaces (as the reference)"
    albedo = float(surface["albedo"])

    shape = (len(sensor_levels), len(vza), n_stokes, n_spec)
    uw_out = np.zeros(shape)
    dw_out = np.zeros(shape)
    ie_uw_out = np.zeros(shape)
    ie_dw_out = np.zeros(shape)

    to_dev = lambda x: jnp.asarray(x, dtype)
    srcs_np, valids_np, ws_np, gids_np = build_coupling(specs, n_spec)
    srcs = jnp.asarray(srcs_np)
    valids = jnp.asarray(valids_np)
    w_shifts = to_dev(ws_np)
    gids = jnp.asarray(gids_np)

    for m in range(max_m):
        z_pp_list, z_mp_list = [], []
        for gc in band.greeks:
            zpp, zmp = compute_Z_moments(pol, quad.qp_mu, gc, m)
            z_pp_list.append(zpp)
            z_mp_list.append(zmp)
        z_pp_r, z_mp_r = [], []
        for s in specs:
            a, b = compute_Z_moments(pol, quad.qp_mu, s.greek_raman, m)
            z_pp_r.append(a)
            z_mp_r.append(b)

        uw_j, dw_j, ie_uw_j, ie_dw_j = _fourier_step_rrs_ms(
            to_dev(band.tau), to_dev(band.omega), to_dev(band.zw),
            to_dev(np.stack(z_pp_list)), to_dev(np.stack(z_mp_list)),
            to_dev(np.stack(z_pp_r)), to_dev(np.stack(z_mp_r)),
            to_dev(f_rayl), srcs, valids, w_shifts, gids,
            to_dev(quad.qp_mu_n), to_dev(quad.wt_mu_n), to_dev(d_vec),
            to_dev(i0_vec), jnp.asarray(albedo, dtype),
            jnp.asarray(quad.mu0, dtype), jnp.asarray(mu0_node, dtype),
            jnp.asarray(min_qp_mu, dtype),
            i_mu0_n=quad.i_mu0_n, n_stokes=n_stokes, is_m0=(m == 0),
            n_spec=n_spec, solver=solver, sensor_levels=sensor_levels)

        arrs = [np.asarray(a) for a in (uw_j, dw_j, ie_uw_j, ie_dw_j)]
        weight = 0.5 if m == 0 else 1.0
        for i in range(len(vza)):
            i_mu = nearest_point(quad.qp_mu, np.cos(np.deg2rad(vza[i])))
            sl = slice(n_stokes * i_mu, n_stokes * (i_mu + 1))
            cm = np.cos(np.deg2rad(m * vaz[i]))
            sm = np.sin(np.deg2rad(m * vaz[i]))
            big_cs = weight * np.array([cm, cm, sm, sm][:n_stokes])
            for out, arr in zip((uw_out, dw_out, ie_uw_out, ie_dw_out),
                                arrs):
                out[:, i] += (big_cs[None, :, None]
                              * arr[:, :, sl].transpose(0, 2, 1))

    return uw_out, dw_out, ie_uw_out, ie_dw_out
