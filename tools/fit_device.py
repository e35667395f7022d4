"""Device-resident Levenberg-Marquardt for the line-list window polish.

Drop-in accelerator for tools/polish_windows.py's inner LM
(VSM_FIT_DEVICE=1): the whole damped-LM iteration loop — Voigt model,
analytic Jacobian, scaled normal equations, accept/reject — runs as one
jitted lax.scan on the device; only (theta in, theta out) crosses the host
boundary. The host (polish_windows) keeps its f64 wofz evaluation for the
block accept/reject, so device f32 can only ever *propose* — never
degrade — a block.

f32 safety reparameterizations:
  * strengths: data and exp(lnS) are scaled by SCALE=1e22 (model is
    linear in the strength, so this is exact) — unscaled residuals
    ~1e-25 would underflow f32 squares.
  * positions: carried as offsets from the window-center reference
    nu_ref (f32 resolution at |dnu| <= ~6 is ~4e-7 cm^-1; absolute
    6000+ positions would quantize at ~5e-4).

The Voigt function is the framework's own jax CEF
(spectroscopy/cef.py w_humlicek_weideman32_sd — the reference default);
the CPU polish uses exact scipy wofz, and the ~1e-6-relative CEF
difference is absorbed by the fit target's margin below the HAPI gate
(2.4e-27 vs 3.6e-27) plus the host-side f64 acceptance.
"""
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
from jax import lax

from vsmartmom.spectroscopy.cef import w_humlicek_weideman32_sd
from vsmartmom.spectroscopy.voigt import (C2, C_LIGHT, K_BOLTZ, MASS_MOL,
                                          P_REF, SQRT_2LN2, SQRT_LN2,
                                          SQRT_LN2_DIV_SQRT_PI, T_REF)

SCALE = 1.0e22           # strength/data scaling (exact reparameterization)
_LN_SCALE = float(np.log(SCALE))
_ISQRTPI2 = 2.0 / np.sqrt(np.pi)


def _pad_to(x, n, axis=0, value=0.0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


@functools.partial(jax.jit, static_argnames=("iters",))
def _lm_scan(th0, data, g_off, gmask, lmask, cond_t, cond_p, qratio,
             nu_ref, weight, clip_lo, clip_hi, *, iters):
    """th0: (NL, 6) [dnu, lnS_scaled, elow, ln_gair, nair, dair] f32.
    data: (25, NG) scaled; g_off: (NG,) grid - nu_ref; masks pad rows/pts.
    Returns (theta_best, cost_best)."""
    n_l = th0.shape[0]
    n_c = cond_t.shape[0]

    inv_t = 1.0 / cond_t                                   # (C,)
    beta = C2 * (1.0 / T_REF - inv_t)                      # (C,)
    p_fac = cond_p / P_REF                                 # (C,)
    tfac = (T_REF * inv_t)                                 # (C,)
    gd_const = (SQRT_2LN2 / C_LIGHT) * np.sqrt(K_BOLTZ / MASS_MOL) \
        / jnp.sqrt(weight)

    def model_jac(th):
        dnu, ln_s, elow = th[:, 0], th[:, 1], th[:, 2]
        gair, nair, dair = jnp.exp(th[:, 3]), th[:, 4], th[:, 5]
        nu0 = nu_ref + dnu                                 # (L,) f32 abs
        # per (cond, line) factors
        s_corr = (qratio[:, None]
                  * jnp.exp(elow[None, :] * beta[:, None])
                  * jnp.expm1(-C2 * nu0[None, :] * inv_t[:, None])
                  / jnp.expm1(-C2 * nu0[None, :] / T_REF))
        s = jnp.exp(ln_s)[None, :] * s_corr                # (C, L) scaled
        dnu_c = dnu[None, :] + p_fac[:, None] * dair[None, :]
        g_l = (gair[None, :] * p_fac[:, None]
               * tfac[:, None] ** nair[None, :])           # (C, L)
        g_d = gd_const * jnp.sqrt(cond_t)[:, None] * nu0[None, :]
        u = SQRT_LN2 / g_d
        k = SQRT_LN2_DIV_SQRT_PI / g_d
        z = u[:, :, None] * ((g_off[None, None, :] - dnu_c[:, :, None])
                             + 1j * g_l[:, :, None])       # (C, L, G)
        w = w_humlicek_weideman32_sd(z)
        prof = k[:, :, None] * w.real
        sig = s[:, :, None] * prof                         # (C, L, G)
        m = sig.sum(axis=1)                                # (C, G)
        dw = _ISQRTPI2 * 1j - 2.0 * z * w
        d_nu = s[:, :, None] * k[:, :, None] * (-u[:, :, None]) * dw.real
        d_gl = s[:, :, None] * k[:, :, None] * (-u[:, :, None]) * dw.imag
        jac = jnp.stack([
            d_nu,
            sig,
            sig * beta[:, None, None],
            d_gl * g_l[:, :, None],
            d_gl * (g_l * jnp.log(tfac)[:, None])[:, :, None],
            d_nu * p_fac[:, None, None],
        ], axis=-1)                                        # (C, L, G, 6)
        jac = jac * lmask[None, :, None, None]
        return m, jac

    wmask = gmask[None, :]                                 # (1, G)

    def cost_of(m):
        r = (data - m) * wmask
        return jnp.sum(r * r), r

    def step(state, _):
        th, best_th, best_cost, lm, prev = state
        m, jac = model_jac(th)
        cost, r = cost_of(m)
        improved = cost < best_cost * (1.0 - 1e-9)
        best_th = jnp.where(improved, th, best_th)
        best_cost = jnp.where(improved, cost, best_cost)
        # damping: decrease while descending, jump up when cost rose
        descending = cost <= prev
        lm = jnp.where(descending, jnp.maximum(lm * 0.5, 1e-10), lm * 8.0)
        # rejected step: fall back to the best accepted point (branchless,
        # so the Jacobian is re-evaluated at the chosen base either way)
        th_base = jnp.where(descending, th, best_th)
        m_b, jac_b = model_jac(th_base)
        _, r_b = cost_of(m_b)
        j2 = (jac_b * wmask[:, None, :, None]).transpose(0, 2, 1, 3)
        j2 = j2.reshape(n_c * g_off.shape[0], n_l * 6)     # (CG, P)
        rv = r_b.reshape(-1)
        scale = jnp.sqrt(jnp.sum(j2 * j2, axis=0)) + 1e-30
        jn = j2 / scale[None, :]
        a = jn.T @ jn + lm * jnp.eye(n_l * 6, dtype=th.dtype)
        b = jn.T @ rv
        step_v = jnp.linalg.solve(a, b) / scale
        th_new = th_base + step_v.reshape(n_l, 6)
        th_new = jnp.stack([
            jnp.clip(th_new[:, 0], clip_lo, clip_hi),
            jnp.clip(th_new[:, 1], np.log(1e-31) + _LN_SCALE,
                     np.log(1e-18) + _LN_SCALE),
            jnp.clip(th_new[:, 2], 0.0, 4500.0),
            jnp.clip(th_new[:, 3], np.log(0.005), np.log(0.3)),
            jnp.clip(th_new[:, 4], -0.5, 1.2),
            jnp.clip(th_new[:, 5], -0.05, 0.05)], axis=-1)
        th_new = jnp.where(lmask[:, None] > 0, th_new, th)
        return (th_new, best_th, best_cost, lm,
                jnp.where(descending, cost, best_cost)), None

    m0, _ = model_jac(th0)
    c0, _ = cost_of(m0)
    state = (th0, th0, c0, jnp.asarray(1e-6, th0.dtype), c0)
    state, _ = lax.scan(step, state, None, length=iters)
    return state[1], state[2]


def device_lm(theta, d_blk, g, conds, qratios, weight, clip_nu,
              iters=200):
    """Polish one block of lines against its window data on the device.

    theta: (nl, 6) f64 [nu0, lnS, elow, ln_gair, nair, dair];
    d_blk: (25, ng) f64 target for THIS block; g: (ng,) grid;
    conds: [(T, p)] * 25; qratios: (25,); clip_nu: (lo, hi) absolute.
    Returns improved theta (f64) — caller must accept/reject in f64.
    """
    nl, ng = theta.shape[0], len(g)
    n_lp = int(np.ceil(max(nl, 1) / 8.0) * 8)
    n_gp = int(np.ceil(ng / 256.0) * 256)
    nu_ref = float(np.mean(g))

    th = theta.copy()
    th[:, 0] -= nu_ref
    th[:, 1] += _LN_SCALE
    th_p = _pad_to(th.astype(np.float32), n_lp)
    # inert pad lines: tiny strength far from the window
    if n_lp > nl:
        th_p[nl:, 0] = 0.0
        th_p[nl:, 1] = np.log(1e-31) + _LN_SCALE
        th_p[nl:, 3] = np.log(0.07)
    lmask = _pad_to(np.ones(nl, np.float32), n_lp)
    data = _pad_to((d_blk * SCALE).astype(np.float32), n_gp, axis=1)
    g_off = _pad_to((g - nu_ref).astype(np.float32), n_gp,
                    value=(g[-1] - nu_ref + 50.0))
    gmask = _pad_to(np.ones(ng, np.float32), n_gp)
    cond_t = np.asarray([t for t, _ in conds], np.float32)
    cond_p = np.asarray([p for _, p in conds], np.float32)

    th_best, _ = _lm_scan(
        jnp.asarray(th_p), jnp.asarray(data), jnp.asarray(g_off),
        jnp.asarray(gmask), jnp.asarray(lmask), jnp.asarray(cond_t),
        jnp.asarray(cond_p), jnp.asarray(np.asarray(qratios, np.float32)),
        jnp.asarray(np.float32(nu_ref)), jnp.asarray(np.float32(weight)),
        jnp.asarray(np.float32(clip_nu[0] - nu_ref)),
        jnp.asarray(np.float32(clip_nu[1] - nu_ref)), iters=int(iters))
    out = np.asarray(th_best, np.float64)[:nl]
    out[:, 0] += nu_ref
    out[:, 1] -= _LN_SCALE
    return out
