"""Differentiable Mie -> NAI2 -> Greek-coefficient chain (aerosol
microphysics autodiff).

JAX re-implementation of the numpy setup path in mie.py / nai2.py so that
``jax.jacfwd`` yields d(AerosolOptics)/d(mu, sigma, n_r, n_i) — the seam
the reference exposes through ForwardDiff
(ref: src/Scattering/phase_function_autodiff.jl:41-94) and uses for
aerosol-state retrievals (test/prototyping/AD_OCO2_test.jl).

Design notes (XLA-first):
  * Everything radius-dependent but parameter-independent (radius
    quadrature, size parameters x, Riccati-Bessel psi/chi recursions,
    pi/tau angular functions, Legendre projection tables) is precomputed
    once in f64 numpy and closed over as constants — only the
    parameter-dependent math is traced.
  * The D_n logarithmic-derivative downward recurrence runs as a
    lax.scan over n (sequential by nature), vmapped over the radius batch.
  * The numpy path (nai2.compute_aerosol_optical_properties) remains the
    f64 cross-check; tests pin both to each other.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from vsmartmom.scattering.legendre import (compute_legendre_poly,
                                           compute_mie_pi_tau)
from vsmartmom.scattering.mie import get_n_max
from vsmartmom.scattering.nai2 import AerosolOptics
from vsmartmom.scattering.phase import GreekCoefs
from vsmartmom.util.quadrature import gauleg, gauss_legendre


@dataclasses.dataclass(frozen=True)
class MieSetup:
    """Static (parameter-independent) tables for one (lambda, r grid)."""
    lam: float
    r: np.ndarray          # (nr,) radius quadrature nodes
    w_r: np.ndarray        # (nr,) normalized quadrature weights
    x: np.ndarray          # (nr,) size parameters
    n_max: int
    nmx: int               # start order of the downward D recurrence
    psi: np.ndarray        # (nr, n_max) Riccati-Bessel psi_n(x)
    psi_m1: np.ndarray     # psi_{n-1}
    xi: np.ndarray         # (nr, n_max) complex psi - i chi
    xi_m1: np.ndarray
    trunc: np.ndarray      # (nr, n_max) per-radius order mask
    mu: np.ndarray         # (n_mu,) angular quadrature
    w_mu: np.ndarray
    leg_pi: np.ndarray     # (n_mu, n_max)
    leg_tau: np.ndarray
    proj: dict             # Legendre projection tables


def make_setup(lam: float, r_max: float, nquad_radius: int) -> MieSetup:
    r, w_r = gauleg(nquad_radius, 0.0, r_max)
    w_r = w_r / w_r.sum()
    k = 2.0 * np.pi / lam
    x = k * r
    n_max = get_n_max(x.max())
    n_max_i = np.array([get_n_max(xi) for xi in x])

    # Riccati-Bessel psi/chi upward recurrences (x only, f64 numpy);
    # frozen per-radius beyond n_max(x_i) exactly as mie.py
    nr = len(x)
    psi = np.zeros((nr, n_max))
    psi_m1 = np.zeros((nr, n_max))
    chi = np.zeros((nr, n_max))
    chi_m1 = np.zeros((nr, n_max))
    p0, p1 = np.cos(x), np.sin(x)
    c0, c1 = -np.sin(x), np.cos(x)
    for n in range(1, n_max + 1):
        active = n <= n_max_i
        pn = np.where(active, (2 * n - 1) * p1 / x - p0, p1)
        cn = np.where(active, (2 * n - 1) * c1 / x - c0, c1)
        psi[:, n - 1] = pn
        psi_m1[:, n - 1] = p1
        chi[:, n - 1] = cn
        chi_m1[:, n - 1] = c1
        p0, p1 = np.where(active, p1, p0), pn
        c0, c1 = np.where(active, c1, c0), cn

    n_mu = 2 * n_max - 1
    mu, w_mu = gauss_legendre(n_mu)
    leg_pi, leg_tau = compute_mie_pi_tau(mu, n_max)
    P, P2, R2, T2 = compute_legendre_poly(mu, n_mu)
    ls = np.arange(n_mu)
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = (2 * ls + 1) / 2.0 * np.sqrt(
            1.0 / ((ls - 1.0) * ls * (ls + 1.0) * (ls + 2.0)))
    fac[:2] = 0.0
    proj = dict(P=P, P2=P2, R2=R2, T2=T2, fac=fac,
                coef=(2 * ls + 1) / 2.0)
    trunc = (np.arange(1, n_max + 1)[None, :] <= n_max_i[:, None])
    nmx = int(np.ceil(max(n_max, x.max() * 1.7) + 51))
    return MieSetup(lam=lam, r=r, w_r=w_r, x=x, n_max=n_max, nmx=nmx,
                    psi=psi, psi_m1=psi_m1,
                    xi=psi - 1j * chi, xi_m1=psi_m1 - 1j * chi_m1,
                    trunc=trunc, mu=mu, w_mu=w_mu,
                    leg_pi=leg_pi, leg_tau=leg_tau, proj=proj)


def _mie_ab_jax(setup: MieSetup, m):
    """a_n, b_n (nr, n_max) as a function of the complex refractive index
    m (traced). lax.scan over the downward D_n recurrence."""
    x = jnp.asarray(setup.x)
    y = x * m                               # (nr,) complex
    nmx = setup.nmx

    def d_step(d, n):
        np1_y = (n + 1.0) / y
        d_new = np1_y - 1.0 / (d + np1_y)
        return d_new, d_new

    ns = jnp.arange(nmx - 1, 0, -1, dtype=setup.x.dtype)
    d0 = jnp.zeros_like(y)
    _, d_rev = jax.lax.scan(d_step, d0, ns)
    # step at order n yields D of order n-1... in array-index terms the
    # reversed outputs are D for orders 1, 2, ..., nmx-1 (matches the numpy
    # path in mie.compute_mie_ab_batch, where d[k] holds order k+1)
    d = d_rev[::-1]
    d = d[:setup.n_max].T                   # (nr, n_max): orders 1..n_max

    n_arr = jnp.arange(1, setup.n_max + 1, dtype=setup.x.dtype)
    t_a = d / m + n_arr[None, :] / x[:, None]
    t_b = d * m + n_arr[None, :] / x[:, None]
    psi, psi1 = jnp.asarray(setup.psi), jnp.asarray(setup.psi_m1)
    xi, xi1 = jnp.asarray(setup.xi), jnp.asarray(setup.xi_m1)
    an = (t_a * psi - psi1) / (t_a * xi - xi1)
    bn = (t_b * psi - psi1) / (t_b * xi - xi1)
    mask = jnp.asarray(setup.trunc)
    return an * mask, bn * mask


def greek_stack_jax(setup: MieSetup, theta):
    """theta = (mu_g, sigma_g, n_r, n_i) -> (greeks (6, n_mu), ssa, k_ext).

    Fully traced NAI2 pipeline (mirrors nai2.compute_aerosol_optical_
    properties numerically)."""
    mu_g, sigma_g, n_r, n_i = theta
    m = n_r + 1j * jnp.abs(n_i)
    r = jnp.asarray(setup.r)
    x = jnp.asarray(setup.x)
    k = 2.0 * jnp.pi / setup.lam

    # log-normal quadrature weights (differentiable in mu_g, sigma_g)
    mu_ln, sig_ln = jnp.log(mu_g), jnp.log(sigma_g)
    pdf = (jnp.exp(-0.5 * ((jnp.log(r) - mu_ln) / sig_ln) ** 2)
           / (r * sig_ln * jnp.sqrt(2.0 * jnp.pi)))
    wx = pdf * jnp.asarray(setup.w_r)
    wx = wx / wx.sum()

    an, bn = _mie_ab_jax(setup, m)

    n_arr = jnp.arange(1, setup.n_max + 1, dtype=setup.x.dtype)
    w2n1 = 2 * n_arr + 1
    c_sca = 2 * jnp.pi / k**2 * ((jnp.abs(an) ** 2 + jnp.abs(bn) ** 2)
                                 @ w2n1)
    c_ext = 2 * jnp.pi / k**2 * (jnp.real(an + bn) @ w2n1)
    bulk_c_sca = jnp.sum(wx * c_sca)
    bulk_c_ext = jnp.sum(wx * c_ext)

    coef_n = w2n1 / (n_arr * (n_arr + 1))
    ca, cb = coef_n * an, coef_n * bn
    leg_pi = jnp.asarray(setup.leg_pi)
    leg_tau = jnp.asarray(setup.leg_tau)
    s1 = leg_tau @ ca.T + leg_pi @ cb.T      # (n_mu, nr)
    s2 = leg_pi @ ca.T + leg_tau @ cb.T

    inv_x2 = 0.5 / x[None, :] ** 2
    f11 = inv_x2 * (jnp.abs(s1) ** 2 + jnp.abs(s2) ** 2)
    f33 = inv_x2 * 2.0 * jnp.real(s1 * jnp.conj(s2))
    f12 = -inv_x2 * (jnp.abs(s1) ** 2 - jnp.abs(s2) ** 2)
    f34 = -inv_x2 * jnp.imag(s1 * jnp.conj(s2) - s2 * jnp.conj(s1))

    wr = 4.0 * jnp.pi * r**2 * wx
    bf11 = (f11 @ wr) / bulk_c_sca
    bf33 = (f33 @ wr) / bulk_c_sca
    bf12 = (f12 @ wr) / bulk_c_sca
    bf34 = (f34 @ wr) / bulk_c_sca

    pr = setup.proj
    w_mu = jnp.asarray(setup.w_mu)
    wP = w_mu[:, None] * jnp.asarray(pr["P"])
    wP2 = w_mu[:, None] * jnp.asarray(pr["P2"])
    wR2 = w_mu[:, None] * jnp.asarray(pr["R2"])
    wT2 = w_mu[:, None] * jnp.asarray(pr["T2"])
    fac = jnp.asarray(pr["fac"])
    coef = jnp.asarray(pr["coef"])
    delta = coef * (bf33 @ wP)
    beta = coef * (bf11 @ wP)
    gamma = fac * (bf12 @ wP2)
    eps = fac * (bf34 @ wP2)
    zeta = fac * (bf33 @ wR2 + bf11 @ wT2)
    alpha = fac * (bf11 @ wR2 + bf33 @ wT2)

    greeks = jnp.stack([alpha, beta, gamma, delta, eps, zeta])
    return greeks, bulk_c_sca / bulk_c_ext, bulk_c_ext


def aerosol_optics_with_derivs(mu_g, sigma_g, n_r, n_i, lam, r_max,
                               nquad_radius):
    """AerosolOptics + forward-mode derivatives w.r.t. (mu, sigma, nr, ni).

    Returns (AerosolOptics, derivs) where derivs is a dict with
    d_greeks (4, 6, L), d_ssa (4,), d_k (4,) — the reference's
    AerosolOptics.derivs seam (phase_function_autodiff.jl:41-94).
    """
    setup = make_setup(lam, r_max, nquad_radius)
    f = partial(greek_stack_jax, setup)
    theta = jnp.asarray([mu_g, sigma_g, n_r, n_i], jnp.float64)
    greeks, ssa, k = f(theta)
    jg, jssa, jk = jax.jacfwd(f)(theta)
    gc = GreekCoefs(*[np.asarray(greeks[i]) for i in range(6)])
    optics = AerosolOptics(greek_coefs=gc, ssa=float(ssa), k=float(k),
                           f_t=1.0)
    derivs = dict(d_greeks=np.moveaxis(np.asarray(jg), -1, 0),
                  d_ssa=np.asarray(jssa), d_k=np.asarray(jk))
    return optics, derivs
