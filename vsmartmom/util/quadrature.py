"""Quadrature stream construction for the RT solver.

Re-design of the reference's stream setup
(ref: src/CoreRT/tools/rt_set_streams.jl:24-170). All quadrature nodes are
computed host-side in float64 with numpy (setup-time cost); the resulting
``QuadPoints`` arrays are consumed by the jitted RT core.

Three schemes (ref: rt_set_streams.jl):
  - GaussQuadHemisphere : Gauss-Legendre on [0, 1]
  - GaussQuadFullSphere : positive half of a 2N Gauss-Legendre rule on [-1, 1]
  - RadauQuad           : Gauss-Radau split at the solar zenith cosine so the
                          direct beam direction is a full quadrature node (DNI)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class QuadPoints:
    """Quadrature points/weights for the RT solver.

    ref: src/CoreRT/types.jl:456-473 (struct QuadPoints)

    Attributes:
      mu0:        cosine of the solar zenith angle.
      i_mu0:      index (0-based) of the quadrature node nearest to mu0.
      i_mu0_n:    start index (0-based) of the solar block in the
                  stokes-expanded vectors (= n_stokes * i_mu0).
      qp_mu:      quadrature nodes, shape (Nquad,).
      wt_mu:      quadrature weights, shape (Nquad,). Camera-only nodes carry 0.
      qp_mu_n:    nodes repeated n_stokes times each, shape (Nquad*n_stokes,).
      wt_mu_n:    weights repeated n_stokes times each.
      n_quad:     number of distinct mu nodes.
    """
    mu0: float
    i_mu0: int
    i_mu0_n: int
    qp_mu: np.ndarray
    wt_mu: np.ndarray
    qp_mu_n: np.ndarray
    wt_mu_n: np.ndarray
    n_quad: int


def gauss_legendre(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1] (ascending nodes)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


def gauleg(n: int, a: float, b: float) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre rule affinely mapped to [a, b].

    ref: src/Scattering/mie_helper_functions.jl:177 (gauleg)
    """
    x, w = gauss_legendre(n)
    xm, xl = 0.5 * (b + a), 0.5 * (b - a)
    return xm + xl * x, xl * w


def gauss_radau(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Radau rule on [-1, 1] with a fixed node at -1 (ascending).

    Golub-Welsch with the Gautschi end-point modification: the Jacobi matrix
    of the (monic) Legendre recurrence has its last diagonal entry replaced by
      a - beta_{n-1} * pi_{n-2}(a) / pi_{n-1}(a),  a = -1.
    Eigenvalues are the nodes; weights are mu0 * (first eigvec component)^2
    with mu0 = integral of the weight = 2.
    """
    assert n >= 2
    a = -1.0
    k = np.arange(1, n)
    beta = k**2 / (4.0 * k**2 - 1.0)          # monic recurrence beta_k, k>=1
    # Evaluate monic Legendre pi_{n-1}(a), pi_{n-2}(a)
    p_prev, p_curr = 1.0, a                    # pi_0, pi_1
    for j in range(1, n - 1):
        p_prev, p_curr = p_curr, a * p_curr - beta[j - 1] * p_prev
    # After loop: p_curr = pi_{n-1}(a), p_prev = pi_{n-2}(a)
    alpha_mod = a - beta[n - 2] * p_prev / p_curr
    diag = np.zeros(n)
    diag[-1] = alpha_mod
    J = np.diag(diag) + np.diag(np.sqrt(beta), 1) + np.diag(np.sqrt(beta), -1)
    vals, vecs = np.linalg.eigh(J)
    order = np.argsort(vals)
    nodes = vals[order]
    weights = 2.0 * vecs[0, order] ** 2
    nodes[0] = -1.0                            # fixed endpoint, exactly
    return nodes, weights


def _unique_keep_order(x: np.ndarray) -> np.ndarray:
    """Remove exact-duplicate floats, preserving first-occurrence order."""
    seen = set()
    out = []
    for v in x:
        fv = float(v)
        if fv not in seen:
            seen.add(fv)
            out.append(fv)
    return np.asarray(out)


def nearest_point(arr: np.ndarray, v: float) -> int:
    """Index of the element of ``arr`` nearest to ``v`` (0-based)."""
    return int(np.argmin(np.abs(np.asarray(arr) - v)))


def _finalize(qp_mu: np.ndarray, wt_mu: np.ndarray, mu0: float,
              n_stokes: int) -> QuadPoints:
    n_quad = len(qp_mu)
    i_mu0 = nearest_point(qp_mu, mu0)
    qp_mu_n = np.repeat(qp_mu, n_stokes)
    wt_mu_n = np.repeat(wt_mu, n_stokes)
    return QuadPoints(
        mu0=float(mu0), i_mu0=i_mu0, i_mu0_n=n_stokes * i_mu0,
        qp_mu=qp_mu, wt_mu=wt_mu, qp_mu_n=qp_mu_n, wt_mu_n=wt_mu_n,
        n_quad=n_quad)


def rt_set_streams(quad_type: str, l_trunc: int, sza: float, vza,
                   n_stokes: int) -> QuadPoints:
    """Build quadrature streams; mirrors the reference schemes exactly.

    quad_type: one of 'GaussQuadHemisphere', 'GaussQuadFullSphere', 'RadauQuad'.
    sza in degrees; vza a sequence of viewing zenith angles in degrees.
    """
    vza = np.asarray(vza, dtype=np.float64)
    mu0 = float(np.cos(np.deg2rad(sza)))
    n_half = (l_trunc + 1) // 2
    cos_vza = np.cos(np.deg2rad(vza))

    if quad_type == "GaussQuadHemisphere":
        qp, wt = gauleg(n_half, 0.0, 1.0)
        qp_mu = _unique_keep_order(np.concatenate([qp, cos_vza, [mu0]]))
        wt_mu = np.concatenate([wt, np.zeros(len(qp_mu) - len(wt))])
    elif quad_type == "GaussQuadFullSphere":
        qp, wt = gauss_legendre(2 * n_half)
        qp_mu = _unique_keep_order(
            np.concatenate([qp[n_half:], cos_vza, [mu0]]))
        wt_mu = np.concatenate(
            [wt[n_half:], np.zeros(len(qp_mu) - n_half)])
    elif quad_type == "RadauQuad":
        r_nodes, r_wts = gauss_radau(n_half)
        # Reorient so the fixed endpoint sits at +1 (ref flips sign+order).
        qp0 = -r_nodes[::-1]
        wt0 = r_wts[::-1]
        if np.any(qp0 == mu0):
            # mu0 already a node of the single-interval rule on [0, 1]
            qp = (1.0 + qp0) / 2.0
            wt = wt0.copy()
        else:
            # Two Radau intervals [0, mu0] and [mu0, 1]; the fixed endpoint of
            # each maps onto mu0 and 1 respectively -> direct beam is a node.
            qp = np.concatenate([(mu0 + mu0 * qp0) / 2.0,
                                 ((1.0 + mu0) + (1.0 - mu0) * qp0) / 2.0])
            wt = np.concatenate([mu0 * wt0 / 2.0, (1.0 - mu0) * wt0 / 2.0])
        qp_mu = _unique_keep_order(np.concatenate([qp, cos_vza]))
        wt_mu = np.concatenate([wt, np.zeros(len(qp_mu) - len(wt))])
    else:
        raise ValueError(f"Unknown quadrature type: {quad_type}")

    return _finalize(qp_mu, wt_mu, mu0, n_stokes)
