"""Doubling-adding RT core (elemental / doubling / interaction).

This is a ground-up JAX re-design of the reference's CoreKernel
(ref: src/CoreRT/CoreKernel/{elemental,doubling,interaction}.jl and
src/CoreRT/rt_run.jl). Key departures from the CUDA/Julia architecture:

  * Arrays are batch-leading ``(nSpec, N, N)`` so every matrix product maps to
    an XLA batched matmul (the reference uses trailing-batch CUBLAS strided
    calls).
  * Explicit inverses (CUBLAS getri) are replaced by batched LU solves
    ``X A^{-1} = solve(A^T, X^T)^T`` (better numerically) or by a
    Newton-Schulz iteration of batched products.
  * Mutable layer structs + in-place kernels are replaced by an immutable
    pytree carried through ``lax.scan`` over atmospheric layers.
  * Per-layer doubling counts are traced scalars driving ``lax.fori_loop``
    (forward-mode differentiable), rather than host-side control flow.
  * The D-matrix symmetry bookkeeping (sign flips for U/V Stokes components)
    is done with sign vectors. We use the exact D = diag(1,1,-1,-1): the
    reference's 1-based ``mod`` indexing skips the V row in its flip kernels
    (src/CoreRT/CoreKernel/doubling.jl:93-110), which is inconsequential for
    all its shipped tests (V == 0) but physically inconsistent; we do not
    replicate that quirk.

Layer state convention: R/T are (nSpec, N, N); source vectors J are (nSpec, N).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


class LayerRT(NamedTuple):
    """Reflection/transmission operator of a (composite or added) slab.

    r_mp = R^-+ (illuminated from top, reflected up), r_pm = R^+-,
    t_pp = T^++ (downward transmission), t_mm = T^--,
    j_p = J0^+ (downwelling source), j_m = J0^- (upwelling source).
    ref: src/CoreRT/types.jl:108-141 (AddedLayer / CompositeLayer)
    """
    r_mp: jnp.ndarray
    r_pm: jnp.ndarray
    t_pp: jnp.ndarray
    t_mm: jnp.ndarray
    j_p: jnp.ndarray
    j_m: jnp.ndarray


def vacuum_layer(n_spec: int, n: int, dtype) -> LayerRT:
    """Identity (empty-space) slab: interaction with it is a no-op copy."""
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (n_spec, n, n))
    zero_m = jnp.zeros((n_spec, n, n), dtype)
    zero_v = jnp.zeros((n_spec, n), dtype)
    return LayerRT(zero_m, zero_m, eye, eye, zero_v, zero_v)


class LayerRTDev(NamedTuple):
    """Slab operator in direct/diffuse split ("deviation") form.

    The transmission operators are carried as T = diag(g) + E with g the
    DIRECT-BEAM diagonal (pure exponentials exp(-tau/mu), shared by T^++
    and T^-- — the direct beam is reciprocal) and E the diffuse deviation.
    This is the classic direct/diffuse separation of RT, used here for a
    numerics reason: every matrix product in doubling/interaction then
    acts on diffuse-scale operands only, so (a) the ~1.0 identity diagonal
    never rides a matmul — the absolute error floor of a reduced-precision
    product (~2^-16 |A||B| for a 3-pass bf16 split) becomes RELATIVE to
    the diffuse field instead of catastrophic, and (b) the f32 floor of
    the doubling recursion itself improves (no repeated near-identity
    cancellations). No reference counterpart — the reference runs f64
    CUBLAS (gpu_batched.jl) and never needed the split.
    """
    r_mp: jnp.ndarray
    r_pm: jnp.ndarray
    e_pp: jnp.ndarray   # T^++ = diag(g) + e_pp
    e_mm: jnp.ndarray   # T^-- = diag(g) + e_mm
    g: jnp.ndarray      # (nSpec, N) direct transmission diagonal
    j_p: jnp.ndarray
    j_m: jnp.ndarray


def vacuum_layer_dev(n_spec: int, n: int, dtype) -> LayerRTDev:
    zero_m = jnp.zeros((n_spec, n, n), dtype)
    zero_v = jnp.zeros((n_spec, n), dtype)
    return LayerRTDev(zero_m, zero_m, zero_m, zero_m,
                      jnp.ones((n_spec, n), dtype), zero_v, zero_v)


def dev_to_full(dev: LayerRTDev) -> LayerRT:
    """Reassemble full operators T = diag(g) + E (f32-storage-floor exact)."""
    n = dev.g.shape[-1]
    gd = dev.g[:, :, None] * jnp.eye(n, dtype=dev.g.dtype)[None]
    return LayerRT(r_mp=dev.r_mp, r_pm=dev.r_pm,
                   t_pp=gd + dev.e_pp, t_mm=gd + dev.e_mm,
                   j_p=dev.j_p, j_m=dev.j_m)


# --- batched linear algebra helpers -----------------------------------------

def bmm(a, b):
    """Batched matrix product over leading spectral axis."""
    return jnp.einsum("nij,njk->nik", a, b,
                      preferred_element_type=a.dtype)


def bmv(a, v):
    """Batched matrix-vector product."""
    return jnp.einsum("nij,nj->ni", a, v, preferred_element_type=a.dtype)


def rsolve_lu(x, a):
    """Compute X @ A^{-1} via batched LU solve (never form the inverse)."""
    return jnp.linalg.solve(a.transpose(0, 2, 1),
                            x.transpose(0, 2, 1)).transpose(0, 2, 1)


def _lu_apply(left, a, x):
    return bmm(rsolve_lu(left, a), x)


# (left @ A^{-1}) @ x with solver-chosen association: callers concatenate
# several right-hand operands into one x.
rsolve_lu.apply = _lu_apply


def make_rsolve(solver: str = "lu", schulz_iters: int = 4):
    """Right-solve factory: X @ A^{-1} for A = I - B with spectral radius
    rho(B) < 1 (guaranteed for passive media: B is a product of reflection
    operators).

    'lu'     — batched LU (exact; LAPACK on CPU).
    'schulz' — Newton-Schulz iteration, pure batched matmuls.
               M_0 = 2I - A (= I + B); residual after k iterations is
               B^(2^(k+1)): 4 iterations leave B^32 — < 1e-6 even for a
               thick-cloud rho(B) = 0.64, and at rounding level for the
               Rayleigh-regime rho ~ 0.1.
    """
    if solver == "lu":
        return rsolve_lu

    def _schulz_m(a):
        n = a.shape[-1]
        eye2 = 2.0 * jnp.eye(n, dtype=a.dtype)
        m = eye2 - a                        # I + B
        for _ in range(schulz_iters):
            m = bmm(m, eye2 - bmm(a, m))
        return m

    def rsolve_schulz(x, a):
        return bmm(x, _schulz_m(a))

    def _schulz_apply(left, a, x):
        # left @ (M @ x): the wide packed operand x rides both products
        # instead of materializing the n-wide left @ M.
        return bmm(left, bmm(_schulz_m(a), x))

    rsolve_schulz.apply = _schulz_apply
    # Raman fast path: the approximate right-inverse M(A) is POINTWISE in
    # the spectral batch, so callers that need the same solve at gathered
    # spectral indices (banded Raman shifts) can materialize M once and
    # gather it — M(gather(A)) == gather(M(A)) exactly. Saves the per-shift
    # Newton-Schulz recomputation (~2x on the RRS path, rt_raman.py).
    rsolve_schulz.materialize_m = _schulz_m
    return rsolve_schulz


def ns_iters_for_bound(b: float, tol: float = 1e-8, cap: int = 4) -> int:
    """Newton-Schulz iterations needed to solve (I - B)^-1 with
    rho(B) <= b: residual after i iterations is B^(2^(i+1))."""
    if b <= 0:
        return 0
    if b >= 1:
        return cap
    need = np.log(tol) / np.log(b)          # want 2^(i+1) >= need
    return min(cap, max(0, int(np.ceil(np.log2(max(need, 1.0)))) - 1))


def ns_doubling_schedule(tau_scat_bound: float, min_qp_mu: float,
                         ndoubl: int, tol: float = 1e-8,
                         cap: int = 4) -> tuple:
    """Per-doubling-step Newton-Schulz iteration counts.

    At step k the slab has scattering depth tau_k = bound / 2^(nd-k); its
    reflection operator is bounded by the worst-node plane albedo
    ||r|| <= 1 - exp(-2 tau_k / mu_min), so rho(r r) <= that squared.
    Early (thin) steps need 0-1 iterations; only the last few need the
    full count — ~40% fewer matrix products per layer at identical
    results (residual kept below f32 rounding).
    """
    sched = []
    for k in range(ndoubl):
        tau_k = tau_scat_bound / 2.0 ** (ndoubl - k)
        r_bound = -np.expm1(-2.0 * tau_k / min_qp_mu)
        sched.append(ns_iters_for_bound(r_bound * r_bound, tol, cap))
    return tuple(sched)


def ns_interaction_iters(tau_scat, min_qp_mu: float, tol: float = 1e-8,
                         cap: int = 4) -> tuple:
    """Per-layer Newton-Schulz iteration counts for the interaction solve.

    The layer scan runs TOA -> BOA: composing the composite (all layers
    above z) with added layer z solves (I - r_z R_comp)^{-1}. Its spectral
    radius is bounded by the product of the two plane albedos,
      ||r_z||     <= 1 - exp(-2 tau_z / mu_min)          (added slab)
      ||R_comp||  <= 1 - exp(-2 sum_{z'<z} tau_z' / mu_min)  (stack above),
    the same worst-node bound ns_doubling_schedule uses per doubling step.
    Real profiles have an optically thin upper atmosphere: the first ~half
    of the layers need 0-1 iterations instead of the fixed 4 (the layer
    with a VACUUM composite needs 0 exactly: A = I). Iteration counts keep
    the residual B^(2^(i+1)) below f32 rounding, so results are unchanged.

    ``tau_scat``: per-layer scattering optical depth bounds, TOA first
    (host numpy). Returns a tuple of Python ints (static schedule data).
    """
    tau_scat = np.maximum(np.asarray(tau_scat, dtype=float), 0.0)
    tau_above = np.concatenate([[0.0], np.cumsum(tau_scat)[:-1]])
    r_add = -np.expm1(-2.0 * tau_scat / min_qp_mu)
    r_comp = -np.expm1(-2.0 * tau_above / min_qp_mu)
    return tuple(ns_iters_for_bound(float(ra * rc), tol, cap)
                 for ra, rc in zip(r_add, r_comp))


# --- doubling count (ref: src/CoreRT/tools/rt_helper_functions.jl:31-57) ----

def doubling_number(dtau_max, tau_end):
    """Number of doublings to grow an elemental layer of <= dtau_max to
    tau_end. Traced-scalar version of the reference's log10 splitting."""
    eps = jnp.finfo(jnp.result_type(float)).eps
    tlimit = jnp.log2(tau_end / dtau_max)
    nlimit = jnp.floor(tlimit)
    ndoubl = jnp.where(tlimit - nlimit < eps, nlimit, nlimit + 1.0)
    ndoubl = jnp.where(tau_end <= dtau_max, 0.0, ndoubl)
    return jnp.maximum(ndoubl, 0.0).astype(jnp.int32)


# --- elemental single-scattering layer --------------------------------------

def exp_small(x):
    """e^x for the tiny per-step arguments of the elemental layer.

    An f32 exp that rounds to ~2e-6 relative would be compounded
    2^ndoubl-fold by the doubling recursion (~1% at ndoubl=13, grazing mu).
    1 + expm1(x) is correctly rounded near zero (absolute error ~1e-9) and
    algebraically identical. Large-argument exponentials (tau_sum
    attenuation) keep plain exp.
    """
    return 1.0 + jnp.expm1(x)


def elemental(dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
              i0_vec, i_mu0_n, n_stokes, mu0_node, split=False):
    """Single-scattering initialization of an elemental layer.

    ref: src/CoreRT/CoreKernel/elemental.jl:164-253 (get_elem_rt!/..._SFI!).
    Pure jnp broadcasting — XLA fuses the whole thing into one kernel.

    dtau, omega, tau_sum: (nSpec,); z_pp/z_mp: (nSpec|1, N, N);
    qp, wct2: (N,); i0_vec: (N,) incident Stokes vector embedded at the solar
    node block; mu0_node: scalar, qp[i_mu0_n].
    Returns r_mp, t_pp (nSpec, N, N) and j_p, j_m (nSpec, N).

    ``split=True``: return (r_mp, g, e_pp, j_p, j_m) with T^++ in
    direct/diffuse form diag(g) + e_pp (see LayerRTDev). The diffuse
    diagonal is built DIRECTLY from the single-scatter term (never by
    subtracting exp(-dtau/mu) from the assembled diagonal, which would
    throw away ~half its f32 mantissa).
    """
    dt = dtau[:, None, None]
    om = omega[:, None, None]
    mu_i = qp[:, None]
    mu_j = qp[None, :]
    same_mu = mu_i == mu_j
    eye = jnp.eye(qp.shape[0], dtype=bool)
    col_mask = wct2 > 1e-8

    exp_i = exp_small(-dtau[:, None, None] / mu_i)     # (nSpec, N, 1)->bcast

    # R^-+(mu_i, mu_j) = w Z^-+ (mu_j/(mu_i+mu_j)) w_j (1 - e^{-dt(1/mu_i+1/mu_j)})
    # expm1 keeps full precision for the tiny dtau of elemental layers
    # (dtau ~ 1e-4: naive 1-exp(-x) loses ~half the mantissa in f32).
    r_mp = (om * z_mp * (mu_j / (mu_i + mu_j)) * wct2[None, None, :]
            * (-jnp.expm1(-dt * (1.0 / mu_i + 1.0 / mu_j))))
    r_mp = jnp.where(col_mask[None, None, :], r_mp, 0.0)

    # T^++ diagonal: e^{-dt/mu_i}(1 + w Z^++_ii (dt/mu_i) w_i)
    e_diag = exp_i * (om * z_pp * (dt / mu_i) * wct2[None, None, :])
    t_diag = exp_i + e_diag
    # T^++ off-diagonal (mu_i != mu_j):
    # e^{-dt/mu_i} - e^{-dt/mu_j} = e^{-dt/mu_j} expm1(dt/mu_j - dt/mu_i)
    denom = jnp.where(same_mu, 1.0, mu_i - mu_j)
    # expm1 argument as ONE subtraction of exact node values: computing
    # dt/mu_j - dt/mu_i from two rounded quotients cancels catastrophically
    # for adjacent nodes in f32 — dt (mu_i - mu_j)/(mu_i mu_j) is
    # algebraically identical and rounds once.
    exp_diff = (exp_small(-dt / mu_j)
                * jnp.expm1(dt * (mu_i - mu_j) / (mu_i * mu_j)))
    t_off = om * z_pp * (mu_j / denom) * wct2[None, None, :] * exp_diff
    if split:
        # diffuse deviation only: same selects as t_pp below, minus diag(g)
        e_pp = jnp.where(same_mu[None, :, :],
                         jnp.where(eye[None, :, :], e_diag, 0.0),
                         t_off)
        e_pp = jnp.where(col_mask[None, None, :], e_pp, 0.0)
    else:
        t_pp = jnp.where(same_mu[None, :, :],
                         jnp.where(eye[None, :, :], t_diag, 0.0),
                         t_off)
        # Zero-weight (camera-only) columns transmit attenuated beam only
        t_pp = jnp.where(col_mask[None, None, :], t_pp,
                         jnp.where(eye[None, :, :],
                                   exp_i * jnp.ones_like(t_pp), 0.0))

    # --- SFI solar source vectors (Fell eqs. 1.52-1.54) ---
    z_pp_i0 = bmv(jnp.broadcast_to(z_pp, (dtau.shape[0],) + z_pp.shape[-2:]),
                  jnp.broadcast_to(i0_vec, (dtau.shape[0], i0_vec.shape[0])))
    z_mp_i0 = bmv(jnp.broadcast_to(z_mp, (dtau.shape[0],) + z_mp.shape[-2:]),
                  jnp.broadcast_to(i0_vec, (dtau.shape[0], i0_vec.shape[0])))

    idx = jnp.arange(qp.shape[0])
    in_block = (idx >= i_mu0_n) & (idx < i_mu0_n + n_stokes)

    mu_iv = qp[None, :]
    dt_v = dtau[:, None]
    exp_iv = exp_small(-dt_v / mu_iv)
    # degenerate limit applies to the solar block AND any node whose mu
    # coincides with mu0 (e.g. vza=0 with sza~0 collapses to the same f32
    # value — the mu_i - mu0 division would produce inf * 0 = NaN)
    same0 = in_block[None, :] | (mu_iv == mu0_node)
    denom0 = jnp.where(same0, 1.0, mu_iv - mu0_node)
    # e^{-dt/mu_i} - e^{-dt/mu_0} via expm1 (cancellation-safe, and the
    # argument as one subtraction — see exp_diff above)
    exp_diff0 = (exp_small(-dt_v / mu0_node)
                 * jnp.expm1(dt_v * (mu_iv - mu0_node)
                             / (mu_iv * mu0_node)))
    j_p = jnp.where(
        same0,
        (dt_v / mu_iv) * exp_iv,
        (mu0_node / denom0) * exp_diff0)
    j_p = wct02 * omega[:, None] * z_pp_i0 * j_p
    j_m = (wct02 * omega[:, None] * z_mp_i0 * (mu0_node / (mu_iv + mu0_node))
           * (-jnp.expm1(-dt_v * (1.0 / mu_iv + 1.0 / mu0_node))))

    atten = jnp.exp(-tau_sum / mu0_node)[:, None]
    if split:
        n_sp = dtau.shape[0]
        g = jnp.broadcast_to(exp_small(-dtau[:, None] / qp[None, :]),
                             (n_sp, qp.shape[0]))
        return r_mp, g, e_pp, j_p * atten, j_m * atten
    return r_mp, t_pp, j_p * atten, j_m * atten


# --- doubling (ref: src/CoreRT/CoreKernel/doubling.jl:13-91) ----------------

def doubling(r_mp_f, t_pp, j_p, j_m_f, expk, ndoubl, eye, rsolve=rsolve_lu,
             ns_schedule=None):
    """Grow an elemental layer to the full homogeneous slab by doubling.

    Operates on the row-flipped quantities r̃ = D r^-+ and J̃^- = D J^- so the
    doubling recursion needs only one reflection operator (D-symmetry trick,
    ref: doubling.jl:43-68). ``ndoubl`` may be a traced scalar (lowers to a
    while_loop, forward-mode differentiable) or a Python int (statically
    unrolled; reverse-mode differentiable too). ``ns_schedule`` (unrolled path only): per-step
    Newton-Schulz iteration counts from ns_doubling_schedule, overriding
    ``rsolve`` step by step.
    """
    def body(state, step_rsolve):
        # Operand packing: every right-hand operand sharing a left matrix
        # rides one batched product — r @ [t | jp | j1m], then
        # tt @ [r t | t | v1 | v2] with tt = t (I - r r)^{-1} never
        # materialized (solver .apply chooses the association).
        # 5+2k products/step instead of 9+2k.
        r, t, jp, jm, ek = state
        n = r.shape[-1]
        j1p = jp * ek[:, None]
        j1m = jm * ek[:, None]
        pack1 = jnp.concatenate([t, jp[..., None], j1m[..., None]], axis=-1)
        rp = bmm(r, pack1)                     # [r t | r jp | r j1m]
        v1 = j1m + rp[..., n]
        v2 = jp + rp[..., n + 1]
        pack2 = jnp.concatenate(
            [rp[..., :n], t, v1[..., None], v2[..., None]], axis=-1)
        a = eye - bmm(r, r)
        apply = getattr(step_rsolve, "apply",
                        lambda left, aa, x: bmm(step_rsolve(left, aa), x))
        tp = apply(t, a, pack2)                # tt @ [r t | t | v1 | v2]
        jm_new = jm + tp[..., 2 * n]
        jp_new = j1p + tp[..., 2 * n + 1]
        r_new = r + tp[..., :n]
        t_new = tp[..., n:2 * n]
        return (r_new, t_new, jp_new, jm_new, ek * ek)

    state = (r_mp_f, t_pp, j_p, j_m_f, expk)
    if isinstance(ndoubl, int):
        if ns_schedule is not None:
            assert len(ns_schedule) == ndoubl
            for it in ns_schedule:
                state = body(state, make_rsolve("schulz", int(it)))
        else:
            for _ in range(ndoubl):
                state = body(state, rsolve)
    else:
        state = lax.fori_loop(0, ndoubl,
                              lambda _, s: body(s, rsolve), state)
    return state[:4]


def elemental_flipped(tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02,
                      i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                      min_qp_mu, ndoubl_static=None):
    """Elemental single-scattering layer in flipped (D-symmetry) space,
    plus the doubling inputs (expk, ndoubl). Shared by make_added_layer and
    the fused layer-step kernel path (pallas/layer_step_kernel.py).
    ref: src/CoreRT/CoreKernel/rt_kernel.jl:238-275 (init_layer)
    """
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
        scale = 2.0 ** ndoubl.astype(tau.dtype)
    dtau = tau / scale
    expk = exp_small(-dtau / mu0)

    r_mp, t_pp, j_p, j_m = elemental(
        dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
        i0_vec, i_mu0_n, n_stokes, mu0_node)

    r_f = d_vec[None, :, None] * r_mp
    jm_f = d_vec[None, :] * j_m
    return r_f, t_pp, j_p, jm_f, expk, ndoubl


def make_added_layer(tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02,
                     i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                     min_qp_mu, eye, rsolve=rsolve_lu,
                     ndoubl_static=None, ns_schedule=None) -> LayerRT:
    """Elemental + doubling for one atmospheric layer -> full added layer.

    tau/omega: (nSpec,) per-wavelength optical depth & single-scatter albedo.
    ``ndoubl_static``: optional Python int (host-precomputed max doubling
    count) selecting the statically-unrolled doubling loop.
    ref: src/CoreRT/CoreKernel/rt_kernel.jl:238-275 (init_layer + dispatch)
    """
    r_f, t_pp, j_p, jm_f, expk, ndoubl = elemental_flipped(
        tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02, i0_vec, i_mu0_n,
        n_stokes, mu0_node, mu0, d_vec, min_qp_mu,
        ndoubl_static=ndoubl_static)
    r_f, t_pp, j_p, jm_f = doubling(r_f, t_pp, j_p, jm_f, expk, ndoubl,
                                    eye, rsolve=rsolve,
                                    ns_schedule=ns_schedule)
    r_mp = d_vec[None, :, None] * r_f
    j_m = d_vec[None, :] * jm_f

    # Derive mirror operators from D-matrix symmetry: R^+- = D R^-+ D etc.
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    return LayerRT(r_mp=r_mp, r_pm=sgn * r_mp, t_pp=t_pp, t_mm=sgn * t_pp,
                   j_p=j_p, j_m=j_m)


# --- interaction / adding (ref: src/CoreRT/CoreKernel/interaction.jl) -------

def interaction(comp: LayerRT, added: LayerRT, eye, rsolve=rsolve_lu) -> LayerRT:
    """Compose composite(top) with added(bottom) slab (full 11-path adding).

    With a vacuum composite this reduces exactly to a copy of ``added``, so no
    special-casing of the first layer is needed. The reference's 00/01/10
    shortcuts are algebraic special cases of this path.
    ref: src/CoreRT/CoreKernel/interaction.jl:69-117
    """
    # No operand packing here: in the XLA path the concatenated operands
    # materialize in device memory. The fused layer-step kernel
    # (pallas/layer_step_kernel.py) keeps them on-chip instead.
    a1 = eye - bmm(added.r_mp, comp.r_pm)
    t01 = rsolve(comp.t_mm, a1)               # T^--_comp (I - r R)^{-1}
    j_m = comp.j_m + bmv(t01, bmv(added.r_mp, comp.j_p) + added.j_m)
    r_mp = comp.r_mp + bmm(t01, bmm(added.r_mp, comp.t_pp))
    t_mm = bmm(t01, added.t_mm)

    a2 = eye - bmm(comp.r_pm, added.r_mp)
    t21 = rsolve(added.t_pp, a2)
    j_p = added.j_p + bmv(t21, comp.j_p + bmv(comp.r_pm, added.j_m))
    t_pp = bmm(t21, comp.t_pp)
    r_pm = added.r_pm + bmm(t21, bmm(comp.r_pm, added.t_mm))

    return LayerRT(r_mp=r_mp, r_pm=r_pm, t_pp=t_pp, t_mm=t_mm,
                   j_p=j_p, j_m=j_m)


# --- direct/diffuse split ("deviation form") engine -------------------------
#
# Same doubling-adding algebra as above, with every transmission operator
# carried as diag(g) + E (see LayerRTDev). The Newton-Schulz solve is run in
# Y-form: (I - B)^{-1} = I + Y with Y_0 = B, Y <- W + Y(W - Y), W = B + B Y
# (algebraically the plain iteration with the identity handled exactly).
# Matmul operands never contain the ~1.0 direct-transmission diagonal, which
# (a) removes the absolute error floor of reduced-precision products and
# (b) improves the plain-f32 floor of the recursion.

def ns_y(rr, iters, mm=bmm):
    """Y-form Newton-Schulz: Y ~= (I - B)^{-1} - I for B = rr, rho(B) < 1.
    Iteration-for-iteration identical residual B^(2^(k+1)) to _schulz_m."""
    y = rr
    for _ in range(iters):
        w = rr + mm(rr, y)
        y = w + mm(y, w - y)
    return y


def y_exact_lu(rr, eye):
    """Exact Y = (I - B)^{-1} - I = B (I - B)^{-1} (polynomials in B
    commute) via batched LU — the CPU/f64 twin of ns_y."""
    return rsolve_lu(rr, eye - rr)


def doubling_dev(r_f, g, e_pp, j_p, j_m_f, expk, ns_schedule=None,
                 exact_eye=None, ndoubl=None, mm=bmm):
    """Doubling recursion in direct/diffuse split form (flipped space).

    State: r (flipped reflection), T^++ = diag(g) + e_pp, sources, expk.
    ``ns_schedule``: per-step NS iteration counts (schulz);
    ``exact_eye``: batched identity -> exact LU Y (CPU/f64 twin), with
    ``ndoubl`` giving the step count.
    Algebra check: t' = t M t, r' = r + t M r t, sources as in doubling();
    each product expanded over diag(g) + E so only diffuse-scale operands
    ride matmuls.
    """
    r, ge, e = r_f, g, e_pp
    jp, jm, ek = j_p, j_m_f, expk
    ek = ek[:, None]
    steps = (ns_schedule if ns_schedule is not None
             else [None] * int(ndoubl))
    n = r.shape[-1]
    for it in steps:
        rr = mm(r, r)
        y = (y_exact_lu(rr, exact_eye) if it is None
             else ns_y(rr, int(it), mm))
        j1p = jp * ek
        j1m = jm * ek
        pack1 = jnp.concatenate([e, jp[..., None], j1m[..., None]], axis=-1)
        rp = mm(r, pack1)                  # [r E | r jp | r j1m]
        rt = r * ge[:, None, :] + rp[..., :n]
        v1 = j1m + rp[..., n]
        v2 = jp + rp[..., n + 1]
        packy = jnp.concatenate(
            [rt, e, v1[..., None], v2[..., None]], axis=-1)
        yp = mm(y, packy)                  # [Y rt | Y E | Y v1 | Y v2]
        mrt = rt + yp[..., :n]
        d_mt = e + y * ge[:, None, :] + yp[..., n:2 * n]
        mv1 = v1 + yp[..., 2 * n]
        mv2 = v2 + yp[..., 2 * n + 1]
        packe = jnp.concatenate(
            [mrt, d_mt, mv1[..., None], mv2[..., None]], axis=-1)
        ep = mm(e, packe)
        r = r + ge[:, :, None] * mrt + ep[..., :n]
        e = ge[:, :, None] * d_mt + e * ge[:, None, :] + ep[..., n:2 * n]
        jm = jm + ge * mv1 + ep[..., 2 * n]
        jp = j1p + ge * mv2 + ep[..., 2 * n + 1]
        ge = ge * ge
        ek = ek * ek
    return r, ge, e, jp, jm


def elemental_flipped_dev(tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02,
                          i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                          ndoubl_static):
    """Split-form elemental layer in flipped (D-symmetry) space + doubling
    inputs — the dev twin of elemental_flipped."""
    ndoubl = int(ndoubl_static)
    dtau = tau / 2.0 ** ndoubl
    expk = exp_small(-dtau / mu0)
    r_mp, g, e_pp, j_p, j_m = elemental(
        dtau, omega, z_pp, z_mp, qp, wct2, wct02, tau_sum,
        i0_vec, i_mu0_n, n_stokes, mu0_node, split=True)
    r_f = d_vec[None, :, None] * r_mp
    jm_f = d_vec[None, :] * j_m
    return r_f, g, e_pp, j_p, jm_f, expk


def make_added_layer_dev(tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02,
                         i0_vec, i_mu0_n, n_stokes, mu0_node, mu0, d_vec,
                         min_qp_mu, ndoubl_static, ns_schedule=None,
                         exact_eye=None, mm=bmm) -> LayerRTDev:
    """Elemental + doubling in split form -> D-symmetric added layer.
    Twin of make_added_layer (XLA engine); g is shared by T^++/T^--
    (sgn diagonal is +1), e_mm = sgn * e_pp."""
    ndoubl = int(ndoubl_static)
    r_f, g, e_pp, j_p, jm_f, expk = elemental_flipped_dev(
        tau, omega, z_pp, z_mp, tau_sum, qp, wct2, wct02, i0_vec, i_mu0_n,
        n_stokes, mu0_node, mu0, d_vec, ndoubl)
    r_f, g, e_pp, j_p, jm_f = doubling_dev(
        r_f, g, e_pp, j_p, jm_f, expk, ns_schedule=ns_schedule,
        exact_eye=exact_eye, ndoubl=ndoubl, mm=mm)
    r_mp = d_vec[None, :, None] * r_f
    j_m = d_vec[None, :] * jm_f
    sgn = d_vec[None, :, None] * d_vec[None, None, :]
    return LayerRTDev(r_mp=r_mp, r_pm=sgn * r_mp, e_pp=e_pp,
                      e_mm=sgn * e_pp, g=g, j_p=j_p, j_m=j_m)


def interaction_dev(comp: LayerRTDev, added: LayerRTDev, ni=None,
                    exact_eye=None, mm=bmm) -> LayerRTDev:
    """Adding/interaction in split form (push-through single-solve variant,
    the same algebra as pallas/layer_step_kernel.py's interaction block).

    ``ni``: Newton-Schulz iterations for (I - r2 R)^{-1} (schulz), or None
    with ``exact_eye`` for the exact-LU twin. Composite direct diagonal
    multiplies: g' = g_comp * g_added for both transmissions.
    """
    n = comp.r_mp.shape[-1]
    gc, g2 = comp.g, added.g
    r2mp, e2, e2mm = added.r_mp, added.e_pp, added.e_mm
    b1 = mm(r2mp, comp.r_pm)
    y1 = (y_exact_lu(b1, exact_eye) if ni is None else ns_y(b1, int(ni), mm))

    # r2mp @ [c_tpp | c_jp] and c_rpm @ [t2mm | j2m] (split operands)
    p1 = mm(r2mp, jnp.concatenate(
        [comp.e_pp, comp.j_p[..., None]], axis=-1))
    rc_tpp = r2mp * gc[:, None, :] + p1[..., :n]
    v1 = p1[..., n] + added.j_m
    p2 = mm(comp.r_pm, jnp.concatenate(
        [e2mm, added.j_m[..., None]], axis=-1))
    crpm_t2mm = comp.r_pm * g2[:, None, :] + p2[..., :n]
    v2 = comp.j_p + p2[..., n]

    # push-through: y = M1 @ [x1 | r2mp @ x2] with
    # x1 = [rc_tpp | t2mm | v1], x2 = [c_tpp | crpm_t2mm | v2]; the head of
    # r2mp @ x2 is rc_tpp again, so it rides the solve once (y_b1 = y_a)
    p3 = mm(r2mp, jnp.concatenate(
        [crpm_t2mm, v2[..., None]], axis=-1))   # r2mp@x2 tail (head = rc_tpp)
    z_small = jnp.concatenate(
        [rc_tpp, e2mm, v1[..., None], p3], axis=-1)
    yz = mm(y1, z_small)
    y_a = rc_tpp + yz[..., :n]                      # M1 @ rc_tpp
    d2 = e2mm + y1 * g2[:, None, :] + yz[..., n:2 * n]   # M1@t2mm = G2 + d2
    y_v1 = v1 + yz[..., 2 * n]
    y_b1 = y_a
    y_b2 = p3[..., :n] + yz[..., 2 * n + 1:3 * n + 1]
    y_bv = p3[..., n] + yz[..., 3 * n + 1]

    # o1 = c_tmm @ (M1 @ x1):  c_tmm = diag(gc) + cE_m
    p4 = mm(comp.e_mm, jnp.concatenate(
        [y_a, d2, y_v1[..., None]], axis=-1))
    r_mp = comp.r_mp + gc[:, :, None] * y_a + p4[..., :n]
    e_mm = (gc[:, :, None] * d2 + comp.e_mm * g2[:, None, :]
            + p4[..., n:2 * n])
    j_m = comp.j_m + gc * y_v1 + p4[..., 2 * n]

    # o2 = t2 @ (x2 + c_rpm @ y2):  t2 = diag(g2) + e2
    p5 = mm(comp.r_pm, jnp.concatenate(
        [y_b1, y_b2, y_bv[..., None]], axis=-1))
    i1 = comp.e_pp + p5[..., :n]                # x2 head deviation
    i2 = crpm_t2mm + p5[..., n:2 * n]
    iv = v2 + p5[..., 2 * n]
    p6 = mm(e2, jnp.concatenate([i1, i2, iv[..., None]], axis=-1))
    e_pp = g2[:, :, None] * i1 + e2 * gc[:, None, :] + p6[..., :n]
    r_pm = added.r_pm + g2[:, :, None] * i2 + p6[..., n:2 * n]
    j_p = added.j_p + g2 * iv + p6[..., 2 * n]

    return LayerRTDev(r_mp=r_mp, r_pm=r_pm, e_pp=e_pp, e_mm=e_mm,
                      g=gc * g2, j_p=j_p, j_m=j_m)
