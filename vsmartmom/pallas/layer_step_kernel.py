"""Fused Pallas (Triton route) kernel for one full RT layer step.

One program owns one spectral point. It grows the elemental layer by
doubling and composes it with the carried composite (ref:
src/CoreRT/CoreKernel/{doubling,interaction}.jl, driven from
rt_kernel.jl:173-235), keeping the point's ~10 N x N operators in registers
and shared memory across every doubling step and the interaction. The XLA
engine runs each of the 6 + 2*ns batched N x N products per doubling step
as its own kernel with a device-memory round trip; at N = 15 in f32 that is
about 2.5 flop/byte, far below the card's ridge point.

Triton dots are 2-D with power-of-two sides of at least 16, so the wrapper
zero-pads N to 16, 32 or 64. Zero padding is inert: every solve sees an
identity block there and every product leaves zeros. Products are IEEE f32
(DotAlgorithmPreset.F32_F32_F32, FMA units): three-pass TF32 measured
slower at N = 15 and took ~20x longer to compile. The doubling schedule
runs as one loop per run of equal Newton-Schulz counts, not unrolled, so
the program holds a few loop bodies (3.5 s to compile at N = 15 against
9.0 s unrolled, PERF.md). rt_run chooses the kernel only up to
rt_run.KERNEL_MAX_N.

The added layer produced by doubling is D-symmetric (r_pm = sgn * r_mp,
t_mm = sgn * t_pp with sgn = d d^T), so only r_mp/t_pp are formed; the
composite is not D-symmetric (layers differ) and carries all six fields.
The algebra matches core.rt.doubling + core.rt.interaction (same dot
products), with one Newton-Schulz solve per interaction: the second
interaction inverse follows from the first by the push-through identity
(I - c_rpm r2mp)^-1 = I + c_rpm (I - r2mp c_rpm)^-1 r2mp.

Differentiable via jax.custom_jvp: the primal runs the kernel; the tangent
rule is the jvp of the pure-jnp twin (_xla_twin_step), mirroring how the
reference differentiates its production GPU path with Dual-number CUBLAS
overloads (ref: CoreRT/tools/gpu_batched.jl:100-151).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

PRECISION = lax.DotAlgorithmPreset.F32_F32_F32

#: Triton warps per program, by padded block side (PERF.md)
NUM_WARPS = {16: 2, 32: 4, 64: 4}


def padded_n(n: int) -> int:
    """Kernel block side: the next power of two >= max(n, 16)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def ns_runs(ns_schedule) -> tuple:
    """Consecutive equal entries of an NS schedule as (iterations, steps)."""
    runs = []
    for it in ns_schedule:
        if runs and runs[-1][0] == it:
            runs[-1][1] += 1
        else:
            runs.append([it, 1])
    return tuple((int(it), k) for it, k in runs)


def _eye(n, dtype):
    i = lax.broadcasted_iota(jnp.int32, (n, n), 0)
    j = lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return (i == j).astype(dtype)


def _layer_step_kernel(cr_mp_ref, cr_pm_ref, ct_pp_ref, ct_mm_ref,
                       cjp_ref, cjm_ref,
                       r_ref, t_ref, jp_ref, jm_ref, ek_ref, d_ref,
                       or_mp, or_pm, ot_pp, ot_mm, ojp, ojm,
                       *, ns_schedule, ni):
    def mm(a, b):
        return jnp.dot(a, b, precision=PRECISION,
                       preferred_element_type=jnp.float32)

    def mv(a, v):
        return jnp.sum(a * v[None, :], axis=1)

    r = r_ref[...]
    t = t_ref[...]
    jp = jp_ref[...]
    jm = jm_ref[...]
    ek = ek_ref[...]                      # (1,), broadcasts on vectors
    n = r.shape[-1]
    eye = _eye(n, r.dtype)

    def ns_m(a, iters):
        """Newton-Schulz inverse of A = I - B: M0 = 2I - A = I + B."""
        m = 2.0 * eye - a
        if iters == 0:
            return m
        return lax.fori_loop(0, iters,
                             lambda _, m: mm(m, 2.0 * eye - mm(a, m)), m)

    def double(it, _, carry):
        r, t, jp, jm, ek = carry
        m = ns_m(eye - mm(r, r), it)
        j1p = jp * ek
        j1m = jm * ek
        rt = mm(r, t)
        v1 = j1m + mv(r, jp)
        v2 = jp + mv(r, j1m)
        jm = jm + mv(t, mv(m, v1))
        jp = j1p + mv(t, mv(m, v2))
        r = r + mm(t, mm(m, rt))
        t = mm(t, mm(m, t))
        return r, t, jp, jm, ek * ek

    # --- 1. doubling of the elemental layer (flipped space) ---
    # one loop per run of equal NS counts: the program holds a few loop
    # bodies instead of the whole unrolled schedule (compile time)
    carry = (r, t, jp, jm, ek)
    for it, count in ns_runs(ns_schedule):
        carry = lax.fori_loop(0, count, functools.partial(double, it), carry)
    r, t, jp, jm, ek = carry

    d = d_ref[...]
    r2mp = d[:, None] * r                 # un-flip rows
    j2m = d * jm
    sgn = d[:, None] * d[None, :]
    t2mm = sgn * t

    c_rpm = cr_pm_ref[...]
    c_tpp = ct_pp_ref[...]
    c_tmm = ct_mm_ref[...]
    c_jp = cjp_ref[...]

    # --- 2. interaction (ref interaction.jl:69-117), push-through form ---
    m1 = ns_m(eye - mm(r2mp, c_rpm), ni)
    w1 = mm(r2mp, c_tpp)
    v1 = mv(r2mp, c_jp) + j2m
    w2 = mm(c_rpm, t2mm)
    v2 = c_jp + mv(c_rpm, j2m)
    y_a = mm(m1, w1)                      # M1 r2mp c_tpp
    y_t = mm(m1, t2mm)
    y_v = mv(m1, v1)
    y_b = mm(m1, mm(r2mp, w2))
    y_bv = mv(m1, mv(r2mp, v2))

    or_mp[...] = cr_mp_ref[...] + mm(c_tmm, y_a)
    ot_mm[...] = mm(c_tmm, y_t)
    ojm[...] = cjm_ref[...] + mv(c_tmm, y_v)
    ot_pp[...] = mm(t, c_tpp + mm(c_rpm, y_a))
    or_pm[...] = sgn * r2mp + mm(t, w2 + mm(c_rpm, y_b))
    ojp[...] = jp + mv(t, v2 + mv(c_rpm, y_bv))


def _xla_twin_step(comp, r_f, t, jp, jm_f, ek, d_vec, *, ns_schedule, ni):
    """Pure-jnp twin of fused_layer_step (identical algebra; serves as the
    differentiation rule for the forward-only kernel)."""
    from vsmartmom.core.rt import (LayerRT, doubling, interaction,
                                   make_rsolve)
    n_spec, n, _ = r_f.shape
    eye = jnp.broadcast_to(jnp.eye(n, dtype=r_f.dtype), (n_spec, n, n))
    r_f2, t2, jp2, jm_f2 = doubling(r_f, t, jp, jm_f, ek,
                                    len(ns_schedule), eye,
                                    ns_schedule=tuple(ns_schedule))
    dvr = jnp.asarray(d_vec, r_f.dtype)
    r_mp = dvr[None, :, None] * r_f2
    sgn = dvr[None, :, None] * dvr[None, None, :]
    added = LayerRT(r_mp=r_mp, r_pm=sgn * r_mp, t_pp=t2, t_mm=sgn * t2,
                    j_p=jp2, j_m=dvr[None, :] * jm_f2)
    return interaction(comp, added, eye,
                       rsolve=make_rsolve("schulz", int(ni)))


@functools.lru_cache(maxsize=64)
def _fls_differentiable(statics: tuple):
    """custom_jvp wrapper per static configuration: kernel primal, twin
    tangent. Cached so each (schedule, ...) config traces once."""
    statics_d = dict(statics)
    twin_kw = dict(ns_schedule=statics_d["ns_schedule"], ni=statics_d["ni"])
    precision = statics_d.pop("tangent_precision")

    @jax.custom_jvp
    def f(*primals):
        return _fused_layer_step_prim(*primals, **statics_d)

    @f.defjvp
    def f_jvp(primals, tangents):
        out = f(*primals)
        # the rule is traced lazily, outside the caller's precision
        # context: restore it, or the twin's products drop to TF32 on GPU
        with jax.default_matmul_precision(precision):
            _, dout = jax.jvp(lambda *p: _xla_twin_step(*p, **twin_kw),
                              primals, tangents)
        return out, dout

    return f


def fused_layer_step(comp, r_f, t, jp, jm_f, ek, d_vec, *,
                     ns_schedule: tuple, ni: int = 4,
                     interpret: bool = False):
    """One RT layer step: double the elemental (flipped-space) layer and
    compose it under the composite. comp is a LayerRT pytree whose
    operators are (nSpec, M, M) with M = N or M = padded_n(N); r_f/t:
    (nSpec, N, N); jp/jm_f: (nSpec, N); ek: (nSpec,); d_vec: (N,).
    Returns the new composite at the composite's own size M (a caller that
    carries the composite padded across a layer scan pads only once). The
    tangent rule's products run at the matmul precision in force here
    ("highest" if none is set).
    """
    statics = (("ns_schedule", tuple(ns_schedule)), ("ni", int(ni)),
               ("interpret", bool(interpret)),
               ("tangent_precision",
                jax.config.jax_default_matmul_precision or "highest"))
    f = _fls_differentiable(statics)
    # the elemental layer at the composite's size, so that the kernel and
    # its twin (the tangent rule) see one consistent N
    p = comp.r_mp.shape[-1] - r_f.shape[-1]
    mats = [jnp.pad(m, [(0, 0), (0, p), (0, p)]) for m in (r_f, t)]
    vecs = [jnp.pad(v, [(0, 0), (0, p)]) for v in (jp, jm_f)]
    d = jnp.pad(jnp.asarray(d_vec, r_f.dtype), [(0, p)])
    return f(comp, *mats, *vecs, ek, d)


def pad_layer(layer, n_pad: int):
    """Zero-pad a LayerRT's operators and sources from N to n_pad."""
    n = layer.r_mp.shape[-1]
    if n == n_pad:
        return layer
    p = n_pad - n
    return type(layer)(
        *(jnp.pad(x, [(0, 0), (0, p), (0, p)]) for x in layer[:4]),
        *(jnp.pad(v, [(0, 0), (0, p)]) for v in layer[4:]))


def unpad_layer(layer, n: int):
    """Inverse of pad_layer."""
    return type(layer)(*(x[:, :n, :n] for x in layer[:4]),
                       *(v[:, :n] for v in layer[4:]))


@functools.partial(jax.jit, static_argnames=("ns_schedule", "ni",
                                             "interpret"))
def _fused_layer_step_prim(comp, r_f, t, jp, jm_f, ek, d_vec, *,
                           ns_schedule: tuple, ni: int = 4,
                           interpret: bool = False):
    from vsmartmom.core.rt import LayerRT

    n_spec, n, _ = r_f.shape
    n_pad = padded_n(n)
    n_comp = comp.r_mp.shape[-1]
    comp = pad_layer(comp, n_pad)
    mats = [jnp.pad(m, [(0, 0), (0, n_pad - n), (0, n_pad - n)])
            for m in (r_f, t)]
    vecs = [jnp.pad(v, [(0, 0), (0, n_pad - n)]) for v in (jp, jm_f)]
    d = jnp.pad(d_vec, [(0, n_pad - n)])

    mat_spec = pl.BlockSpec((None, n_pad, n_pad), lambda i: (i, 0, 0))
    vec_spec = pl.BlockSpec((None, n_pad), lambda i: (i, 0))
    ek_spec = pl.BlockSpec((None, 1), lambda i: (i, 0))
    d_spec = pl.BlockSpec((n_pad,), lambda i: (0,))
    kern = functools.partial(_layer_step_kernel,
                             ns_schedule=tuple(ns_schedule), ni=int(ni))
    mshape = jax.ShapeDtypeStruct((n_spec, n_pad, n_pad), r_f.dtype)
    vshape = jax.ShapeDtypeStruct((n_spec, n_pad), r_f.dtype)
    out = pl.pallas_call(
        kern,
        grid=(n_spec,),
        in_specs=[mat_spec] * 4 + [vec_spec] * 2
                 + [mat_spec] * 2 + [vec_spec] * 2 + [ek_spec, d_spec],
        out_specs=[mat_spec] * 4 + [vec_spec] * 2,
        out_shape=[mshape] * 4 + [vshape] * 2,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS[n_pad],
                                                num_stages=1),
        interpret=interpret,
        name="fused_layer_step",
    )(*comp, *mats, *vecs, ek.reshape(n_spec, 1), d)
    new = LayerRT(*out)
    return new if n_comp == n_pad else unpad_layer(new, n_comp)
