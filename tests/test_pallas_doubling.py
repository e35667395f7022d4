"""Fused layer-step kernel gates (Triton route, interpret mode on CPU).

The kernel holds one spectral point's doubling recursion and interaction
on-chip (see vsmartmom/pallas/layer_step_kernel.py); these gates pin it
against its XLA twin, through rt_run_band, and pin the engine and solver
choice rules. The compiled kernel on the card is covered by the gpu-marked
tests in test_chip.py and by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vsmartmom.core.rt import LayerRT, ns_doubling_schedule, vacuum_layer
from vsmartmom.pallas.layer_step_kernel import (_xla_twin_step,
                                                fused_layer_step, padded_n)


def _fixture(S=40, n=16, nd=6, seed=0):
    """Passive elemental-like slab (sub-stochastic r, t ~ attenuated I)."""
    rng = np.random.default_rng(seed)
    tau_scat, mqm = 0.5, 0.2
    sched = ns_doubling_schedule(tau_scat, mqm, nd)
    dtau = tau_scat / 2 ** nd
    r0 = jnp.asarray(rng.uniform(0, 1, (S, n, n)) * dtau / (n * mqm),
                     jnp.float32)
    t0 = jnp.asarray(
        np.broadcast_to(np.eye(n) * np.exp(-dtau / mqm), (S, n, n)).copy()
        + rng.uniform(0, 1, (S, n, n)) * dtau / (2 * n * mqm), jnp.float32)
    jp = jnp.asarray(rng.uniform(0, dtau, (S, n)), jnp.float32)
    jm = jnp.asarray(rng.uniform(0, dtau, (S, n)), jnp.float32)
    ek = jnp.full((S,), np.exp(-dtau / 0.7), jnp.float32)
    d = np.ones(n, np.float32)
    d[n // 2:] = -1.0                       # exercise the D-flip signs
    return sched, r0, t0, jp, jm, ek, jnp.asarray(d)


def _composite(S, n, sched, r0, t0, jp, jm, ek, d):
    """A non-trivial composite: one XLA layer step on a vacuum."""
    with jax.default_matmul_precision("highest"):
        return _xla_twin_step(vacuum_layer(S, n, jnp.float32), r0, t0, jp,
                              jm, ek, d, ns_schedule=sched, ni=4)


def test_rt_run_band_pallas_step_engine_matches_xla():
    """Full rt_run_band with the fused doubling+interaction layer-step
    kernel (doubling_engine='pallas_step_interpret') == 'xla'."""
    from vsmartmom.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [10.0], pol.n)
    rng = np.random.default_rng(1)
    n_spec, n_z = 24, 3
    tau_r = np.full((n_z, n_spec), 0.08)
    tau = tau_r + rng.uniform(0, 0.3, (n_z, n_spec))
    band = BandRTInputs(tau=tau, omega=tau_r / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.03)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    kw = dict(dtype=jnp.float32, solver="schulz")
    R_x, T_x = rt_run_band(pol, quad, band, [10.0], [30.0], 2, surf,
                           doubling_engine="xla", **kw)
    R_p, T_p = rt_run_band(pol, quad, band, [10.0], [30.0], 2, surf,
                           doubling_engine="pallas_step_interpret", **kw)
    np.testing.assert_allclose(R_p, R_x, rtol=2e-5, atol=1e-9)
    np.testing.assert_allclose(T_p, T_x, rtol=2e-5, atol=1e-9)


def test_fused_layer_step_per_layer_schedules():
    """Per-layer static (ndoubl, NS-schedule) path (engaged for real
    profiles whose doubling counts spread widely, e.g. the 34-layer
    flagship): fused interpret-mode kernels == f64 XLA reference."""
    import jax.numpy as jnp
    from vsmartmom.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    pol = Polarization.from_name("Stokes_IQU")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 45.0, [0.0, 30.0],
                          pol.n)
    rng = np.random.default_rng(0)
    n_z, n_spec = 6, 8
    tau_scat = (np.array([1e-4, 1e-3, 0.01, 0.05, 0.3, 1.0])[:, None]
                * np.ones((1, n_spec)))
    tau = tau_scat + rng.uniform(0, 0.3, (n_z, n_spec))
    band = BandRTInputs(tau=tau, omega=tau_scat / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.028)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    R64, _ = rt_run_band(pol, quad, band, [0.0, 30.0], [0.0, 90.0], 3, surf)
    R32, _ = rt_run_band(pol, quad, band, [0.0, 30.0], [0.0, 90.0], 3, surf,
                         dtype=jnp.float32, solver="schulz",
                         doubling_engine="pallas_step_interpret")
    # same-discretization cross-engine agreement: the XLA engine now runs
    # the identical quantized per-layer schedules (rt_run.py), so kernel vs
    # jnp differ only by f32 rounding/association
    R32x, _ = rt_run_band(pol, quad, band, [0.0, 30.0], [0.0, 90.0], 3,
                          surf, dtype=jnp.float32, solver="schulz",
                          doubling_engine="xla")
    assert np.abs(R32 - R32x).max() / np.abs(R64).max() < 1e-5
    # physical sanity vs f64 (different discretization: the quantized nd
    # path takes MORE doubling steps, i.e. a finer elemental slab — the
    # ~1e-3 difference is elemental truncation of the f64 baseline, well
    # inside the 6SV1 gate)
    assert np.abs(R32 - R64).max() / np.abs(R64).max() < 2e-3




@pytest.mark.parametrize("n_spec", [7, 16])
@pytest.mark.parametrize("n", [15, 16, 44])
def test_fused_layer_step_interpret_matches_twin(n, n_spec):
    """Kernel (interpret mode, N zero-padded to 16/64) == its XLA twin on
    a non-trivial composite, for ragged and even spectral counts."""
    sched, r0, t0, jp, jm, ek, d = _fixture(S=n_spec, n=n, nd=5)
    comp = _composite(n_spec, n, sched, r0, t0, jp, jm, ek, d)
    with jax.default_matmul_precision("highest"):
        ref = _xla_twin_step(comp, r0, t0, jp, jm, ek, d, ns_schedule=sched,
                             ni=4)
    out = fused_layer_step(comp, r0, t0, jp, jm, ek, d, ns_schedule=sched,
                           ni=4, interpret=True)
    for name, a, b in zip(LayerRT._fields, ref, out):
        assert b.shape == a.shape, name
        rel = np.abs(np.asarray(a) - np.asarray(b)).max() \
            / np.abs(np.asarray(a)).max()
        assert rel < 2e-5, (name, rel)


def test_fused_layer_step_carries_padded_composite():
    """A composite passed at the padded size comes back padded, with the
    padding still zero, and equals the unpadded call on the real block."""
    from vsmartmom.pallas.layer_step_kernel import pad_layer, unpad_layer
    n, S = 15, 5
    sched, r0, t0, jp, jm, ek, d = _fixture(S=S, n=n, nd=4)
    comp = _composite(S, n, sched, r0, t0, jp, jm, ek, d)
    kw = dict(ns_schedule=sched, ni=3, interpret=True)
    out = fused_layer_step(comp, r0, t0, jp, jm, ek, d, **kw)
    outp = fused_layer_step(pad_layer(comp, padded_n(n)), r0, t0, jp, jm,
                            ek, d, **kw)
    assert outp.r_mp.shape == (S, 16, 16)
    assert float(jnp.abs(outp.t_pp[:, n:, :]).max()) == 0.0
    for a, b in zip(out, unpad_layer(outp, n)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("n, expect", [(1, 16), (15, 16), (16, 16),
                                       (17, 32), (44, 64), (63, 64)])
def test_padded_n(n, expect):
    assert padded_n(n) == expect


@pytest.mark.parametrize("sched, expect", [
    ((), ()),
    ((4,), ((4, 1),)),
    ((0, 0, 1, 1, 1, 2, 4, 4), ((0, 2), (1, 3), (2, 1), (4, 2))),
    ((3, 2, 3), ((3, 1), (2, 1), (3, 1))),
])
def test_ns_runs(sched, expect):
    """The kernel loops over runs of equal NS counts, in schedule order."""
    from vsmartmom.pallas.layer_step_kernel import ns_runs
    assert ns_runs(sched) == expect


def test_fused_layer_step_jvp_matches_twin():
    """custom_jvp: kernel primal + twin tangent == jvp of the twin."""
    n, S = 15, 6
    sched, r0, t0, jp, jm, ek, d = _fixture(S=S, n=n, nd=4)
    comp = _composite(S, n, sched, r0, t0, jp, jm, ek, d)
    rng = np.random.default_rng(9)
    dr = jnp.asarray(rng.normal(size=r0.shape) * 1e-3, jnp.float32)
    djp = jnp.asarray(rng.normal(size=jp.shape) * 1e-3, jnp.float32)

    def kern(r, j):
        return fused_layer_step(comp, r, t0, j, jm, ek, d,
                                ns_schedule=sched, ni=4, interpret=True)

    def twin(r, j):
        with jax.default_matmul_precision("highest"):
            return _xla_twin_step(comp, r, t0, j, jm, ek, d,
                                  ns_schedule=sched, ni=4)

    p_k, t_k = jax.jvp(kern, (r0, jp), (dr, djp))
    p_t, t_t = jax.jvp(twin, (r0, jp), (dr, djp))
    for a, b in zip(t_t, t_k):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6,
                                   atol=1e-7 * float(jnp.abs(a).max()))
    for a, b in zip(p_t, p_k):
        rel = float(jnp.abs(a - b).max() / jnp.abs(a).max())
        assert rel < 2e-5


def test_pallas_step_without_schedules_raises():
    """The kernel needs static NS schedules: asking for it under the LU
    solver fails loudly instead of switching engines."""
    from vsmartmom.core.rt_run import BandRTInputs, rt_run_band
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 45.0, [10.0], pol.n)
    n_z, n_spec = 4, 4
    tau = np.array([1e-4, 1e-2, 0.3, 1.0])[:, None] * np.ones((1, n_spec))
    band = BandRTInputs(tau=tau, omega=np.full_like(tau, 0.9),
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.03)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.2}
    with pytest.raises(ValueError, match="schedules"):
        rt_run_band(pol, quad, band, [10.0], [30.0], 1, surf,
                    dtype=jnp.float32, solver="lu",
                    doubling_engine="pallas_step_interpret")


@pytest.mark.parametrize("backend, dtype, n, scheduled, expect", [
    ("gpu", jnp.float32, 15, True, "pallas_step"),
    ("gpu", jnp.float32, 16, True, "pallas_step"),
    ("gpu", jnp.float32, 17, True, "pallas_step"),
    ("gpu", jnp.float32, 32, True, "pallas_step"),
    ("gpu", jnp.float32, 33, True, "xla"),
    ("gpu", jnp.float32, 44, True, "xla"),
    ("gpu", jnp.float32, 15, False, "xla"),
    ("gpu", jnp.float64, 15, True, "xla"),
    ("cpu", jnp.float32, 15, True, "xla"),
    ("cpu", jnp.float64, 15, True, "xla"),
])
def test_choose_engine(backend, dtype, n, scheduled, expect):
    from vsmartmom.core.rt_run import choose_engine
    assert choose_engine(backend, dtype, n, scheduled) == expect


@pytest.mark.parametrize("backend, expect", [("cpu", "lu"),
                                             ("gpu", "schulz")])
def test_default_solver(backend, expect):
    from vsmartmom.core.rt_run import default_solver
    assert default_solver(backend) == expect


def test_rt_run_band_reports_engine():
    """rt_run_band records the engine and solver it ran (auto on the CPU:
    the XLA engine with exact LU)."""
    from vsmartmom.core.rt_run import LAST_RUN, BandRTInputs, rt_run_band
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 6, 45.0, [10.0], pol.n)
    band = BandRTInputs(tau=np.full((2, 3), 0.1), omega=np.full((2, 3), 0.9),
                        zw=np.ones((2, 1, 3)),
                        greeks=[get_greek_rayleigh(0.03)])
    rt_run_band(pol, quad, band, [10.0], [30.0], 1,
                {"type": "LambertianSurfaceScalar", "albedo": 0.2})
    assert LAST_RUN == {"engine": "xla", "solver": "lu"}


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, recursively."""
    def subs(v):
        if isinstance(v, jax.extend.core.ClosedJaxpr):
            return [v.jaxpr]
        if isinstance(v, jax.extend.core.Jaxpr):
            return [v]
        if isinstance(v, (tuple, list)):
            return [j for x in v for j in subs(x)]
        return []

    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in subs(list(eqn.params.values())):
            out += _dot_precisions(sub)
    return out


def test_jvp_tangent_keeps_callers_precision():
    """The custom_jvp rule is traced lazily, outside the caller's
    default_matmul_precision context; its XLA-twin products must still
    carry the caller's precision (else they run as TF32 on the GPU)."""
    n, S = 15, 3
    sched, r0, t0, jp, jm, ek, d = _fixture(S=S, n=n, nd=2)
    comp = _composite(S, n, sched, r0, t0, jp, jm, ek, d)

    @jax.jit
    @jax.default_matmul_precision("highest")
    def f(r):
        return fused_layer_step(comp, r, t0, jp, jm, ek, d,
                                ns_schedule=sched, ni=2, interpret=True)

    jaxpr = jax.make_jaxpr(lambda r: jax.jvp(f, (r,), (r,)))(r0).jaxpr
    precs = _dot_precisions(jaxpr)
    assert precs, "no products traced"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precs
               if not isinstance(p, jax.lax.DotAlgorithmPreset)), precs
