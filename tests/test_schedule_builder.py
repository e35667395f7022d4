"""The production static-schedule builder + the flagship schulz decision
path on a heterogeneous 34-layer profile (the exact configuration whose
breakage shipped round 3: rt_run_band -> build_layer_schedules ->
per-layer (ndoubl, NS-doubling-schedule, NS-interaction-iters) 3-tuples).

ref gate model: the reference runs its default 34-layer profile through
rt_run.jl:41-230 unconditionally in CI; here the equivalent decision path
must at minimum construct, compile, and agree with the exact-LU solver.
"""
import numpy as np
import pytest


def _flagship_like_band(n_z=34, n_spec=16, seed=0):
    from vsmartmom.core.rt_run import BandRTInputs
    from vsmartmom.scattering.phase import get_greek_rayleigh

    rng = np.random.default_rng(seed)
    tau_scat = (0.25 * np.exp(np.linspace(-8.0, 0.0, n_z))[:, None]
                * np.ones((1, n_spec)))
    tau_abs = (tau_scat * 0.1
               + np.exp(rng.uniform(-9.0, 2.0, (n_z, n_spec))) * 0.05)
    tau = tau_scat + tau_abs
    return BandRTInputs(tau=tau, omega=tau_scat / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.028)])


def test_build_layer_schedules_flagship_shape():
    """34-layer wide-spread profile -> per-layer 3-tuple schedules with a
    bounded bucket count and engaged interaction-iteration adaptivity."""
    from vsmartmom.core.rt_run import build_layer_schedules

    band = _flagship_like_band()
    nd, sched, ls = build_layer_schedules(band.tau, band.omega, 0.06,
                                          "schulz")
    assert nd is None and sched is None
    assert ls is not None and len(ls) == 34
    for nd_z, sched_z, ni_z in ls:           # 3-tuple format, all consumers
        assert isinstance(nd_z, int) and nd_z >= 1 and nd_z % 4 == 0
        assert len(sched_z) == nd_z
        assert isinstance(ni_z, int) and 0 <= ni_z <= 4
    # compile cap: at most 6 distinct (nd, sched, ni) combinations
    assert len(set(ls)) <= 6
    # thin upper atmosphere needs fewer interaction NS iterations than the
    # thick bottom (the adaptivity lever) — engaged unless the cap's
    # collapse to a single global schedule fired
    nis = [e[2] for e in ls]
    assert nis[0] <= nis[-1]
    assert min(nis) < 4 or len(set(ls)) == 1


def test_build_layer_schedules_uniform_and_lu():
    from vsmartmom.core.rt_run import build_layer_schedules

    tau = np.full((5, 8), 0.3)
    omega = np.full((5, 8), 0.9)
    nd, sched, ls = build_layer_schedules(tau, omega, 0.06, "schulz")
    assert isinstance(nd, int) and ls is None and len(sched) == nd
    nd2, sched2, ls2 = build_layer_schedules(tau, omega, 0.06, "lu")
    assert nd2 == nd and sched2 is None and ls2 is None
    # traced inputs degrade to the traced-ndoubl path, never raise
    import jax.numpy as jnp
    assert build_layer_schedules(jnp.asarray(tau), jnp.asarray(omega),
                                 0.06, "schulz") == (None, None, None)


def test_ns_interaction_iters_bounds():
    from vsmartmom.core.rt import ns_interaction_iters

    ni = ns_interaction_iters([1e-6, 1e-3, 0.1, 1.0, 5.0], 0.06)
    assert ni[0] == 0                    # vacuum composite -> A = I exactly
    assert list(ni) == sorted(ni) or max(ni) == ni[-1]
    assert ni[-1] <= 4
    # a single thick layer below a thick stack needs the full count
    assert ns_interaction_iters([5.0, 5.0], 0.06)[1] == 4


def test_rt_run_band_schulz_heterogeneous_34_layers():
    """THE flagship decision path on CPU: rt_run_band with solver='schulz'
    on a 34-layer heterogeneous profile routes through the per-layer
    bucketed XLA engine (3-tuple schedules incl. interaction-NS
    adaptivity) and agrees with exact batched LU to f32 levels."""
    import jax.numpy as jnp
    from vsmartmom.core.rt_run import rt_run_band
    from vsmartmom.scattering.phase import Polarization
    from vsmartmom.util.quadrature import rt_set_streams

    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 45.0, [30.0], pol.n)
    band = _flagship_like_band(n_spec=8)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.15}
    R_lu, _ = rt_run_band(pol, quad, band, [30.0], [0.0], 3, surf,
                          solver="lu")
    R_ns, _ = rt_run_band(pol, quad, band, [30.0], [0.0], 3, surf,
                          dtype=jnp.float32, solver="schulz")
    # schulz quantizes ndoubl up (finer elemental slab) — differences are
    # f32 rounding + elemental truncation of the f64 LU baseline, well
    # inside the 6SV1 gate (0.6%)
    assert np.isfinite(R_ns).all()
    assert np.abs(R_ns - R_lu).max() / np.abs(R_lu).max() < 2e-3


def test_interaction_ni_adaptivity_matches_full_count():
    """The adaptive per-layer interaction NS counts change nothing vs the
    fixed ni=4 everywhere (residuals held below f32 rounding by design)."""
    import jax.numpy as jnp
    from vsmartmom.core import rt_run as rr
    from vsmartmom.core.rt_run import rt_run_band
    from vsmartmom.scattering.phase import Polarization
    from vsmartmom.util.quadrature import rt_set_streams

    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 10, 45.0, [30.0], pol.n)
    band = _flagship_like_band(n_spec=8)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.15}
    kw = dict(dtype=jnp.float32, solver="schulz", doubling_engine="xla")
    R_ad, _ = rt_run_band(pol, quad, band, [30.0], [0.0], 3, surf, **kw)

    orig = rr.build_layer_schedules

    def fixed_ni(tau, omega, mqm, solver):
        nd, sched, ls = orig(tau, omega, mqm, solver)
        if ls is not None:
            ls = tuple(e[:2] + (4,) for e in ls)
        return nd, sched, ls

    rr.build_layer_schedules = fixed_ni
    try:
        R_4, _ = rt_run_band(pol, quad, band, [30.0], [0.0], 3, surf, **kw)
    finally:
        rr.build_layer_schedules = orig
    assert np.abs(R_ad - R_4).max() / np.abs(R_4).max() < 1e-6


if __name__ == "__main__":
    import sys
    sys.exit(pytest.main([__file__, "-q"]))
