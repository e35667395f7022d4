"""Card-only gates: the Triton-route layer-step kernel compiled for the
GPU (no interpret mode) against its XLA twin, and the GPU engines against
their references. They skip on machines without a
card; see conftest.py for the command that runs them on one."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("n", [15, 16, 32])
def test_layer_step_kernel_compiled_matches_twin(gpu, n):
    from test_pallas_doubling import _composite, _fixture

    from vsmartmom.pallas.layer_step_kernel import (_xla_twin_step,
                                                    fused_layer_step)
    sched, r0, t0, jp, jm, ek, d = _fixture(S=33, n=n, nd=5)
    comp = _composite(33, n, sched, r0, t0, jp, jm, ek, d)
    with jax.default_matmul_precision("highest"):
        ref = _xla_twin_step(comp, r0, t0, jp, jm, ek, d, ns_schedule=sched,
                             ni=4)
    out = fused_layer_step(comp, r0, t0, jp, jm, ek, d, ns_schedule=sched,
                           ni=4)
    for a, b in zip(ref, out):
        rel = float(jnp.abs(a - b).max() / jnp.abs(a).max())
        assert rel < 2e-5, rel


def test_voigt_tiles_on_gpu_match_dense(gpu):
    from test_pallas_voigt import _dense_truth, _rand_problem

    from vsmartmom.spectroscopy.voigt import VoigtPlan
    grid, nu, S, gd, yv = _rand_problem()
    got = np.asarray(VoigtPlan(grid, nu, 10.0).run(nu, S, gd, yv))
    dense = _dense_truth(grid, nu, S, gd, yv, 10.0)
    assert np.abs(got - dense).max() / dense.max() < 5e-4


def test_rt_run_band_auto_runs_kernel_on_gpu(gpu):
    """f32 "auto" on the card runs the fused kernel and matches the XLA
    engine at the same schedules."""
    from vsmartmom.core.rt_run import (LAST_RUN, BandRTInputs,
                                       rt_run_band)
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 20, 60.0, [0.0, 30.0],
                          pol.n)
    rng = np.random.default_rng(0)
    n_z, n_spec = 6, 257
    tau_scat = (np.array([1e-4, 1e-3, 0.01, 0.05, 0.3, 1.0])[:, None]
                * np.ones((1, n_spec)))
    tau = tau_scat + rng.uniform(0, 0.3, (n_z, n_spec))
    band = BandRTInputs(tau=tau, omega=tau_scat / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(0.0)])
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.15}
    args = (pol, quad, band, [0.0, 30.0], [0.0, 0.0], 3, surf)
    R_k, _ = rt_run_band(*args, dtype=jnp.float32)
    assert LAST_RUN["engine"] == "pallas_step"
    R_x, _ = rt_run_band(*args, dtype=jnp.float32, solver="schulz",
                         doubling_engine="xla")
    assert np.abs(R_k - R_x).max() < 1e-4 * np.abs(R_x).max()
