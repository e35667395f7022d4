"""Throughput benchmark on one NVIDIA card.

Headline (the JSON "value"): spectral points/s for a full polarized
3-moment Fourier step loop on the synthetic 20k-point IQUV harness (shape
mirrors the reference GPU harness, ref: test/gpu_tests/gpu_cpu_tests.jl:
Float32, nSpec=20000; here N = 44, 10 layers), production "auto" engine.

extras:
  flagship_*   — the end-to-end default pipeline: default_parameters
      (34-layer atmosphere, O2 A band, 22669 points, aerosol + Rayleigh +
      line-by-line O2) -> model build -> 3-moment rt_run, f32, auto engine.
  voigt_lineval_per_s — tiled Voigt sweep line-point evaluations/s on a
      dense case (the CO2 band, 40001-point grid).
  raman_rrs_*  — rotational Raman (ring effect) throughput.
  flagship_rt_pts_per_s_fixed_ni4 — the flagship with the per-layer
      interaction-NS adaptivity disabled (uniform ni = 4).

Prints ONE JSON line: {"metric", "value", "unit", "device", "extras"}.
Any failed stage fails the run. Without a GPU it exits non-zero.

Env:
  VSM_BENCH_PROFILE=/path  — capture a jax.profiler trace of the headline
      steady-state iterations into that directory.
"""
import json
import os
import sys
import time

import numpy as np


def _sync_time(fn):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def headline():
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as g
    from vsmartmom.core.rt_run import (_fourier_step, build_layer_schedules,
                                       choose_engine)

    n_spec = 20_000
    args, static = g._example_inputs(n_spec=n_spec, n_quad_half=8,
                                     n_stokes=4, n_z=10, dtype=np.float32)
    a = {k: jax.device_put(v) for k, v in args.items()
         if isinstance(v, np.ndarray)}
    n = int(args["qp"].shape[0])

    # static doubling schedules via rt_run_band's OWN builder (uniform
    # layers here -> the single-static-count branch)
    nd, sched, _ls = build_layer_schedules(
        args["tau"], args["omega"], float(args["min_qp_mu"]), "schulz")
    assert nd is not None and sched is not None and _ls is None
    engine = choose_engine(jax.default_backend(), jnp.float32, n, True)

    def run():
        outs = []
        for is_m0 in (True, False, False):
            comp, _ = _fourier_step(
                a["tau"], a["omega"], a["zw"], a["z_pp_c"], a["z_mp_c"],
                a["qp"], a["wt"], a["d_vec"], a["i0_vec"],
                args["albedo"], None, args["mu0"], args["mu0_node"],
                args["min_qp_mu"],
                i_mu0_n=static["i_mu0_n"], n_stokes=static["n_stokes"],
                is_m0=is_m0, n_spec=static["n_spec"], solver="schulz",
                ndoubl_static=nd, ns_schedule=sched, doubling_engine=engine)
            outs.append(comp.j_m)
        return outs

    t_first = _sync_time(run)
    prof_dir = os.environ.get("VSM_BENCH_PROFILE")
    if prof_dir:
        import jax.profiler
        jax.profiler.start_trace(prof_dir)
    n_rep = 5
    dt = min(_sync_time(run) for _ in range(n_rep))
    if prof_dir:
        jax.profiler.stop_trace()
    return {"pts_per_s": round(n_spec / dt, 1), "engine": engine,
            "n": n, "compile_s": round(t_first - dt, 2)}


def flagship():
    """End-to-end default O2 A-band pipeline, f32, auto engine."""
    import jax.numpy as jnp
    from vsmartmom import default_parameters, model_from_parameters, rt_run
    from vsmartmom.core.rt_run import LAST_RUN

    out = {}
    t0 = time.perf_counter()
    params = default_parameters()
    params.float_type = "Float32"
    model = model_from_parameters(params)
    out["flagship_setup_s"] = round(time.perf_counter() - t0, 2)
    n_spec = model.tau_abs[0].shape[0]
    out["flagship_n_spec"] = n_spec

    def run_rt(n_steady=3):
        t_first = _sync_time(lambda: rt_run(model, dtype=jnp.float32))
        t_rt = min(_sync_time(lambda: rt_run(model, dtype=jnp.float32))
                   for _ in range(n_steady))
        R, _ = rt_run(model, dtype=jnp.float32)
        assert np.isfinite(R).all()
        return t_first, t_rt

    t_first, t_rt = run_rt()
    out["flagship_engine"] = f"{LAST_RUN['engine']}/{LAST_RUN['solver']}"
    out["flagship_rt_pts_per_s"] = round(n_spec / t_rt, 1)
    out["flagship_compile_s"] = round(t_first - t_rt, 2)
    out["flagship_o2_aband_pts_per_s"] = round(
        n_spec / (t_rt + out["flagship_setup_s"]), 1)

    prev_ni = os.environ.get("VSM_FIXED_NI")
    os.environ["VSM_FIXED_NI"] = "4"
    try:
        _, t_fixed = run_rt(n_steady=1)
    finally:
        if prev_ni is None:
            os.environ.pop("VSM_FIXED_NI", None)
        else:
            os.environ["VSM_FIXED_NI"] = prev_ni
    out["flagship_rt_pts_per_s_fixed_ni4"] = round(n_spec / t_fixed, 1)
    return out


def raman_rrs():
    """Rotational-Raman (ring-effect) throughput: Cabannes elastic run
    + first-order RRS source coupling across the full +-~194 cm^-1 shift
    range (ref: the reference's RRS path, rt_run.jl + CoreKernel/
    *_inelastic.jl), as spectral points/s on one card."""
    import jax.numpy as jnp
    from vsmartmom.core.rt_raman import rt_run_band_rrs
    from vsmartmom.core.rt_run import BandRTInputs
    from vsmartmom.inelastic.rrs import make_rrs
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    n_spec = 2048
    grid = 12700.0 + 0.25 * np.arange(n_spec)      # 512 cm^-1 span
    rrs = make_rrs(grid, T=250.0)
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.05}
    n_z = 10
    rng = np.random.default_rng(0)
    tau_rayl = np.full((n_z, n_spec), 0.04)
    # absorption lines -> ring-effect configuration (filling-in visible)
    tau_abs = 0.3 * rng.random((n_z, 1)) * np.exp(
        -0.5 * ((grid - 12950.0) / 2.0) ** 2)[None, :]
    tau = tau_rayl + tau_abs
    band = BandRTInputs(
        tau=tau, omega=tau_rayl * rrs.omega_cabannes / tau,
        zw=np.ones((n_z, 1, n_spec)),
        greeks=[get_greek_rayleigh(rrs.depol_rayl)])

    def run():
        out = rt_run_band_rrs(pol, quad, band, rrs, tau_rayl / tau, [30.0],
                              [0.0], 3, surf, dtype=jnp.float32)
        ier = np.asarray(out[2])
        assert np.isfinite(ier).all() and (ier != 0).any()
        return out

    t_warm = _sync_time(run)                   # includes jit compile
    t_steady = _sync_time(run)
    return {"raman_rrs_pts_per_s": round(n_spec / t_steady, 1),
            "raman_rrs_compile_s": round(t_warm - t_steady, 2),
            "raman_rrs_n_spec": n_spec}


def voigt_rate():
    """Tiled Voigt sweep throughput: line-point evaluations/s on the CO2
    band over a 40001-point grid (the O2 A band's ~300 lines are too few
    to load the card)."""
    from vsmartmom.spectroscopy.hitran import read_linelist_npz
    from vsmartmom.spectroscopy.voigt import (line_parameters,
                                              make_hitran_model,
                                              make_voigt_plan)
    npz = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "hitran", "CO2.npz")
    ht = read_linelist_npz(npz, 2)
    model = make_hitran_model(ht, "Voigt")
    grid = 6000.0 + 0.01 * np.arange(40001)
    plan = make_voigt_plan(model, grid)
    pars = [line_parameters(model, 700.0 + 10 * i, 280.0) for i in range(10)]
    _sync_time(lambda: plan.run(*pars[0]))              # compile/warm
    dt = _sync_time(lambda: [plan.run(*p) for p in pars]) / len(pars)
    evals = len(ht.nu) * (2 * model.wing_cutoff / 0.01)
    return {"voigt_lineval_per_s": round(evals / dt, 0)}


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs an NVIDIA GPU, JAX found "
                 f"{dev.platform!r}")
    from vsmartmom.util.compile_cache import enable_compile_cache
    extras = {"compile_cache": enable_compile_cache()}
    head = headline()
    extras["headline_engine"] = head["engine"]
    extras["headline_compile_s"] = head["compile_s"]
    extras.update(voigt_rate())
    extras.update(flagship())
    extras.update(raman_rrs())
    print(json.dumps({
        "metric": "rt_run_spectral_points_per_s",
        "value": head["pts_per_s"],
        "unit": f"spectral-points/s (full 3-moment polarized Fourier "
                f"steps, nSpec=20000, IQUV, N={head['n']}, 10 layers)",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": extras}))


if __name__ == "__main__":
    main()
