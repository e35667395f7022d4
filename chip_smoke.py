"""Smoke test of the O2 A-band forward model on NVIDIA cards.

    python chip_smoke.py          # one card: phases 1-5 below
    python chip_smoke.py --four   # four cards: the sharded paths only

Phases (one card), in one process:
  1. device   — require a GPU; print its kind, count, name and power limit.
  2. flagship — vsmartmom/config/default_parameters.yaml at full width
                (22 669 points, 34 layers, N = 15, 3 moments) in f32 through
                default_parameters -> model_from_parameters -> rt_run with
                the production "auto" engine; build, first (compile) and
                steady rt_run times; the LU and Newton-Schulz solvers and
                the plain XLA engine timed on the same model.
  3. f64      — the same model in f64, XLA engine, exact LU solve: the
                plain reference phase 2 is compared with; a TF32 run of
                the XLA engine as a control every f32 limit must reject.
  4. kernels  — every kept kernel against its XLA twin (and the f64
                reference) at the flagship width and at the synthetic IQUV
                shape of bench.py (N = 44, 20 000 points, 10 layers; and
                N = 32, where the kernel runs on a 32 x 32 block); one
                jax.jvp through the production engine at flagship width;
                the tiled f32 Voigt sweep against the dense f64 one at the
                flagship grid and at a 40 001-point CO2 grid.
  5. raman    — rotational Raman at bench.py's shape (2048 points, full
                shift set), f32 against f64, ie products at "highest" and
                "high" precision.
The last line of standard output is one JSON object; everything else comes
before it. Any failed check exits non-zero. Without a GPU the script exits
non-zero before any phase runs.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

CHECKOUT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = (22669, 34, 15)       # nSpec, nZ, N of default_parameters.yaml
BENCH_N_SPEC = 20_000            # bench.py's synthetic IQUV harness
LOG = []          # (name, measured, limit) of every tolerance check
# f32 limits, max|dR|/max|R| (PERF.md: readings on an H100 beside a TF32
# control that each limit rejects)
FLAGSHIP_TOL = 1.5e-3    # vs the f64 LU run (Natraj I gate 2e-3, tightened)
SAME_SCHED_TOL = 5e-4    # vs f64 running the same schedules / algorithm
TWIN_TOL = 1e-4          # kernel vs its XLA twin, both f32 at "highest"


def say(msg):
    print(msg, flush=True)


def check(name, measured, limit, control=False):
    """Record and print a tolerance check; exit non-zero when it fails. A
    ``control`` (a run known to be wrong) must exceed the limit: it shows
    the limit rejects it."""
    ok = bool(np.isfinite(measured) and measured <= limit) != control
    LOG.append((name, float(measured), float(limit)))
    say(f"  check {name}: {measured:.3e} {'>' if control else '<='} "
        f"{limit:.1e} {'ok' if ok else 'FAILED'}")
    if not ok:
        sys.exit(f"chip_smoke: check {name} failed")


def rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    import jax
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def steady(fn, n=3):
    """(result, first-call seconds, best steady seconds of n)."""
    out, first = timed(fn)
    best = min(timed(fn)[1] for _ in range(n))
    return out, first, best


# --- phase 1 -----------------------------------------------------------------

def phase_device(n_cards):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU, JAX found "
                 f"{devs[0].platform!r}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    say(f"[device] kind={devs[0].device_kind} count={len(devs)} "
        f"nvidia-smi: {' | '.join(smi)}")
    for line in smi[:n_cards]:
        say(line)
    return devs


# --- phase 2 + 3 -------------------------------------------------------------

def phase_flagship():
    import jax.numpy as jnp
    from vsmartmom import default_parameters, model_from_parameters, rt_run
    from vsmartmom.core.rt_run import LAST_RUN

    params = default_parameters()
    params.float_type = "Float32"
    t0 = time.perf_counter()
    model = model_from_parameters(params)
    t_build = time.perf_counter() - t0
    n_spec = model.tau_abs[0].shape[0]
    n_z = model.profile.n_layers
    n = len(model.quad_points.qp_mu_n)
    say(f"[flagship] nSpec={n_spec} nZ={n_z} N={n} "
        f"max_m={params.max_m} build {t_build:.2f} s")
    if (n_spec, n_z, n) != FLAGSHIP:
        sys.exit(f"chip_smoke: flagship shape {(n_spec, n_z, n)}")

    runs = {}
    for tag, kw in (("auto", {}),
                    ("xla_schulz", dict(solver="schulz",
                                        doubling_engine="xla")),
                    ("xla_lu", dict(solver="lu"))):
        (R, _), first, best = steady(lambda: rt_run(model, **kw), n=2)
        runs[tag] = dict(R=R, engine=LAST_RUN["engine"],
                         solver=LAST_RUN["solver"], first=first, steady=best)
        say(f"[flagship] f32 {tag}: engine={LAST_RUN['engine']} "
            f"solver={LAST_RUN['solver']} first {first:.3f} s "
            f"(incl. compile) steady {best:.4f} s")
    auto = runs["auto"]
    say(f"[flagship] production engine that ran: {auto['engine']}/"
        f"{auto['solver']}; rt_run build {t_build:.2f} s, first "
        f"{auto['first']:.3f} s, steady {auto['steady']:.4f} s")
    R32 = auto["R"]
    if not np.isfinite(R32).all():
        sys.exit("chip_smoke: flagship R has non-finite values")
    check("flagship f32 min I (>= 0)", float(-R32[:, 0, :].min()), 0.0)

    # phase 3: the same model in f64, XLA engine, exact LU — the reference
    (R64, _), first64 = timed(lambda: rt_run(
        model, dtype=jnp.float64, solver="lu", doubling_engine="xla"))
    say(f"[f64] engine={LAST_RUN['engine']}/{LAST_RUN['solver']} "
        f"{first64:.3f} s (incl. compile)")
    for tag in runs:
        check(f"flagship f32 {tag} vs f64 max|dR|/max|R|",
              rel(runs[tag]["R"], R64), FLAGSHIP_TOL)
    # the same static Newton-Schulz schedules in f64: separates the f32
    # error from the discretization difference of the quantized schedules
    (R64s, _), first64s = timed(lambda: rt_run(
        model, dtype=jnp.float64, solver="schulz", doubling_engine="xla"))
    say(f"[f64] engine={LAST_RUN['engine']}/{LAST_RUN['solver']} "
        f"{first64s:.3f} s (incl. compile)")
    check("flagship f32 auto vs f64 at the same schedules",
          rel(runs["auto"]["R"], R64s), SAME_SCHED_TOL)
    # control: the XLA engine with its f32 products at TF32, the card's
    # reduced precision; every f32 limit must reject it
    (Rtf, _), first_tf = timed(lambda: rt_run(
        model, solver="schulz", doubling_engine="xla",
        matmul_precision="TF32_TF32_F32"))
    say(f"[control] f32 xla/schulz at TF32: {first_tf:.3f} s (incl. "
        f"compile)")
    check("control TF32 vs f64", rel(Rtf, R64), FLAGSHIP_TOL, control=True)
    check("control TF32 vs f64 at the same schedules", rel(Rtf, R64s),
          SAME_SCHED_TOL, control=True)
    check("control TF32 vs the kernel", rel(Rtf, runs["auto"]["R"]),
          TWIN_TOL, control=True)
    return model, runs


# --- phase 4 -----------------------------------------------------------------

def phase_kernels(model, runs):
    import jax
    import jax.numpy as jnp
    from vsmartmom.core.api import build_band_inputs
    from vsmartmom.core.autodiff import make_radiance_fn
    from vsmartmom.core.rt_run import build_layer_schedules

    # (a) flagship width: kernel engine vs its XLA twin (same schedules)
    if runs["auto"]["engine"] == "pallas_step":
        check("flagship kernel vs XLA twin (f32, highest) max|dR|/max|R|",
              rel(runs["auto"]["R"], runs["xla_schulz"]["R"]), TWIN_TOL)
        say(f"[kernels] flagship rt_run steady: kernel "
            f"{runs['auto']['steady']:.4f} s, XLA "
            f"{runs['xla_schulz']['steady']:.4f} s")

    # (b) bench.py's synthetic IQUV shape (N = 44: "auto" runs the XLA
    # engine there) and the same at N = 32, where the kernel (block 32) is
    # compared with its XLA twin end to end
    for n_quad_half, cases in (
            (8, (("xla", "schulz"), ("xla_dev", "schulz"), ("xla", "lu"))),
            (5, (("xla", "schulz"), ("pallas_step", "schulz")))):
        synthetic_shape(n_quad_half, cases)

    # (c) one jvp through the production engine at flagship width
    band = build_band_inputs(model, 0)
    quad = model.quad_points
    _, _, scheds = build_layer_schedules(band.tau, band.omega,
                                         float(np.min(quad.qp_mu)), "schulz")
    tau = jnp.asarray(band.tau, jnp.float32)
    omega = jnp.asarray(band.omega, jnp.float32)
    zw = jnp.asarray(band.zw, jnp.float32)
    tangents = {}
    for engine in ("pallas_step", "xla"):
        fn = make_radiance_fn(model.pol, quad, band.greeks,
                              model.obs_geom.vza, model.obs_geom.vaz, 1,
                              band.tau.shape[0], band.tau.shape[1],
                              dtype=jnp.float32, solver="schulz",
                              doubling_engine=engine,
                              layer_schedules=scheds)
        (_, dR), t_jvp = timed(lambda: jax.jvp(
            lambda t: fn(t, omega, zw, jnp.float32(0.15)), (tau,),
            (0.01 * tau,)))
        tangents[engine] = np.asarray(dR)
        say(f"[kernels] flagship jvp (max_m=1) {engine}: {t_jvp:.3f} s "
            f"(incl. compile)")
    check("flagship jvp kernel vs XLA max|dT|/max|T|",
          rel(tangents["pallas_step"], tangents["xla"]), TWIN_TOL)

    # (d) the tiled f32 Voigt sweep (the GPU's absorption engine)
    voigt_cases(model)


def synthetic_shape(n_quad_half, cases):
    """bench.py's synthetic IQUV atmosphere (BENCH_N_SPEC points, 10
    layers, 3 moments) at N = 4 * n_quad(n_quad_half): each (engine,
    solver) in f32 against the f64 XLA engine."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as g
    from vsmartmom.core.rt_run import _fourier_step, build_layer_schedules
    args, static = g._example_inputs(n_spec=BENCH_N_SPEC,
                                     n_quad_half=n_quad_half, n_stokes=4,
                                     n_z=10, dtype=np.float32)
    n = args["qp"].shape[0]
    nd, sched, _ = build_layer_schedules(args["tau"], args["omega"],
                                         float(args["min_qp_mu"]), "schulz")
    dev = {k: jax.device_put(v) for k, v in args.items()
           if isinstance(v, np.ndarray)}

    def step(engine, dtype, solver="schulz"):
        a = {k: jnp.asarray(v, dtype) for k, v in dev.items()}

        def run():
            outs = []
            for is_m0 in (True, False, False):
                comp, _ = _fourier_step(
                    a["tau"], a["omega"], a["zw"], a["z_pp_c"], a["z_mp_c"],
                    a["qp"], a["wt"], a["d_vec"], a["i0_vec"],
                    jnp.asarray(args["albedo"], dtype), None,
                    jnp.asarray(args["mu0"], dtype),
                    jnp.asarray(args["mu0_node"], dtype),
                    jnp.asarray(args["min_qp_mu"], dtype),
                    i_mu0_n=static["i_mu0_n"], n_stokes=static["n_stokes"],
                    is_m0=is_m0, n_spec=static["n_spec"], solver=solver,
                    ndoubl_static=nd,
                    ns_schedule=sched if solver == "schulz" else None,
                    doubling_engine=engine)
                outs.append(comp.j_m)
            return outs
        return steady(run)

    ref, _, _ = step("xla", jnp.float64)
    outs = {}
    for engine, solver in cases:
        out, first, best = step(engine, jnp.float32, solver)
        outs[engine, solver] = out
        say(f"[kernels] N={n} nSpec={BENCH_N_SPEC} nZ=10 3 moments "
            f"{engine}/{solver}: first {first:.3f} s steady {best:.4f} s")
        check(f"N={n} {engine}/{solver} f32 vs f64 max|dJ|/max|J|",
              max(rel(o, r) for o, r in zip(out, ref)), SAME_SCHED_TOL)
    if ("pallas_step", "schulz") in outs:
        check(f"N={n} kernel vs XLA twin (f32, highest) max|dJ|/max|J|",
              max(rel(o, r) for o, r in zip(outs["pallas_step", "schulz"],
                                            outs["xla", "schulz"])),
              TWIN_TOL)


def voigt_cases(model):
    import jax
    from vsmartmom import default_parameters
    from vsmartmom.spectroscopy.hitran import read_linelist_npz
    from vsmartmom.spectroscopy.profiles import hitran_artifact, read_linelist
    from vsmartmom.spectroscopy.voigt import (
        VoigtPlan, compute_absorption_cross_section, line_parameters,
        make_hitran_model)

    params = default_parameters()
    grid = np.asarray(params.spec_bands[0], np.float64)
    cut = params.absorption_params.wing_cutoff
    ht = read_linelist(hitran_artifact("O2"), "O2", grid.min() - cut,
                       grid.max() + cut)
    o2 = make_hitran_model(ht, wing_cutoff=cut)
    prof = model.profile
    o2_pars = [line_parameters(o2, float(p), float(t))
               for p, t in zip(prof.p_full, prof.T)]
    co2 = make_hitran_model(read_linelist_npz(
        os.path.join(CHECKOUT, "data", "hitran", "CO2.npz"), 2))
    co2_grid = 6000.0 + 0.01 * np.arange(40001)
    co2_pars = [line_parameters(co2, 700.0 + 10 * i, 280.0)
                for i in range(10)]
    for name, mdl, g, pars in (("O2 flagship grid (34 layers)", o2, grid,
                                o2_pars),
                               ("CO2 40001-pt grid (10 p,T)", co2, co2_grid,
                                co2_pars)):
        plan = VoigtPlan(g, mdl.hitran.nu, mdl.wing_cutoff)
        out, first, best = steady(lambda: [plan.run(*p) for p in pars])
        say(f"[voigt] {name} tiled f32: first {first:.3f} s steady "
            f"{best:.4f} s")
        p_t = ((prof.p_full[0], prof.T[0]) if mdl is o2 else (700.0, 280.0))
        dense = compute_absorption_cross_section(mdl, g, *map(float, p_t))
        check(f"voigt {name} tiled f32 vs dense f64", rel(out[0], dense),
              1e-3)
    jax.clear_caches()


# --- phase 5 -----------------------------------------------------------------

def phase_raman():
    import jax
    import jax.numpy as jnp
    from vsmartmom.core.rt_raman import IE_PRECISION, rt_run_band_rrs
    from vsmartmom.core.rt_run import BandRTInputs
    from vsmartmom.inelastic.rrs import make_rrs
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    n_spec, n_z = 2048, 10
    grid = 12700.0 + 0.25 * np.arange(n_spec)
    rrs = make_rrs(grid, T=250.0)
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.05}
    rng = np.random.default_rng(0)
    tau_rayl = np.full((n_z, n_spec), 0.04)
    tau_abs = 0.3 * rng.random((n_z, 1)) * np.exp(
        -0.5 * ((grid - 12950.0) / 2.0) ** 2)[None, :]
    tau = tau_rayl + tau_abs
    band = BandRTInputs(tau=tau, omega=tau_rayl * rrs.omega_cabannes / tau,
                        zw=np.ones((n_z, 1, n_spec)),
                        greeks=[get_greek_rayleigh(rrs.depol_rayl)])
    args = (pol, quad, band, rrs, tau_rayl / tau, [30.0], [0.0], 3, surf)
    say(f"[raman] nSpec={n_spec} nZ={n_z} shifts={len(rrs.i_shift)}")
    ref = rt_run_band_rrs(*args, dtype=jnp.float64)
    for prec in ("highest", "high"):
        os.environ["VSM_RAMAN_IE_PRECISION"] = prec
        jax.clear_caches()              # the precision is read at trace time
        out, first, best = steady(
            lambda: rt_run_band_rrs(*args, dtype=jnp.float32), n=1)
        say(f"[raman] f32 ie={prec}: first {first:.3f} s steady "
            f"{best:.4f} s ({n_spec / best:.1f} points/s)")
        errs = rel(out[0], ref[0]), rel(out[2], ref[2])
        if prec == IE_PRECISION:        # the shipped default must hold
            check(f"raman ie={prec} R f32 vs f64", errs[0], SAME_SCHED_TOL)
            check(f"raman ie={prec} ieR f32 vs f64", errs[1],
                  SAME_SCHED_TOL)
        else:                           # the candidate is only reported
            say(f"  candidate ie={prec}: R {errs[0]:.3e}, ieR "
                f"{errs[1]:.3e} (limit {SAME_SCHED_TOL:.1e} each)")
    os.environ.pop("VSM_RAMAN_IE_PRECISION")


# --- four cards --------------------------------------------------------------

def phase_four():
    """Flagship band and the Raman halo case sharded over 4 cards, each
    against the single-card run."""
    import glob
    import shutil

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vsmartmom import default_parameters, model_from_parameters
    from vsmartmom.core.api import build_band_inputs
    from vsmartmom.core.rt_raman import rt_run_band_rrs
    from vsmartmom.core.rt_run import LAST_RUN, BandRTInputs, rt_run_band
    from vsmartmom.inelastic.rrs import RRS, greek_raman_coefs
    from vsmartmom.parallel.sharding import SPECTRAL_AXIS, spectral_mesh
    from vsmartmom.scattering.phase import Polarization, get_greek_rayleigh
    from vsmartmom.util.quadrature import rt_set_streams

    mesh = spectral_mesh(4)
    # Raman halo: |shift| 48 against 32 points per shard
    pol = Polarization.from_name("Stokes_I")
    quad = rt_set_streams("GaussQuadFullSphere", 8, 45.0, [0.0], pol.n)
    rng = np.random.default_rng(1)
    n_z, n_spec = 3, 32 * 4
    tau_scat = np.full((n_z, n_spec), 0.1)
    tau = tau_scat + rng.uniform(0.0, 0.4, (n_z, n_spec))
    omega = tau_scat / tau
    rrs = RRS(i_shift=np.array([-48, 48]), w_shift=np.array([0.02, 0.02]),
              omega_cabannes=0.96, greek_raman=greek_raman_coefs(6.0 / 7.0),
              depol_rayl=0.028)
    greeks = [get_greek_rayleigh(0.028)]
    surf = {"type": "LambertianSurfaceScalar", "albedo": 0.1}

    def raman(sharded):
        sh = NamedSharding(mesh, P(None, SPECTRAL_AXIS))
        put = ((lambda x: jax.device_put(jnp.asarray(x, jnp.float32), sh))
               if sharded else (lambda x: jnp.asarray(x, jnp.float32)))
        zw = jnp.ones((n_z, 1, n_spec), jnp.float32)
        if sharded:
            zw = jax.device_put(zw, NamedSharding(
                mesh, P(None, None, SPECTRAL_AXIS)))
        b = BandRTInputs(tau=put(tau), omega=put(omega), zw=zw,
                         greeks=greeks)
        with mesh:
            return rt_run_band_rrs(pol, quad, b, rrs, put(omega * 0.9),
                                   [0.0], [0.0], 2, surf, dtype=jnp.float32)

    one, four = raman(False), raman(True)
    assert np.abs(np.asarray(one[2])).max() > 0
    check("four: raman halo R sharded vs single", rel(four[0], one[0]), 1e-5)
    check("four: raman halo ieR sharded vs single", rel(four[2], one[2]),
          1e-5)

    params = default_parameters()
    model = model_from_parameters(params)
    band = build_band_inputs(model, 0)
    # one Fourier moment: every moment runs the same sharded program shape,
    # and each extra moment parity costs another set of kernel compiles
    args = (model.pol, model.quad_points, band, model.obs_geom.vza,
            model.obs_geom.vaz, 1, params.surfaces[0])
    (R1, _), t1 = timed(lambda: rt_run_band(*args, dtype=jnp.float32))
    eng1 = LAST_RUN["engine"]
    (R4, _), t4 = timed(lambda: rt_run_band(*args, dtype=jnp.float32,
                                            mesh=mesh))
    say(f"[four] flagship (max_m=1) f32 engine={eng1}/{LAST_RUN['engine']} "
        f"1 card "
        f"{t1:.3f} s, 4 cards {t4:.3f} s (first calls, incl. compile)")
    check("four: flagship sharded vs single max|dR|/max|R|", rel(R4, R1),
          1e-5)

    # the compiled sharded step: local shapes only, no all-gather
    n_local = -(-band.tau.shape[1] // 4)
    mods = [open(f).read() for f in glob.glob(
        os.path.join(HLO_DUMP, "*after_optimizations.txt"))]
    sharded = [m for m in mods if ("fused_layer_step" in m or "triton" in m)
               and f"f32[34,{n_local}]" in m]
    if not sharded:
        sys.exit("chip_smoke: no compiled sharded layer-step module found")
    gathers = sum(m.count("all-gather") for m in sharded)
    say(f"[four] sharded layer-step modules: {len(sharded)}, per-card "
        f"spectral slice {n_local}, all-gathers in them: {gathers}")
    check("four: all-gathers in the sharded kernel modules", gathers, 0)
    shutil.rmtree(HLO_DUMP, ignore_errors=True)


HLO_DUMP = os.path.join(CHECKOUT, ".hlo_dump")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    opts = ap.parse_args()
    n_cards = 4 if opts.four else 1
    if opts.four:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_dump_to={HLO_DUMP}"
                                   " --xla_dump_hlo_as_text")
    import jax
    jax.config.update("jax_enable_x64", True)     # phase 3's f64 reference
    devs = phase_device(n_cards)
    sys.path.insert(0, CHECKOUT)
    from vsmartmom.util.compile_cache import enable_compile_cache
    say(f"[setup] compile cache: {enable_compile_cache()}")

    t0 = time.perf_counter()
    if opts.four:
        phase_four()
    else:
        model, runs = phase_flagship()
        phase_kernels(model, runs)
        phase_raman()
    say(f"[done] {len(LOG)} checks passed in "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
