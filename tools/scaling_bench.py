"""Spectral-scaling harness: rt_run throughput at 1..N devices.

Measures the full polarized Fourier-step pipeline (XLA engine) with nSpec
sharded over meshes of increasing size and reports per-mesh throughput and
scaling efficiency vs linear. It is a harness for a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/scaling_bench.py

(SCALING_CPU=1 sets up the same mesh from inside the process.) Times from
it are CPU times, not device numbers; chip_smoke.py --four is the path
that runs the sharded model on cards.

Weak scaling: the per-device spectral load is held constant
(n_spec = SPEC_PER_DEV * n_dev) — more devices, more wavelengths.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SPEC_PER_DEV = int(os.environ.get("SCALING_SPEC_PER_DEV", "4096"))


def main():
    import jax
    # SCALING_CPU=1: set up the virtual CPU mesh from inside the process
    if os.environ.get("SCALING_CPU") == "1":
        n_virt = int(os.environ.get("SCALING_CPU_DEVICES", "8"))
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", n_virt)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vsmartmom.parallel import distributed as dist
    from vsmartmom.parallel.sharding import SPECTRAL_AXIS
    from vsmartmom.core.rt_run import _fourier_step
    import __graft_entry__ as g

    dist.init_multihost()
    all_devs = jax.devices()
    sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= len(all_devs)]
    dtype = np.float32
    rows = []

    for n_dev in sizes:
        mesh = dist.global_spectral_mesh(all_devs[:n_dev])
        n_spec = SPEC_PER_DEV * n_dev
        args, static = g._example_inputs(n_spec=n_spec, n_quad_half=8,
                                         n_stokes=4, n_z=10, dtype=dtype)
        sh2 = NamedSharding(mesh, P(None, SPECTRAL_AXIS))
        sh3 = NamedSharding(mesh, P(None, None, SPECTRAL_AXIS))
        rep = NamedSharding(mesh, P())
        tau = jax.device_put(args["tau"], sh2)
        omega = jax.device_put(args["omega"], sh2)
        zw = jax.device_put(args["zw"], sh3)
        rest = {k: jax.device_put(args[k], rep)
                for k in ("z_pp_c", "z_mp_c", "qp", "wt", "d_vec", "i0_vec")}

        def run(is_m0):
            comp, _ = _fourier_step(
                tau, omega, zw, rest["z_pp_c"], rest["z_mp_c"], rest["qp"],
                rest["wt"], rest["d_vec"], rest["i0_vec"],
                args["albedo"], None, args["mu0"], args["mu0_node"],
                args["min_qp_mu"],
                i_mu0_n=static["i_mu0_n"], n_stokes=static["n_stokes"],
                is_m0=is_m0, n_spec=n_spec, solver="schulz")
            return comp.j_m

        with mesh:
            float(run(True).sum())          # compile + sync
            float(run(False).sum())
            n_rep = 3
            t0 = time.perf_counter()
            for _ in range(n_rep):
                o = run(True), run(False), run(False)
            float(sum(x.sum() for x in o))
            dt = (time.perf_counter() - t0) / n_rep

        pts = n_spec / dt
        rows.append(dict(n_devices=n_dev, n_spec=n_spec,
                         pts_per_s=round(pts, 1),
                         pts_per_s_per_dev=round(pts / n_dev, 1)))

    base = rows[0]["pts_per_s_per_dev"]
    for r in rows:
        r["scaling_efficiency"] = round(r["pts_per_s_per_dev"] / base, 3)
    out = dict(backend=jax.default_backend(),
               process_count=jax.process_count(),
               spec_per_device=SPEC_PER_DEV, rows=rows)

    # On a VIRTUAL mesh (n devices emulated on one machine's cores) the
    # weak-scaling efficiency above is meaningless — total work grows n x
    # on fixed hardware, so per-device throughput must fall ~n x. What a
    # virtual mesh CAN measure is the SPMD partitioning overhead: the same
    # total spectral load, unsharded vs sharded across all devices. It
    # canNOT measure ICI bandwidth/latency (host memory stands in for the
    # interconnect) — real multi-chip efficiency needs a real slice.
    if os.environ.get("SCALING_CPU") == "1" and len(all_devs) > 1:
        n_dev = len(all_devs)
        n_spec = SPEC_PER_DEV * n_dev
        mesh1 = dist.global_spectral_mesh(all_devs[:1])
        meshN = dist.global_spectral_mesh(all_devs)
        times = {}
        for tag, mesh in (("single", mesh1), ("sharded", meshN)):
            args, static = g._example_inputs(n_spec=n_spec, n_quad_half=8,
                                             n_stokes=4, n_z=10,
                                             dtype=dtype)
            sh2 = NamedSharding(mesh, P(None, SPECTRAL_AXIS))
            sh3 = NamedSharding(mesh, P(None, None, SPECTRAL_AXIS))
            rep = NamedSharding(mesh, P())
            tau = jax.device_put(args["tau"], sh2)
            omega = jax.device_put(args["omega"], sh2)
            zw = jax.device_put(args["zw"], sh3)
            rest = {k: jax.device_put(args[k], rep)
                    for k in ("z_pp_c", "z_mp_c", "qp", "wt", "d_vec",
                              "i0_vec")}

            def run_fixed(is_m0):
                comp, _ = _fourier_step(
                    tau, omega, zw, rest["z_pp_c"], rest["z_mp_c"],
                    rest["qp"], rest["wt"], rest["d_vec"], rest["i0_vec"],
                    args["albedo"], None, args["mu0"], args["mu0_node"],
                    args["min_qp_mu"],
                    i_mu0_n=static["i_mu0_n"],
                    n_stokes=static["n_stokes"], is_m0=is_m0,
                    n_spec=n_spec, solver="schulz")
                return comp.j_m

            with mesh:
                float(run_fixed(True).sum())
                t0 = time.perf_counter()
                for _ in range(3):
                    o = run_fixed(True)
                float(o.sum())
                times[tag] = (time.perf_counter() - t0) / 3
        out["partition_overhead"] = dict(
            n_devices=n_dev, n_spec=n_spec,
            t_single_s=round(times["single"], 3),
            t_sharded_s=round(times["sharded"], 3),
            overhead_frac=round(times["sharded"] / times["single"] - 1.0,
                                3),
            note="same total load unsharded vs sharded on the virtual "
                 "mesh: SPMD partitioning cost only; says nothing about "
                 "ICI bandwidth")
    if jax.process_index() == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
