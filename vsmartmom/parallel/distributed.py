"""Multi-host distribution: jax.distributed init + host-spanning meshes.

The reference is a single-GPU library (SURVEY §5.8: no communication
backend at all); scaling beyond one chip is a new capability of this
framework. The strategy stays the one the physics dictates: the spectral
axis is embarrassingly parallel for elastic RT, so a 1-D mesh over ALL
global devices (hosts x chips) shards nSpec with zero hot-path
collectives; Raman runs add banded cross-spectral permutes that XLA lowers
to neighbor exchanges between devices (halo width = max Raman shift).

The elastic sharded path is ``rt_run_band(..., mesh=)``: each device runs
its own contiguous spectral slice under shard_map (on a GPU in f32, the
fused layer-step kernel on each card's slice). ``band`` stays host (numpy)
arrays, from which rt_run_band builds its static doubling schedules.

One host, several cards (no init):

    from vsmartmom.parallel.sharding import spectral_mesh
    R, T = rt_run_band(pol, quad, band, vza, vaz, max_m, surface,
                       dtype=jnp.float32, mesh=spectral_mesh())

Several hosts, one process each (not yet run on several hosts): the same
call in every process, on the global mesh:

    from vsmartmom.parallel import distributed as dist
    dist.init_multihost(coordinator_address=..., num_processes=...,
                        process_id=...)   # or the JAX_* env variables
    R, T = rt_run_band(..., mesh=dist.global_spectral_mesh())

``process_spectral_slice`` / ``global_spectral_array`` assemble a globally
sharded jax Array from per-process slices, for inputs too large to hold
whole on every host (the Raman path takes such arrays under ``with
mesh:``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vsmartmom.parallel.sharding import SPECTRAL_AXIS

_initialized = False


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed for a multi-host run. Idempotent.

    With no arguments, relies on jax's own cluster auto-detection (SLURM,
    Open MPI) or the standard env vars
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.
    Returns True if a multi-process runtime was (or already is) active,
    False for a plain single-process run (not an error: the same code path
    then runs on the local devices only).
    """
    global _initialized
    if _initialized or jax.process_count() > 1:
        _initialized = True
        return jax.process_count() > 1

    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    # Opt-in: join a cluster only when explicitly addressed (args/env) or
    # forced (VSMARTMOM_MULTIHOST=1 lets jax's auto-detection run). Plain
    # single-host runs must stay single-process.
    want = (coordinator_address is not None or num_processes is not None
            or os.environ.get("VSMARTMOM_MULTIHOST") == "1")
    if not want:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True
    return jax.process_count() > 1


def global_spectral_mesh(devices=None) -> Mesh:
    """1-D spectral mesh over all global devices (every host's chips).

    Device order is jax.devices() order: process-major, so contiguous
    spectral shards live on one host's chips first — any residual
    cross-shard traffic (Raman halos, output gathers) stays between one
    host's cards before it crosses the network.
    """
    devs = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (SPECTRAL_AXIS,))


def process_spectral_slice(n_spec: int, mesh: Mesh) -> Tuple[int, int]:
    """[lo, hi) spectral index range this process's devices own.

    n_spec must divide evenly over the mesh (pad with
    sharding.pad_to_multiple first). Use it so each host only loads /
    computes its own slice of the optical-property inputs.
    """
    n_dev = mesh.devices.size
    if n_spec % n_dev:
        raise ValueError(f"n_spec={n_spec} not divisible by the "
                         f"{n_dev}-device mesh; pad_to_multiple first")
    per = n_spec // n_dev
    mine = [i for i, d in enumerate(mesh.devices.ravel())
            if d.process_index == jax.process_index()]
    if not mine:
        return 0, 0
    assert mine == list(range(mine[0], mine[0] + len(mine))), \
        "mesh devices of one process must be contiguous for slice loading"
    return mine[0] * per, (mine[-1] + 1) * per


def global_spectral_array(local: np.ndarray, mesh: Mesh, axis: int = 0):
    """Assemble a globally-sharded array from per-process local slices.

    ``local`` is this process's [lo, hi) slice along ``axis`` (from
    process_spectral_slice). Single-process: equivalent to a device_put
    with spectral NamedSharding.
    """
    spec = [None] * np.ndim(local)
    spec[axis] = SPECTRAL_AXIS
    sharding = NamedSharding(mesh, P(*spec))
    if jax.process_count() == 1:
        return jax.device_put(local, sharding)
    return jax.make_array_from_process_local_data(sharding, local)
