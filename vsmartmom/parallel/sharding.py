"""Spectral-axis sharding across device meshes.

The hyperspectral dimension (nSpec) is embarrassingly parallel for elastic RT
(zero cross-wavelength coupling; ref SURVEY §2.7): every array in the RT core
is batch-leading over nSpec, so ``rt_run_band(..., mesh=spectral_mesh())``
runs each device's slice under shard_map with no collectives on the hot
path. (Raman inelastic runs add a banded cross-nu coupling handled by halo
exchange — see vsmartmom/inelastic.)

This replaces the reference's single-GPU CUBLAS batching with XLA SPMD; the
reference has no multi-device path at all (SURVEY §5.8).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SPECTRAL_AXIS = "spec"


def spectral_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the spectral axis."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device spectral mesh but only "
                f"{len(devs)} JAX devices are visible (set XLA_FLAGS="
                f"--xla_force_host_platform_device_count=N for CPU tests)")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (SPECTRAL_AXIS,))


def pad_to_multiple(x: np.ndarray, m: int, axis: int = 0):
    """Pad axis length up to a multiple of m (edge-replicate padding keeps
    padded wavelengths numerically benign). Returns (padded, orig_len)."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge"), n


def shard_spectral(x, mesh: Mesh, axis: int = 0):
    """Place an array with sharding along its spectral axis."""
    spec = [None] * np.ndim(x)
    spec[axis] = SPECTRAL_AXIS
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))
