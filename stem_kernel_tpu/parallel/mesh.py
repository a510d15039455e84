"""Mesh construction and sharding helpers.

Device-mesh replacement for the reference's MPI backend
(/root/reference/common/kernel_matrix.cpp:184-483): instead of rank-strided
pair loops with Ssend/Recv gathers to rank 0, the Gram pair axis is sharded
over a device mesh with `NamedSharding`; XLA inserts the collectives, and
results land fully replicated (the all-gather equivalent of the reference's
gather + stride replay).  Rank-0-only I/O (framework.h:135-163) becomes
`jax.process_index() == 0` host writes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PAIR_AXIS = "pairs"


def default_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), (PAIR_AXIS,))


def resolve_mesh(n_devices: int = 0) -> Mesh | None:
    """Mesh for a CLI run: ``n_devices`` = 0 means every global device.

    The reference's binaries ARE the MPI programs — rank setup happens inside
    main() (/root/reference/common/framework.h:418-433); this is the
    device-mesh analogue used by cli.app.run_app.  Returns None (plain
    single-device dispatch, no shard_map) when the resolved device count
    is 1.
    """
    devices = jax.devices()
    if n_devices > 0:
        if n_devices > len(devices):
            raise ValueError(
                f"--devices {n_devices} requested but only "
                f"{len(devices)} JAX devices are visible"
            )
        devices = devices[:n_devices]
    if len(devices) == 1:
        return None
    return Mesh(np.array(devices), (PAIR_AXIS,))


def put(mesh: Mesh, arr, spec: P) -> jax.Array:
    """device_put that also works when ``mesh`` spans multiple processes.

    Multi-controller runs (jax.distributed) cannot ``device_put`` onto
    non-addressable devices; every process holds the same host array, so the
    global array is assembled from per-device callbacks instead (the
    reference ships full buffers to every rank too — the optimizer's Bcast
    merge, /root/reference/bpla_kernel/bpla_optimizer.cpp:85-107).
    """
    sharding = NamedSharding(mesh, spec)
    if sharding.is_fully_addressable:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def shard_pairs(mesh: Mesh, arr: jax.Array) -> jax.Array:
    """Shard the leading (pair-batch) axis of ``arr`` across the mesh."""
    spec = P(PAIR_AXIS, *([None] * (arr.ndim - 1)))
    return put(mesh, arr, spec)


def replicate(mesh: Mesh, tree):
    """Fully replicate a pytree of arrays across the mesh."""
    if not NamedSharding(mesh, P()).is_fully_addressable:
        return jax.tree.map(lambda a: put(mesh, a, P()), tree)
    return jax.device_put(tree, NamedSharding(mesh, P()))


def process_zero() -> bool:
    """True on the host responsible for I/O (MPI rank-0 equivalent)."""
    return jax.process_index() == 0
