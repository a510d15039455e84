"""Multi-host bootstrap and scaling-efficiency measurement.

The device-mesh replacement for the reference's MPI process model
(MPIState RAII, /root/reference/common/framework.h:418-433; mpirun rank
spawning):

- :func:`initialize` wires `jax.distributed` when launched across hosts
  (JAX coordinator env or explicit args); single-process runs are no-ops.
  One process drives all the GPUs of its host;
- :func:`global_mesh` builds a 1-D mesh over every device of every
  process — Gram pair tiles shard across it.  The GPUs of one host are
  joined all to all by NVLink, so the mesh follows the algorithm (one
  data-parallel pair axis), not a topology; XLA hands its collectives to
  NCCL;
- :func:`scaling_efficiency` measures strong-scaling efficiency of a
  batched kernel on 1..n devices.
"""

from __future__ import annotations

import time

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize when multi-host; silently no-op otherwise.

    Launch contract (the mpirun-analogue): set ``JAX_COORDINATOR_ADDRESS``
    (host:port) plus, when auto-detection does not apply,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` in each process's
    environment — every shipped CLI calls this at startup
    (cli.app.run_app), so the binaries themselves are the multi-host
    programs, like the reference's MPI mains
    (/root/reference/common/framework.h:418-433).
    Re-initialization (e.g. two run_app calls in one process) is a no-op.
    """
    import os

    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return
    env = os.environ
    if coordinator is None and num_processes is None:
        if "JAX_COORDINATOR_ADDRESS" not in env:
            return  # single host
        coordinator = env["JAX_COORDINATOR_ADDRESS"]
        if num_processes is None and "JAX_NUM_PROCESSES" in env:
            num_processes = int(env["JAX_NUM_PROCESSES"])
        if process_id is None and "JAX_PROCESS_ID" in env:
            process_id = int(env["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "pairs") -> Mesh:
    """1-D mesh over every device of every host (pair-parallel Gram tiles)."""
    return Mesh(np.array(jax.devices()), (axis,))


def scaling_efficiency(kernel_fn, feats_fn, batch_per_device: int,
                       device_counts: list[int] | None = None,
                       reps: int = 3) -> dict[int, float]:
    """Strong-scaling throughput per device count.

    ``feats_fn(batch_size)`` builds a feature batch; ``kernel_fn(x, y)``
    evaluates it.  Returns {n_devices: pairs_per_sec}.
    """
    devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= len(devices)]
    out: dict[int, float] = {}
    for nd in device_counts:
        mesh = Mesh(np.array(devices[:nd]), ("pairs",))
        bsz = batch_per_device * nd
        x, y = feats_fn(bsz)
        spec = NamedSharding(mesh, P("pairs"))
        x = {k: jax.device_put(v, spec) for k, v in x.items()}
        y = {k: jax.device_put(v, spec) for k, v in y.items()}
        fn = jax.jit(kernel_fn)
        np.asarray(fn(x, y))  # compile
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            np.asarray(fn(x, y))
            best = min(best, time.perf_counter() - t0)
        out[nd] = bsz / best
    return out
