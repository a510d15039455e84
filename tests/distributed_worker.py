"""Worker process for tests/test_distributed.py.

Usage: python distributed_worker.py <coordinator_port> <process_id> <num_procs> <outdir>

Each worker initializes jax.distributed (the device-mesh equivalent of the
reference's MPI::Init, /root/reference/common/framework.h:418-433), builds a
global 2-process x 4-device CPU mesh, computes a sharded pair-kernel batch
(the Gram engine's decomposition: pair indices sharded over the mesh,
features replicated), and writes the replicated result — from process 0
ONLY, matching the reference's rank-0 I/O (framework.h:135-163).
"""

import os
import sys


def main() -> int:
    port, pid, nproc, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from stem_kernel_tpu.parallel.distributed import initialize

    initialize(coordinator=f"localhost:{port}", num_processes=nproc, process_id=pid)
    assert jax.process_index() == pid
    assert jax.device_count() == 4 * nproc, jax.device_count()
    assert jax.local_device_count() == 4

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stem_kernel_tpu.parallel.mesh import PAIR_AXIS, default_mesh, process_zero

    mesh = default_mesh()  # all 8 global devices
    n = 16
    feats = (np.arange(n * 3, dtype=np.float32) % 7).reshape(n, 3)
    iu = np.triu_indices(n)
    ix = iu[0].astype(np.int32)
    iy = iu[1].astype(np.int32)
    pad = (-len(ix)) % (4 * nproc)
    ix_p = np.pad(ix, (0, pad))
    iy_p = np.pad(iy, (0, pad))

    shard = NamedSharding(mesh, P(PAIR_AXIS))
    # every process holds the full index arrays; each device materializes
    # only its own shard (the reference's rank-strided decomposition,
    # kernel_matrix.cpp:199-261, without any explicit rank arithmetic)
    gix = jax.make_array_from_callback(ix_p.shape, shard, lambda idx: ix_p[idx])
    giy = jax.make_array_from_callback(iy_p.shape, shard, lambda idx: iy_p[idx])
    gfeats = jax.make_array_from_callback(
        feats.shape, NamedSharding(mesh, P()), lambda idx: feats[idx]
    )

    @jax.jit
    def pair_kernel(f, a, b):
        return jnp.sum(jnp.take(f, a, axis=0) * jnp.take(f, b, axis=0), axis=-1)

    out = jax.jit(
        pair_kernel, out_shardings=NamedSharding(mesh, P())
    )(gfeats, gix, giy)
    vals = np.asarray(out)[: len(ix)]

    # reference: single-device computation of the same pairs
    want = (feats[ix] * feats[iy]).sum(-1)
    np.testing.assert_allclose(vals, want, rtol=1e-6)

    # process-0-only I/O
    if process_zero():
        np.save(os.path.join(outdir, "gram_vals.npy"), vals)
        with open(os.path.join(outdir, f"wrote_p{pid}.marker"), "w") as f:
            f.write("ok")
    print(f"worker {pid}: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
