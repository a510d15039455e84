"""Batched, mesh-sharded pairwise Gram-matrix computation.

Redesign of the reference's KernelMatrix engine
(/root/reference/common/kernel_matrix.{h,cpp}):

- the upper-triangle pair loop with round-robin thread/MPI work splitting
  (kernel_matrix.cpp:21-57, 199-261) becomes a flat pair-index array evaluated
  by SLAB-sized device programs: all pair indices are transferred to device
  once, each dispatch runs `slab_batches` kernel batches inside one jitted
  program (`lax.scan` over batches, gathers on device), and only the (SLAB,)
  result vector crosses back to the host.  Host round trips scale as
  n_pairs / (slab_batches * batch_size), not n_pairs / batch_size;
- with a mesh, each batch is `shard_map`-ped over the pair axis: every device
  gathers its own feature slice and runs the kernel on batch_size/n_devices
  pairs (the reference's MPI rank-striding, as SPMD over the mesh);
- all example features live on device once (stacked padded tensors,
  replicated over the mesh); no host->device traffic scales with N^2;
- cosine normalization K'ij = Kij / sqrt(Kii*Kjj) (kernel_matrix.cpp:560-571);
- diagonal-only and test-rows-vs-train passes, including restriction to
  support-vector columns (CalcDiagonal / CalcTestMatrix,
  kernel_matrix.cpp:59-182).
"""

from __future__ import annotations

from typing import Callable, Mapping

import jax
import jax.numpy as jnp
import numpy as np

Features = Mapping[str, jax.Array]
# kernel_fn(x_batch, y_batch) -> (B,) kernel values; x/y are feature dicts
# whose arrays all share a leading batch axis.
KernelFn = Callable[[Features, Features], jax.Array]


def _exp_to_f32_checked(g: np.ndarray) -> np.ndarray:
    """exp of a log-domain Gram in float64, cast to the float32 interchange
    dtype — warning when the cast overflows, since unnormalized log values
    past ~88 are representable in log space but not in the f32 matrix."""
    out = np.exp(g.astype(np.float64)).astype(np.float32)
    n_inf = int(np.sum(~np.isfinite(out)))
    if n_inf:
        import warnings

        warnings.warn(
            f"{n_inf} unnormalized kernel values exceed float32 range after "
            "exp; use normalize=True (log-space cosine normalization) or "
            "consume the log-domain values directly",
            RuntimeWarning,
            stacklevel=3,
        )
    return out

# (kernel_fn, batch_size, slab_batches, mesh) -> jitted slab program.
# Bounded FIFO so dead engines' compiled programs (and their mesh objects)
# don't accumulate for the process lifetime.
_SLAB_FN_CACHE: dict = {}
_SLAB_FN_CACHE_MAX = 64


class PairKernelEngine:
    """Evaluates a batched pair kernel over stacked example features.

    ``features``: dict of arrays with leading example axis (N, ...), already
    padded to common shapes.  ``kernel_fn`` consumes two gathered feature
    dicts (leading batch axis B) and returns (B,) values.
    """

    def __init__(
        self,
        kernel_fn: KernelFn,
        features: Mapping[str, np.ndarray],
        *,
        batch_size: int = 512,
        slab_batches: int = 16,
        mesh=None,
        log_values: bool = False,
    ) -> None:
        """``log_values``: kernel_fn returns log K instead of K; gram() then
        normalizes in log space — exp(Lij - (Lii + Ljj)/2) — which is exact
        and overflow-safe for kernels whose raw values exceed float range."""
        self.kernel_fn = kernel_fn
        self.mesh = mesh
        self.log_values = log_values
        if mesh is not None:
            n_dev = mesh.size
            batch_size = max(n_dev, (batch_size // n_dev) * n_dev)
        self.batch_size = batch_size
        self._slab_batches = max(1, slab_batches)
        # Slab sizing trades per-slab dispatch overhead (fast kernels want
        # big slabs; the fast-kernel CLIs pass slab_batches=64) against
        # in-flight dispatch overlap for compute-bound kernels (default 16).
        # Slab size costs no memory (the slab program lax.maps per batch
        # internally), only checkpoint granularity.
        self.features = self.stack_features(features)
        self.n = next(iter(self.features.values())).shape[0]
        self._slab_fns: dict[int, Callable] = {}

    # ---------------------------------------------------------------- device

    def stack_features(self, features: Mapping[str, np.ndarray]) -> dict[str, jax.Array]:
        """Features onto device, replicated over the mesh when one is set."""
        if self.mesh is None:
            return {k: jnp.asarray(v) for k, v in features.items()}
        from ..parallel.mesh import replicate

        return replicate(self.mesh, {k: np.asarray(v) for k, v in features.items()})

    def _slab_size(self, n_batches: int) -> int:
        """Batches per slab for a job of ``n_batches``.

        Small problems use an exact-size slab so padding waste stays O(bs);
        bigger slabs are quantized to powers of two (bounded compiled-
        program variety) up to the configured maximum.  Checkpoint layout
        (gram.checkpoint) derives from the same rule, so resume alignment
        is guaranteed."""
        sb = min(self._slab_batches, max(1, n_batches))
        if sb > 16:
            sb = 1 << (sb.bit_length() - 1)  # floor power of two
            # tail padding is REAL compute for compute-bound kernels: shrink
            # the slab until the padded tail is <= 12.5% of the job (medium
            # blocks of the bucketed Gram would otherwise pad up to 80%)
            while sb > 16 and (-n_batches % sb) * 8 > n_batches:
                sb //= 2
        return sb

    def _slab_fn(self, slab_batches: int) -> Callable:
        """Jitted program: evaluate ``slab_batches`` consecutive batches.

        Signature: (feats_x, feats_y, ix_all, iy_all, start) -> (SLAB,) where
        ix_all/iy_all are the FULL device-resident pair lists and ``start`` is
        a traced scalar offset — one compiled program serves every slab.

        Memoized at module level keyed by (kernel_fn, batch, slab, mesh): a
        fresh engine over the same kernel reuses the trace (re-tracing an
        identical program costs ~0.25 s per engine otherwise — it dominated
        short predict runs).
        """
        try:
            key = (self.kernel_fn, self.batch_size, slab_batches, self.mesh)
            hash(key)
        except TypeError:
            key = None
        cache = _SLAB_FN_CACHE if key is not None else self._slab_fns
        if key is None:
            key = slab_batches
        fn = cache.get(key)
        if fn is not None:
            return fn
        bs = self.batch_size
        kernel_fn = self.kernel_fn

        def batch_eval(feats_x, feats_y, bix, biy):
            x = {k: jnp.take(v, bix, axis=0) for k, v in feats_x.items()}
            y = {k: jnp.take(v, biy, axis=0) for k, v in feats_y.items()}
            return kernel_fn(x, y)

        if self.mesh is not None:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            from ..parallel.mesh import PAIR_AXIS

            batch_eval = shard_map(
                batch_eval,
                mesh=self.mesh,
                in_specs=(P(), P(), P(PAIR_AXIS), P(PAIR_AXIS)),
                out_specs=P(PAIR_AXIS),
                check_vma=False,
            )

        def slab(feats_x, feats_y, ix_all, iy_all, start):
            ix = jax.lax.dynamic_slice_in_dim(ix_all, start, slab_batches * bs)
            iy = jax.lax.dynamic_slice_in_dim(iy_all, start, slab_batches * bs)
            ix = ix.reshape(slab_batches, bs)
            iy = iy.reshape(slab_batches, bs)
            vals = jax.lax.map(
                lambda ij: batch_eval(feats_x, feats_y, ij[0], ij[1]), (ix, iy)
            )
            return vals.reshape(-1)

        if self.mesh is not None:
            # Replicate the slab output: the all-gather equivalent of the
            # reference's Ssend/Recv gather to rank 0 (kernel_matrix.cpp:
            # 225-261) — and, in multi-controller runs, the only way every
            # process can fetch the values to host.
            from jax.sharding import NamedSharding, PartitionSpec as P

            fn = jax.jit(slab, out_shardings=NamedSharding(self.mesh, P()))
        else:
            fn = jax.jit(slab)
        if cache is _SLAB_FN_CACHE and len(cache) >= _SLAB_FN_CACHE_MAX:
            cache.pop(next(iter(cache)))
        cache[key] = fn
        return fn

    # ---------------------------------------------------------------- driver

    def run_pairs(
        self,
        ix: np.ndarray,
        iy: np.ndarray,
        feats_x=None,
        feats_y=None,
        checkpoint=None,
    ) -> np.ndarray:
        """Evaluate the kernel on pair lists, slab by slab.

        With ``checkpoint`` (a gram.checkpoint.TileCheckpoint at slab
        granularity), completed slabs are loaded instead of recomputed and
        fresh slabs are stored durably as soon as they land.
        """
        feats_x = self.features if feats_x is None else feats_x
        feats_y = self.features if feats_y is None else feats_y
        if checkpoint is not None and self.mesh is not None:
            import jax as _jax

            if any(d.process_index != _jax.process_index()
                   for d in self.mesh.devices.flat):
                # every rank must dispatch the same collective slab sequence;
                # per-rank checkpoint skips would desynchronize the
                # multi-controller program order (deadlock/corruption), and
                # ranks would truncate each other's memmaps
                raise ValueError(
                    "Gram checkpointing is per-process; it cannot be combined "
                    "with a mesh that spans multiple jax.distributed "
                    "processes — run checkpointed Grams single-host (all "
                    "local devices are fine) or drop --checkpoint"
                )
        n_pairs = len(ix)
        if n_pairs >= 2**31:
            # dynamic_slice offsets are int32 on device; past 2^31 pairs the
            # slab start would wrap negative and silently read wrong pairs.
            raise ValueError(
                f"{n_pairs} pairs exceeds the int32 slab-offset range; "
                "split the Gram into blocks of < 2^31 pairs (~65k examples)"
            )
        bs = self.batch_size
        n_batches = -(-n_pairs // bs)
        sb = self._slab_size(n_batches)
        slab_pairs = sb * bs
        n_slabs = -(-n_pairs // slab_pairs)
        pad = n_slabs * slab_pairs - n_pairs
        ix_all = jnp.asarray(np.concatenate([ix, np.zeros(pad, ix.dtype)]))
        iy_all = jnp.asarray(np.concatenate([iy, np.zeros(pad, iy.dtype)]))
        if self.mesh is not None:
            from ..parallel.mesh import replicate

            ix_all = replicate(self.mesh, ix_all)
            iy_all = replicate(self.mesh, iy_all)
        slab = self._slab_fn(sb)
        out = np.empty(n_slabs * slab_pairs, dtype=np.float32)
        # Dispatch slabs ahead of fetching (JAX async dispatch): device
        # compute, result transfer, and host round trips overlap
        # across slabs.  The in-flight window stays bounded so a huge run
        # never queues an unbounded number of programs.
        WINDOW = 16
        pending: list[tuple[int, object]] = []

        def drain(limit: int) -> None:
            while len(pending) > limit:
                s, dev_vals = pending.pop(0)
                vals = np.asarray(dev_vals)
                out[s * slab_pairs : (s + 1) * slab_pairs] = vals
                if checkpoint is not None:
                    checkpoint.store_batch(s, vals)

        for s in range(n_slabs):
            if checkpoint is not None and checkpoint.is_done(s):
                vals = checkpoint.load_batch(s)
                out[s * slab_pairs : s * slab_pairs + len(vals)] = vals
                continue
            start = jnp.asarray(s * slab_pairs, jnp.int32)
            pending.append((s, slab(feats_x, feats_y, ix_all, iy_all, start)))
            drain(WINDOW)
        drain(0)
        return out[:n_pairs]

    def checkpoint_for(self, path: str, n_pairs: int | None = None,
                       n: int | None = None, extra_features=None):
        """A TileCheckpoint whose batch granularity matches this engine's
        slab size (so resume alignment is guaranteed).  Triangle by default;
        pass ``n_pairs`` for rectangular pair lists.

        The checkpoint meta records a fingerprint of this engine's feature
        arrays (plus ``extra_features``, e.g. the y-side of a rectangular
        block), so resuming against a DIFFERENT corpus that happens to
        produce identically-sized blocks is rejected instead of silently
        returning stale values."""
        from .checkpoint import TileCheckpoint, features_fingerprint

        n = self.n if n is None else n
        total = n * (n + 1) // 2 if n_pairs is None else n_pairs
        n_batches = -(-total // self.batch_size)
        sb = self._slab_size(n_batches)
        fp = features_fingerprint(self.features, extra_features)
        return TileCheckpoint(path, n, sb * self.batch_size, n_pairs=n_pairs,
                              fingerprint=fp)

    # ------------------------------------------------------------------- API

    def gram(self, *, normalize: bool = False, checkpoint_path: str | None = None) -> np.ndarray:
        """Full symmetric N x N Gram matrix (upper triangle computed once).

        ``checkpoint_path`` enables slab-granular checkpoint/resume.
        """
        iu = np.triu_indices(self.n)
        ckpt = None
        if checkpoint_path is not None:
            ckpt = self.checkpoint_for(checkpoint_path)
        vals = self.run_pairs(
            iu[0].astype(np.int32), iu[1].astype(np.int32), checkpoint=ckpt
        )
        g = np.zeros((self.n, self.n), dtype=np.float32)
        g[iu] = vals
        g = g + np.triu(g, 1).T
        if self.log_values:
            if normalize:
                d = np.diag(g)
                return np.exp(g - 0.5 * (d[:, None] + d[None, :])).astype(np.float32)
            # f64 exp for range, but a float32 matrix like every other path
            # (unnormalized log-kernel values can exceed f32 range -> inf,
            # same semantics as a raw overflow-prone kernel)
            return _exp_to_f32_checked(g)
        if normalize:
            g = normalize_gram(g)
        return g

    def diagonal(self, sv_index: np.ndarray | None = None) -> np.ndarray:
        """k(x_i, x_i) for all (or the given subset of) training examples.

        With ``sv_index``, non-SV entries are left 0 (the reference computes
        diagonals only for support vectors at prediction time,
        kernel_matrix.cpp:577-633).
        """
        idx = np.arange(self.n, dtype=np.int32) if sv_index is None else np.asarray(sv_index, np.int32)
        vals = self.run_pairs(idx, idx)
        out = np.zeros(self.n, dtype=np.float32)
        out[idx] = vals
        return out

    def rows(
        self,
        test_features: Mapping[str, np.ndarray],
        *,
        sv_index: np.ndarray | None = None,
        with_self: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Kernel rows K(test_t, train_j) plus self values K(test_t, test_t).

        With ``sv_index``, only support-vector columns are computed (others
        stay 0), matching CalcTestMatrix (kernel_matrix.cpp:112-182).
        Returns (rows: (T, N), self_values: (T,)).

        ``with_self=False`` skips the K(test, test) dispatch and returns
        zeros for the self values — the unnormalized no-norm-file predict
        configuration never reads them, and the extra dispatch doubled its
        cost.
        """
        feats_t = self.stack_features(test_features)
        n_test = next(iter(feats_t.values())).shape[0]
        cols = (
            np.arange(self.n, dtype=np.int32)
            if sv_index is None
            else np.asarray(sv_index, np.int32)
        )
        tt, jj = np.meshgrid(np.arange(n_test, dtype=np.int32), cols, indexing="ij")
        vals = self.run_pairs(tt.ravel(), jj.ravel(), feats_x=feats_t)
        rows = np.zeros((n_test, self.n), dtype=np.float32)
        rows[tt.ravel(), jj.ravel()] = vals
        if not with_self:
            return rows, np.zeros(n_test, dtype=np.float32)
        self_vals = self.run_pairs(
            np.arange(n_test, dtype=np.int32),
            np.arange(n_test, dtype=np.int32),
            feats_x=feats_t,
            feats_y=feats_t,
        )
        return rows, self_vals


def normalize_gram(g: np.ndarray) -> np.ndarray:
    """Cosine normalization K'ij = Kij / sqrt(Kii*Kjj) (kernel_matrix.cpp:560-571)."""
    d = np.sqrt(np.clip(np.diag(g), 1e-300, None))
    return g / np.outer(d, d)


# Backwards-compatible private aliases (pre-round-4 callers)
PairKernelEngine._run_pairs = PairKernelEngine.run_pairs
PairKernelEngine._stack = PairKernelEngine.stack_features
