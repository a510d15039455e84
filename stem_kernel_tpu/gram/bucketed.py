"""Gram assembly over shape-buckets of examples.

The flat engine (gram.engine.PairKernelEngine) pads every example to the
corpus-wide maximum shape; one large outlier then inflates every kernel
evaluation.  Here examples are grouped into geometric shape buckets (see
models.composite.featurize_stem_bucketed) and the Gram is assembled
block-by-block over bucket pairs: each block runs at the pad shapes of its
two buckets only.  The reference pays exact per-example sizes by streaming
C++ objects (/root/reference/common/kernel_matrix.cpp:44-56,
stem_kernel_lite/data.cpp:547-586); geometric buckets are the
equivalent — O(log N) compiled shapes, <= 2x padding waste.

Every kernel in the framework is shape-generic in N_x vs N_y (closure
matmuls, LA/string DPs), so cross-bucket blocks need no shape matching.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np

from .engine import PairKernelEngine, normalize_gram

# bucket: (global example indices, stacked features, aux e.g. iteration bound)
Bucket = tuple[np.ndarray, Mapping[str, np.ndarray], object]


def bucketed_gram(
    buckets: list[Bucket],
    make_kernel_fn: Callable[[object], Callable],
    *,
    normalize: bool = False,
    batch_size: int = 256,
    slab_batches: int = 16,
    mesh=None,
    log_values: bool = False,
    merge_aux: Callable[[object, object], object] = max,
    checkpoint_path: str | None = None,
) -> np.ndarray:
    """Full N x N Gram from bucketed features.

    ``make_kernel_fn(aux)`` builds the batched kernel for a block whose two
    buckets' aux values merge via ``merge_aux`` (default max — correct for
    iteration-count bounds).

    ``checkpoint_path``: directory for per-block slab-granular
    checkpoint/resume (gram.checkpoint.TileCheckpoint); a restarted run
    skips every completed slab of every bucket block.
    """
    import os

    if checkpoint_path is not None:
        os.makedirs(checkpoint_path, exist_ok=True)
    n = sum(len(idx) for idx, _, _ in buckets)
    g = np.zeros((n, n), dtype=np.float32)
    engines: dict[int, PairKernelEngine] = {}

    for p, (idx_p, feats_p, aux_p) in enumerate(buckets):
        for q in range(p, len(buckets)):
            idx_q, feats_q, aux_q = buckets[q]
            kernel_fn = make_kernel_fn(merge_aux(aux_p, aux_q))
            eng = PairKernelEngine(
                kernel_fn, feats_p, batch_size=batch_size,
                slab_batches=slab_batches, mesh=mesh, log_values=log_values,
            )
            ckpt = None
            if checkpoint_path is not None:
                blk = os.path.join(checkpoint_path, f"block_{p}_{q}")
                n_pairs = (len(idx_p) * (len(idx_p) + 1) // 2 if p == q
                           else len(idx_p) * len(idx_q))
                # the y-side features join the fingerprint so a resume
                # against a different corpus with same-sized buckets is
                # rejected rather than silently returning stale values
                ckpt = eng.checkpoint_for(
                    blk, n_pairs=n_pairs, n=len(idx_p),
                    extra_features=None if p == q else feats_q)
            if p == q:
                iu = np.triu_indices(len(idx_p))
                ix, iy = iu[0].astype(np.int32), iu[1].astype(np.int32)
                vals = eng.run_pairs(ix, iy, checkpoint=ckpt)
                g[idx_p[ix], idx_p[iy]] = vals
                g[idx_p[iy], idx_p[ix]] = vals
            else:
                tt, jj = np.meshgrid(
                    np.arange(len(idx_p), dtype=np.int32),
                    np.arange(len(idx_q), dtype=np.int32),
                    indexing="ij",
                )
                vals = eng.run_pairs(
                    tt.ravel(), jj.ravel(), feats_y=eng.stack_features(feats_q),
                    checkpoint=ckpt,
                )
                g[idx_p[tt.ravel()], idx_q[jj.ravel()]] = vals
                g[idx_q[jj.ravel()], idx_p[tt.ravel()]] = vals
    if log_values:
        if normalize:
            d = np.diag(g)
            return np.exp(g - 0.5 * (d[:, None] + d[None, :])).astype(np.float32)
        from .engine import _exp_to_f32_checked

        return _exp_to_f32_checked(g)
    if normalize:
        g = normalize_gram(g)
    return g
