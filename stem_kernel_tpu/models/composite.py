"""The stem_kernel_lite kernel family: stem (+ string) compositions.

Reimplements the named kernels of
/root/reference/stem_kernel_lite/def_kernel.h:

- SuStemKernel        RIBOSUM stem kernel
- SiStemKernel        match/mismatch stem kernel
- SuStemStrKernel     stem + profile string kernel (AddKernel)
- SiStemStrKernel     simple variants of both, summed
- LSuStemKernel       beta * log(stem)
- LSuStemStrKernel    beta * log(stem) + alpha * log(string)

plus the example featurization that turns parsed alignments into the stacked
padded tensors the batched kernels consume (fold -> DAG -> closures; profile
tensors + loop-profile weights for the string part).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from ..fold.bpmatrix import BPMatrixOptions, bpp_for_alignments, fold_sequences, average_bpp
from ..io.alphabet import N_RNA
from ..io.profile import Alignment, profile_from_alignment
from . import combinators
from .dag import build_dag, closure_features, dag_operators
from .stem_kernel import StemKernel
from .string_kernel import StringKernel


@dataclass
class StemLiteConfig:
    """Flag surface of stem_kernel_lite (main.cpp:100-163 defaults)."""

    th: float = 0.01  # --basepair
    beta: float = 0.3  # stem RIBOSUM weight
    loop_gap: float = 0.2
    stack: float = 1.3  # --no-ribosum match
    covar: float = 0.8  # --no-ribosum mismatch
    len_band: int = 10
    alpha: float = 0.2  # string RIBOSUM weight
    gap: float = 0.8  # string gap
    str_match: float = 1.0
    str_mismatch: float = 0.8
    no_ribosum: bool = False
    no_string: bool = False
    use_log: bool = False
    bp_opts: BPMatrixOptions = field(default_factory=BPMatrixOptions)
    node_pad_multiple: int = 16
    len_pad_multiple: int = 8
    # float32 matmul precision of the closure fixed point
    # (models/stem_kernel.py:PRECISIONS); "highest" is the full-f32
    # validation mode (--precision highest).
    precision: str = "high"


def build_stem_dags(alignments: list[Alignment], config: StemLiteConfig):
    """Fold every alignment row (batched on device) and build the DAGs."""
    flat_rows: list[str] = []
    spans: list[tuple[int, int]] = []
    for a in alignments:
        rows = a.ungapped_rows()
        spans.append((len(flat_rows), len(rows)))
        flat_rows.extend(rows)
    row_bpps = fold_sequences(flat_rows, config.bp_opts)

    dags = []
    for a, (start, cnt) in zip(alignments, spans):
        bpps = row_bpps[start : start + cnt]
        avg = average_bpp(a, bpps)
        dags.append(build_dag(a, avg, bpps, th=config.th))
    return dags


def _pack_stem_features(
    alignments: list[Alignment],
    dags,
    config: StemLiteConfig,
    n_pad: int,
    lmax: int,
) -> dict[str, np.ndarray]:
    """Stacked feature dict for the given examples at the given pad shapes."""
    dag_feats = [dag_operators(d, config.loop_gap, n_pad) for d in dags]
    stacked: dict[str, np.ndarray] = {
        k: np.stack([f[k] for f in dag_feats]) for k in dag_feats[0]
    }
    # gap-closure + root-reach solves: batched unit-triangular solves on
    # device instead of per-example host LAPACK
    feats = closure_features(stacked)

    if not config.no_string:
        prof = np.zeros((len(alignments), lmax, N_RNA), np.float32)
        wts = np.zeros((len(alignments), lmax), np.float32)
        lens = np.zeros(len(alignments), np.int32)
        for i, (a, d) in enumerate(zip(alignments, dags)):
            p = profile_from_alignment(a)
            L = p.shape[0]
            base = p[:, :N_RNA]
            tot = base.sum(axis=1, keepdims=True)
            prof[i, :L] = np.where(tot > 0, base / np.where(tot > 0, tot, 1.0), 0.0)
            wts[i, :L] = d.pos_weight  # loop profiles weight the string kernel
            lens[i] = L
        feats["str_profile"] = prof
        feats["str_weight"] = wts
        feats["str_length"] = lens
    return feats


def featurize_stem_examples(
    alignments: list[Alignment], config: StemLiteConfig
) -> tuple[dict[str, np.ndarray], int]:
    """(stacked feature dict, match-iteration bound) for a set of examples.

    Folds every alignment row (batched on device), builds structure DAGs
    host-side, and packs closure matrices + profile/weight tensors padded to
    the shared maxima.
    """
    dags = build_stem_dags(alignments, config)
    mult = config.node_pad_multiple
    n_pad = max(mult, -(-max(d.n_nodes for d in dags) // mult) * mult)
    iters = max(d.depth for d in dags) + 1
    lmult = config.len_pad_multiple
    lmax = max(lmult, -(-max(a.length for a in alignments) // lmult) * lmult)
    return _pack_stem_features(alignments, dags, config, n_pad, lmax), iters


def _bucket_ceil(v: int, mult: int) -> int:
    """Smallest mult * 2^k >= v — geometric buckets bound padding waste at 2x
    while keeping the number of distinct compiled shapes O(log max)."""
    b = mult
    while b < v:
        b *= 2
    return b


def featurize_stem_bucketed(
    alignments: list[Alignment], config: StemLiteConfig
) -> list[tuple[np.ndarray, dict[str, np.ndarray], int]]:
    """Bucketed featurization: examples grouped by DAG node count.

    Returns a list of (example_indices, feature dict, iters) buckets, each
    padded to ITS OWN geometric node/length bound, so one 300-node outlier
    no longer inflates every example's closure tensors (the reference
    streams per-example exact-size DAGs,
    /root/reference/common/kernel_matrix.cpp:44-56).  Cross-bucket kernel
    evaluation works because every kernel is shape-generic in N_x vs N_y.
    """
    dags = build_stem_dags(alignments, config)
    mult = config.node_pad_multiple
    lmult = config.len_pad_multiple
    groups: dict[int, list[int]] = {}
    for i, d in enumerate(dags):
        groups.setdefault(_bucket_ceil(max(d.n_nodes, 1), mult), []).append(i)
    buckets = []
    for n_pad in sorted(groups):
        idx = np.asarray(groups[n_pad], np.int64)
        alns = [alignments[i] for i in idx]
        dgs = [dags[i] for i in idx]
        lmax = _bucket_ceil(max(a.length for a in alns), lmult)
        iters = max(d.depth for d in dgs) + 1
        buckets.append((idx, _pack_stem_features(alns, dgs, config, n_pad, lmax), iters))
    return buckets


def make_stem_lite_kernel_fn(config: StemLiteConfig, iters: int):
    """Batched kernel_fn(x, y) -> (B,) for the configured kernel composition.

    Mirrors the 4-way kernel selection of stem_kernel_lite/main.cpp:176-215.
    """
    if config.no_ribosum:
        stem = StemKernel(
            loop_gap=config.loop_gap, beta=None,
            stack=config.stack, covar=config.covar, len_band=config.len_band,
            precision=config.precision,
        )
    else:
        stem = StemKernel(
            loop_gap=config.loop_gap, beta=config.beta,
            len_band=config.len_band, precision=config.precision,
        )
    if not config.no_string:
        if config.no_ribosum:
            string = StringKernel(config.gap, match=config.str_match,
                                  mismatch=config.str_mismatch)
        else:
            string = StringKernel(config.gap, alpha=config.alpha)

    def kernel_fn(x, y):
        sv = stem(x, y, iters=iters)
        if config.no_string:
            return combinators.weighted_log(sv, config.beta) if config.use_log else sv
        tv = string(
            x["str_profile"], x["str_length"], y["str_profile"], y["str_length"],
            x["str_weight"], y["str_weight"],
        )
        if config.use_log:
            return combinators.add(
                combinators.weighted_log(sv, config.beta),
                combinators.weighted_log(tv, config.alpha),
            )
        return combinators.add(sv, tv)

    return kernel_fn
