"""1000-seq ncRNA benchmark, end to end.

fold -> stem-lite featurize -> Gram with slab checkpointing (sharded over
every visible GPU via the CLI-default mesh) -> 5-fold stratified SVM CV ->
ROC AUC.  Exits without a GPU.

Positives: mutated structured families (the bench_500 seeds); negatives:
dinucleotide-preserving shuffles of the positives (the reference's
negative-control protocol, utils/dishuffle.rb).

Prints one JSON line: {"metric": "e2e_1000_wall_s", ...} plus stage times.

Usage: python bench_1000.py [n_seqs]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from bench_500 import make_dataset


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    half = n // 2
    rng = np.random.default_rng(7)

    from stem_kernel_tpu.utils.shuffle import dinucleotide_shuffle

    pos = make_dataset(half, seed=1)
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    seqs = pos + neg
    labels = ["+1"] * half + ["-1"] * (n - half)
    print(f"{n} seqs, lengths {min(map(len, seqs))}-{max(map(len, seqs))}",
          file=sys.stderr)

    from stem_kernel_tpu.gram.bucketed import bucketed_gram
    from stem_kernel_tpu.io.profile import Alignment
    from stem_kernel_tpu.models.composite import (
        StemLiteConfig, featurize_stem_bucketed, make_stem_lite_kernel_fn,
    )
    from stem_kernel_tpu.parallel.distributed import initialize
    from stem_kernel_tpu.parallel.mesh import resolve_mesh
    from stem_kernel_tpu.svm.train import svm_train, svm_predict_values
    from stem_kernel_tpu.utils.device import require_gpu
    from stem_kernel_tpu.utils.roc import roc_curve_and_auc

    device = require_gpu()
    initialize()
    mesh = resolve_mesh(0)
    t_start = time.time()

    # ---- fold + featurize (includes the McCaskill BPP pass); the shape-
    # bucketed pipeline the CLI uses ----
    t0 = time.time()
    cfg = StemLiteConfig()
    buckets = featurize_stem_bucketed([Alignment(rows=[s]) for s in seqs], cfg)
    t_feat = time.time() - t0

    # ---- bucketed Gram with per-block slab checkpointing ----
    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "gram_ckpt")
        g = bucketed_gram(
            buckets, lambda aux: make_stem_lite_kernel_fn(cfg, aux),
            normalize=True, batch_size=256, mesh=mesh, checkpoint_path=ck,
        )
        n_ck = len(os.listdir(ck))
    t_gram = time.time() - t0

    # ---- 5-fold stratified CV with decision values -> AUC ----
    t0 = time.time()
    fold_of = np.empty(n, dtype=np.int64)
    nxt = 0
    for cls in ("+1", "-1"):
        idx = rng.permutation(np.flatnonzero(np.asarray(labels, object) == cls))
        for i in idx:
            fold_of[i] = nxt % 5
            nxt += 1
    dec = np.zeros(n)
    for f in range(5):
        test = np.flatnonzero(fold_of == f)
        train = np.setdiff1d(np.arange(n), test)
        model = svm_train(g[np.ix_(train, train)],
                          [labels[i] for i in train], C=1.0)
        for t in test:
            _, d = svm_predict_values(model, g[t, train])
            dec[t] = d[0]
    y = np.asarray([1 if l == "+1" else -1 for l in labels])
    auc, _ = roc_curve_and_auc(y, dec)
    t_svm = time.time() - t0

    wall = time.time() - t_start
    print(json.dumps({
        "metric": "e2e_1000_wall_s",
        "value": round(wall, 1),
        "unit": f"s ({n} seqs: fold+featurize -> checkpointed Gram "
                f"({n*(n+1)//2} pairs) -> 5-fold SVM CV -> AUC; "
                f"{'1 device' if mesh is None else f'{mesh.size}-device mesh'})",
        "device": device,
        "extras": {
            "feat_s": round(t_feat, 1),
            "gram_s": round(t_gram, 1),
            "svm_cv_s": round(t_svm, 1),
            "cv_auc": round(float(auc), 4),
            "checkpoint_files": n_ck,
        },
    }))


if __name__ == "__main__":
    main()
