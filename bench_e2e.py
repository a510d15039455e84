"""End-to-end pipeline benchmark: fold -> BPLA Gram -> SVM CV AUC.

The "N-seq ncRNA Gram wall time" measurement: synthetic hairpin families vs
dinucleotide shuffles, every stage timed, one JSON line per stage plus a
summary line naming the device.  Exits without a GPU.

Usage: python bench_e2e.py [n_seqs] [seq_len]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main(n_seqs: int = 100, seq_len: int = 100) -> None:
    from stem_kernel_tpu.utils.device import require_gpu

    device = require_gpu()
    rng = np.random.default_rng(0)

    from stem_kernel_tpu.fold.bpmatrix import bpp_for_alignments
    from stem_kernel_tpu.gram.engine import PairKernelEngine
    from stem_kernel_tpu.io.profile import Alignment
    from stem_kernel_tpu.models.bpla import BPLAKernel
    from stem_kernel_tpu.models.featurize import bpla_features
    from stem_kernel_tpu.svm.train import svm_cross_validation
    from stem_kernel_tpu.utils.roc import roc_curve_and_auc
    from stem_kernel_tpu.utils.shuffle import dinucleotide_shuffle
    from stem_kernel_tpu.utils.tracing import StageTimer

    # synthetic data: two hairpin families + shuffles
    def make_family(n, length):
        stem = "".join(rng.choice(list("acgu"), size=length // 3))
        comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
        rc = "".join(comp[c] for c in reversed(stem))
        loop_len = length - 2 * len(stem)
        core = stem + "".join(rng.choice(list("acgu"), size=loop_len)) + rc
        out = []
        for _ in range(n):
            s = list(core)
            for i in range(len(s)):
                if rng.random() < 0.1:
                    s[i] = rng.choice(list("acgu"))
            out.append("".join(s))
        return out

    pos = make_family(n_seqs // 2, seq_len)
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    seqs = pos + neg
    labels = ["+1"] * len(pos) + ["-1"] * len(neg)
    alns = [Alignment(rows=[s]) for s in seqs]

    kernel = BPLAKernel()

    def pipeline(timer: StageTimer):
        with timer.stage("fold", items=len(seqs)):
            bpps = bpp_for_alignments(alns)
        with timer.stage("featurize", items=len(seqs)):
            feats = bpla_features(alns, bpps)
        with timer.stage("gram", items=len(seqs) * (len(seqs) + 1) // 2):
            # log-space evaluation + log-space normalization (overflow-safe)
            eng = PairKernelEngine(
                kernel.log_value, feats, batch_size=512, log_values=True
            )
            g = eng.gram(normalize=True)
        with timer.stage("svm_cv", items=len(seqs)):
            preds = svm_cross_validation(g, labels, 5, C=1.0)
        return preds

    # untimed warmup pass absorbs per-process trace/lower/compile costs so
    # the reported stages measure steady-state throughput
    t_cold = StageTimer()
    pipeline(t_cold)
    t = StageTimer()
    preds = pipeline(t)
    # decision-value AUC via fold models
    y = np.array([1 if l == "+1" else -1 for l in labels])
    acc = float(np.mean([p == l for p, l in zip(preds, labels)]))

    for name in ("fold", "featurize", "gram", "svm_cv"):
        print(json.dumps({
            "stage": name,
            "seconds": round(t.totals[name], 3),
            "items_per_sec": round(t.counts[name] / max(t.totals[name], 1e-9), 2),
        }))
    total = sum(t.totals.values())
    print(json.dumps({
        "metric": "e2e_bpla_pipeline",
        "n_seqs": len(seqs),
        "seq_len": seq_len,
        "total_seconds": round(total, 2),
        "cold_total_seconds": round(sum(t_cold.totals.values()), 2),
        "cv_accuracy": round(acc, 4),
        "device": device,
    }))


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    main(n, L)
