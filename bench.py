"""Benchmark: kernel throughput on one NVIDIA GPU, ONE JSON line.

Headline metric: stem-DP kernel pairs/s — the DAG closure-matmul stem kernel
(/root/reference/stem_kernel_lite/stem_kernel.cpp:14-95 is the reference's
hottest loop).  `vs_baseline` divides by a MEASURED single-core NumPy
evaluation of the same recursion on the same DAGs (tests/stem_oracle.py):
the reference repo publishes no numbers of its own, so the oracle timing is
the baseline.

`extras` carries the secondary throughputs with their own measured
baselines: the BPLA local-alignment kernel as the bpla_kernel CLI runs it
(/root/reference/bpla_kernel/bpla_kernel.cpp:64-115) vs a NumPy cell-by-cell
DP (tests/reference_dp.py), the McCaskill fold engine in seqs/s, and the
banded full stem kernel.

Methodology: K kernel evaluations are chained INSIDE one jit — each
iteration gathers a rotated set of pairs, so no two iterations are elidable
duplicates — so one dispatch covers K calls; the scalar result is fetched
to force completion, and median/min/max over repeated runs are reported.
The output names the device and the card's power limit; without a GPU the
script exits instead of measuring the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))

N_SEQS = 32
SEQ_LEN = 100
STEM_BATCH = 256
STEM_CHAIN = 8
BPLA_BATCH = 512
BPLA_LEN = 128
BPLA_CHAIN = 64
FOLD_BATCH = 128


def _hairpins(rng, n, length):
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    out = []
    for _ in range(n):
        stem = "".join(rng.choice(list("acgu"), size=length // 3))
        rc = "".join(comp[c] for c in reversed(stem))
        mid = "".join(rng.choice(list("acgu"), size=length - 2 * len(stem)))
        out.append(stem + mid + rc)
    return out


def _time_stats(fn, reps=5):
    """(median, min, max) wall time over ``reps`` runs."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], ts[0], ts[-1]


def _rate_stats(work, fn, reps=5):
    """{median/min/max} of work/time as a rate dict."""
    med, lo, hi = _time_stats(fn, reps)
    return {"median": work / med, "max": work / lo, "min": work / hi}


def _time_best(fn, reps=5):
    return _time_stats(fn, reps)[1]


def bench_stem(seqs):
    """(pairs/s on the card, pairs/s single-core NumPy oracle, pairs/s at
    --precision highest)."""
    from stem_kernel_tpu.io.profile import Alignment
    from stem_kernel_tpu.models.composite import StemLiteConfig, featurize_stem_examples
    from stem_kernel_tpu.models.stem_kernel import StemKernel, subst_co_table

    cfg = StemLiteConfig(no_string=True)
    alns = [Alignment(rows=[s]) for s in seqs]
    feats, iters = featurize_stem_examples(alns, cfg)
    dev = {k: jnp.asarray(v) for k, v in feats.items()}
    stem = StemKernel(loop_gap=cfg.loop_gap, beta=cfg.beta,
                      len_band=cfg.len_band, precision=cfg.precision)
    stem_exact = StemKernel(loop_gap=cfg.loop_gap, beta=cfg.beta,
                            len_band=cfg.len_band, precision="highest")

    rng = np.random.default_rng(1)
    ix0 = jnp.asarray(rng.integers(0, len(seqs), STEM_BATCH).astype(np.int32))
    iy0 = jnp.asarray(rng.integers(0, len(seqs), STEM_BATCH).astype(np.int32))
    n = len(seqs)

    def make_chained(kern):
        @jax.jit
        def chained(feats, ix0, iy0):
            def body(k, acc):
                # rotate the pair set every iteration: distinct gathers, so
                # XLA cannot collapse the chain into one evaluation
                ix = (ix0 + k) % n
                iy = (iy0 + 2 * k + 1) % n
                x = {kk: jnp.take(v, ix, axis=0) for kk, v in feats.items()}
                y = {kk: jnp.take(v, iy, axis=0) for kk, v in feats.items()}
                return acc + kern(x, y, iters=iters).sum()

            return jax.lax.fori_loop(0, STEM_CHAIN, body, jnp.float32(0))
        return chained

    chained = make_chained(stem)
    float(chained(dev, ix0, iy0))  # compile + warmup
    chip_rate = _rate_stats(STEM_BATCH * STEM_CHAIN,
                            lambda: float(chained(dev, ix0, iy0)))
    chained_x = make_chained(stem_exact)
    float(chained_x(dev, ix0, iy0))
    exact_rate = _rate_stats(STEM_BATCH * STEM_CHAIN,
                             lambda: float(chained_x(dev, ix0, iy0)))

    # measured single-core baseline: the same recursion, cell by cell
    from stem_kernel_tpu.fold.bpmatrix import bpp_for_alignment, fold_sequences
    from stem_kernel_tpu.models.dag import build_dag
    from stem_oracle import stem_kernel_ref

    co = subst_co_table(cfg.beta)
    dags = []
    for s in seqs[:3]:
        aln = Alignment(rows=[s])
        bpps = fold_sequences([s])
        dags.append(build_dag(aln, bpp_for_alignment(aln), bpps, th=cfg.th))
    pairs = [(0, 1), (1, 2), (0, 2)]
    t0 = time.perf_counter()
    for a, b in pairs:
        stem_kernel_ref(dags[a], dags[b], co, cfg.loop_gap, len_band=cfg.len_band)
    oracle_rate = len(pairs) / (time.perf_counter() - t0)
    return chip_rate, oracle_rate, exact_rate


def bench_bpla():
    """(pairs/s on the card, pairs/s single-core NumPy oracle).

    Times ``BPLAKernel.log_value``, the path the bpla_kernel CLI ships: on
    a GPU the Triton kernel (ops/la_triton.py) on factored scores.
    """
    from stem_kernel_tpu.models.bpla import BPLAKernel

    rng = np.random.default_rng(0)
    kern = BPLAKernel()
    prof = rng.dirichlet(np.ones(4), size=(BPLA_BATCH, BPLA_LEN)).astype(np.float32)
    pl_ = rng.uniform(0, 0.7, (BPLA_BATCH, BPLA_LEN)).astype(np.float32)
    pr = rng.uniform(0, 0.7, (BPLA_BATCH, BPLA_LEN)).astype(np.float32)
    pu = np.sqrt(np.clip(1.0 - pl_**2 - pr**2, 0, None))
    d = {"profile": jnp.asarray(prof), "p_left": jnp.asarray(pl_),
         "p_right": jnp.asarray(pr), "p_unpair": jnp.asarray(pu),
         "length": jnp.full((BPLA_BATCH,), BPLA_LEN, jnp.int32)}

    @jax.jit
    def chained(d):
        def body(k, acc):
            # rotate the y side every iteration so no call is a duplicate
            y = {kk: jnp.roll(v, k + 1, axis=0) for kk, v in d.items()}
            return acc + kern.log_value(d, y).sum()

        return jax.lax.fori_loop(0, BPLA_CHAIN, body, jnp.float32(0))

    float(chained(d))
    chip_rate = _rate_stats(BPLA_BATCH * BPLA_CHAIN, lambda: float(chained(d)))

    from reference_dp import bpla_exp_ref

    x1 = {k: np.asarray(v[:1]) for k, v in d.items()}
    S = np.asarray(kern.scores(x1, x1)[0], np.float64)
    t0 = time.perf_counter()
    for _ in range(2):
        bpla_exp_ref(S, kern.beta, kern.gap, kern.ext)
    oracle_rate = 2 / (time.perf_counter() - t0)
    return chip_rate, oracle_rate


FS_N = 300
FS_BAND = 16
FS_BATCH = 8
FS_CHAIN = 4


def bench_full_stem():
    """Banded full O(n^4) stem kernel pairs/s at n=m=300, band=16 — the
    windowed-memory XLA scan the stem_kernel CLI runs for -b
    (reference stem_kernel/stem_kernel.cpp:165-246), with log-valued
    scaled states (raw f32 overflows at this regime).
    """
    from stem_kernel_tpu.models.full_stem import (
        full_stem_kernel_banded_log, pair_weights,
    )

    rng = np.random.default_rng(5)
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    codes = np.zeros((FS_BATCH, FS_N), np.uint8)
    bp = np.zeros((FS_BATCH, FS_N, FS_N), np.float32)
    for b in range(FS_BATCH):
        stem = rng.integers(0, 4, FS_N // 3)
        rc = np.array([comp[int(c)] for c in stem[::-1]], np.uint8)
        mid = rng.integers(0, 4, FS_N - 2 * len(stem))
        c = np.concatenate([stem, mid, rc]).astype(np.uint8)
        codes[b] = c
        bp[b] = pair_weights(c, FS_N)
    lx = jnp.full((FS_BATCH,), FS_N, jnp.int32)
    dx = jnp.asarray(codes)
    dbp = jnp.asarray(bp)

    rolls = [(jnp.roll(dx, k + 1, axis=0), jnp.roll(dbp, k + 1, axis=0))
             for k in range(FS_CHAIN)]

    def run_once():
        vs = [full_stem_kernel_banded_log(dx, yc, lx, lx, dbp, ybp,
                                          0.8, 1.0, 0.5, band=FS_BAND)
              for yc, ybp in rolls]
        return float(sum(v.sum() for v in vs))

    run_once()  # compile + warmup
    return _rate_stats(FS_BATCH * FS_CHAIN, run_once, reps=5)


def bench_fold(seqs):
    """Fold seqs/s through the batched scaled McCaskill engine (incl. the
    device->host BPP fetch, i.e. what the Gram pipeline actually pays)."""
    from stem_kernel_tpu.fold.bpmatrix import fold_sequences

    batch = (seqs * (-(-FOLD_BATCH // len(seqs))))[:FOLD_BATCH]
    fold_sequences(batch)  # compile + warmup
    return _rate_stats(FOLD_BATCH, lambda: fold_sequences(batch), reps=5)


def main() -> None:
    from stem_kernel_tpu.utils.device import require_gpu

    device = require_gpu()
    rng = np.random.default_rng(0)
    seqs = _hairpins(rng, N_SEQS, SEQ_LEN)

    stem_rate, stem_base, stem_exact_rate = bench_stem(seqs)
    bpla_rate, bpla_base = bench_bpla()
    fold_rate = bench_fold(seqs)
    fs_rate = bench_full_stem()

    def r(d):
        return {k: round(v, 1) for k, v in d.items()}

    print(
        json.dumps(
            {
                "metric": "stem_dp_pairs_per_sec",
                "value": round(stem_rate["median"], 1),
                "unit": f"pairs/s (DAG closure kernel, n={SEQ_LEN} seqs, batch {STEM_BATCH}, 1 device; median of 5, min/max in extras)",
                "vs_baseline": round(stem_rate["median"] / stem_base, 2),
                "device": device,
                "extras": {
                    "stem_pairs_per_sec_spread": r(stem_rate),
                    "stem_numpy_oracle_pairs_per_sec": round(stem_base, 2),
                    "stem_exact_f32_pairs_per_sec": round(stem_exact_rate["median"], 1),
                    "bpla_log_pairs_per_sec": round(bpla_rate["median"], 1),
                    "bpla_pairs_per_sec_spread": r(bpla_rate),
                    "bpla_vs_numpy_oracle": round(bpla_rate["median"] / bpla_base, 2),
                    "bpla_numpy_oracle_pairs_per_sec": round(bpla_base, 2),
                    "fold_seqs_per_sec": round(fold_rate["median"], 1),
                    "fold_seqs_per_sec_spread": r(fold_rate),
                    "full_stem_banded_n300_pairs_per_sec": round(fs_rate["median"], 2),
                    "full_stem_spread": r(fs_rate),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
