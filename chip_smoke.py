"""Smoke test of the main path on NVIDIA GPUs, through the CLI entry points.

Runs the README's worked example at the size of the 500-sequence benchmark
configuration, in one process on one card:

1. device gate: a GPU must be present (no CPU fallback); builds the native
   library;
2. fold: the scaled McCaskill engine vs the exact log-space engine;
3. stem_kernel_lite train -> svm-train -> stem_kernel_lite predict -> ROC AUC,
   the Gram checked on the card against the host CPU backend and across
   ``--precision high`` / ``highest``;
4. bpla_kernel train, and the Triton LA kernel checked against the plain
   scans at real widths, with the compiled HLO showing the kernel on the
   CLI path;
5. peak device memory and each phase's wall time (smoke timings, not
   benchmark numbers).

``--four`` instead runs the stem_kernel_lite and bpla_kernel Grams with
``--devices 4`` and ``--devices 1`` in one process and compares them.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed check raises, so the script exits non-zero and prints no result.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_POS = 250  # structured training RNAs; as many shuffled negatives
N_HELD = 50  # held-out positives; as many shuffled negatives
N_FOLD = 64
N_REF = 32
FOLD_TOL = 1e-3  # scaled vs log-space BPP, both float32, max abs
REF_TOL = 2e-3  # card vs host CPU, normalized Gram at --precision high
PREC_TOL = 1e-3  # --precision high vs highest, normalized Gram (contract)
LA_EXP_RTOL = 1e-4  # Triton vs scan, exp space, max relative
LA_LOG_ATOL = 1e-4  # Triton vs scan, log space at L=128, max abs
# log space at L=400: |log K| reaches ~400, where float32 spacing is 3e-5
# and each of the two evaluations rounds once per row; relative bound
LA_LONG_RTOL = 2e-5
# --devices 4 vs 1, normalized Grams, max abs.  Pairs are independent, but
# cuBLAS may pick another algorithm for a per-device batch of 64 than for
# 256: the stem closure runs TF32 products at --precision high (its band vs
# highest is PREC_TOL), the BPLA score factors full-f32 ones.
FOUR_TOL = {"stem_kernel_lite": PREC_TOL, "bpla_kernel": 1e-4}
TRITON_CALL = "__gpu$xla.gpu.triton"


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Wall time per phase; a phase that raises ends the run."""

    def __init__(self) -> None:
        self.times: dict[str, float] = {}

    def run(self, name: str, fn, *args):
        log(f"== {name}")
        t0 = time.perf_counter()
        out = fn(*args)
        self.times[name] = time.perf_counter() - t0
        log(f"   {name}: {self.times[name]:.1f}s")
        return out


def run_cli(main, argv: list[str]) -> None:
    rc = main(argv)
    if rc != 0:
        raise SystemExit(f"{main.__module__} {' '.join(argv)}: exit code {rc}")


def check(name: str, value: float, tol: float) -> None:
    ok = bool(np.isfinite(value)) and value <= tol
    log(f"   {name} = {value:.3e} (tolerance {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"check failed: {name} = {value!r} > {tol!r}")


# ------------------------------------------------------------------ gate


def device_gate(want: int):
    try:
        from stem_kernel_tpu.utils.device import require_gpu
    except ImportError:
        sys.exit("chip_smoke: run it from the root of a stem_kernel_tpu checkout")
    info = require_gpu(want)
    log(f"device: {info['kind']}, count {info['count']}")
    log(info["gpu"])
    import jax

    return jax.devices()


def build_native() -> None:
    from stem_kernel_tpu import native
    from stem_kernel_tpu.native.build import build

    if shutil.which("g++") is None:
        log("native: no g++ on this machine; NumPy fallbacks in use")
        return
    build(verbose=False)
    log(f"native: built, loaded={native.available()}")


# ---------------------------------------------------------------- corpus


def make_corpus(work: str) -> dict:
    """Training and held-out FASTA files, all generated from seed 0."""
    sys.path.insert(0, ROOT)
    from bench_500 import make_dataset

    from stem_kernel_tpu.utils.shuffle import dinucleotide_shuffle

    rng = np.random.default_rng(0)
    pos = make_dataset(N_POS, seed=0)
    neg = [dinucleotide_shuffle(s, rng) for s in pos]
    held_pos = make_dataset(N_HELD, seed=1)
    held_neg = [dinucleotide_shuffle(s, rng) for s in held_pos]
    files = {}
    for name, seqs in [("pos", pos), ("neg", neg), ("tpos", held_pos),
                       ("tneg", held_neg)]:
        path = os.path.join(work, f"{name}.fa")
        with open(path, "w") as f:
            f.writelines(f">{name}{i}\n{s}\n" for i, s in enumerate(seqs))
        files[name] = path
    lens = [len(s) for s in pos + neg]
    log(f"corpus: {len(pos)}+{len(neg)} train, {len(held_pos)}+"
        f"{len(held_neg)} held out, lengths {min(lens)}-{max(lens)} nt")
    return {"files": files, "train": pos + neg}


# ------------------------------------------------------------------ fold


def fold_phase(seqs: list[str]) -> None:
    from stem_kernel_tpu.fold.bpmatrix import _pad_len
    from stem_kernel_tpu.fold.mccaskill import mccaskill_bpp_batch
    from stem_kernel_tpu.io.alphabet import encode

    seqs = seqs[:N_FOLD]
    n = _pad_len(max(len(s) for s in seqs), 0)
    codes = np.zeros((len(seqs), n), np.uint8)
    lens = np.array([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode(s)
    scaled, z_scaled = mccaskill_bpp_batch(codes, lens, engine="scaled")
    exact, z_exact = mccaskill_bpp_batch(codes, lens, engine="log")
    log(f"   folded {len(seqs)} sequences padded to {n}; max |logZ diff| "
        f"{np.max(np.abs(z_scaled - z_exact)):.3e}")
    check("fold max |BPP scaled - BPP log-space|",
          float(np.max(np.abs(np.asarray(scaled) - np.asarray(exact)))),
          FOLD_TOL)


# ------------------------------------------------------ stem_kernel_lite


def read_gram(path: str, n: int) -> np.ndarray:
    from stem_kernel_tpu.gram.io import read_precomputed

    _, g = read_precomputed(path)
    if g.shape != (n, n):
        raise SystemExit(f"{path}: Gram shape {g.shape}, expected {(n, n)}")
    log(f"   Gram {g.shape}: finite={bool(np.isfinite(g).all())} "
        f"max|G-G^T|={np.max(np.abs(g - g.T)):.2e} "
        f"max|diag-1|={np.max(np.abs(np.diag(g) - 1)):.2e}")
    if not np.isfinite(g).all():
        raise SystemExit(f"{path}: non-finite Gram entries")
    check("Gram asymmetry", float(np.max(np.abs(g - g.T))), 1e-6)
    check("Gram |diag - 1|", float(np.max(np.abs(np.diag(g) - 1))), 1e-5)
    return g


def stem_train_predict(files: dict, work: str, n_train: int) -> float:
    from stem_kernel_tpu.cli import stem_kernel_lite, svm_tools
    from stem_kernel_tpu.utils.roc import roc_curve_and_auc

    km = os.path.join(work, "km.dat")
    model = os.path.join(work, "km.model")
    run_cli(stem_kernel_lite.main, ["-n", "--devices", "1", km, "+1",
                                    files["pos"], "-1", files["neg"]])
    read_gram(km, n_train)
    run_cli(svm_tools.train_main, [km, model])
    pred = os.path.join(work, "pred.txt")
    run_cli(stem_kernel_lite.main, [
        "-n", "--devices", "1", "--model", model, "--predict", pred,
        os.path.join(work, "test.dat"), "+1", files["pos"], "-1",
        files["neg"], "--test", "+1", files["tpos"], "-1", files["tneg"],
    ])
    rows = [line.split() for line in open(pred)]
    labels = np.array([int(r[0]) for r in rows])
    dec = np.array([float(r[1]) for r in rows])
    auc, _ = roc_curve_and_auc(labels, dec)
    log(f"   held-out ROC AUC = {auc:.4f} ({len(rows)} predictions)")
    if len(rows) != 2 * N_HELD or not np.isfinite(dec).all():
        raise SystemExit("predict: wrong count or non-finite decisions")
    return auc


def stem_grams(seqs: list[str], precisions, device=None) -> list[np.ndarray]:
    """Normalized stem_kernel_lite Grams through the CLI's own kernel
    function, one per precision; fold and featurization run once on the
    default device, the Grams on ``device``."""
    import contextlib

    import jax

    from stem_kernel_tpu.gram.bucketed import bucketed_gram
    from stem_kernel_tpu.io.profile import Alignment
    from stem_kernel_tpu.models.composite import (
        StemLiteConfig, featurize_stem_bucketed, make_stem_lite_kernel_fn,
    )

    buckets = featurize_stem_bucketed([Alignment(rows=[s]) for s in seqs],
                                      StemLiteConfig())
    out = []
    for precision in precisions:
        cfg = StemLiteConfig(precision=precision)
        ctx = (jax.default_device(device) if device is not None
               else contextlib.nullcontext())
        with ctx:
            out.append(bucketed_gram(
                buckets, lambda aux: make_stem_lite_kernel_fn(cfg, aux),
                normalize=True, batch_size=256))
    return out


def stem_reference(seqs: list[str]) -> None:
    import jax

    half = len(seqs) // 2
    sub = seqs[: N_REF // 2] + seqs[half : half + N_REF // 2]
    (g_gpu,) = stem_grams(sub, ["high"])
    (g_cpu,) = stem_grams(sub, ["high"], jax.devices("cpu")[0])
    check(f"stem Gram ({len(sub)} seqs) card vs host CPU, max abs",
          float(np.max(np.abs(g_gpu - g_cpu))), REF_TOL)
    g_h, g_hi = stem_grams(seqs, ["high", "highest"])
    check(f"stem Gram ({len(seqs)} seqs) --precision high vs highest, "
          "max abs", float(np.max(np.abs(g_h - g_hi))), PREC_TOL)


# ------------------------------------------------------------------ BPLA


def bpla_train(files: dict, work: str, n_train: int) -> None:
    from stem_kernel_tpu.cli import bpla_kernel

    km = os.path.join(work, "km_bpla.dat")
    run_cli(bpla_kernel.main, ["-n", "--devices", "1", km, "+1",
                               files["pos"], "-1", files["neg"]])
    read_gram(km, n_train)


def _pad_features(feats: dict, width: int) -> dict:
    out = {}
    for k, v in feats.items():
        if v.ndim >= 2:
            pad = [(0, 0), (0, width - v.shape[1])] + [(0, 0)] * (v.ndim - 2)
            v = np.pad(v, pad)
        out[k] = v
    return out


def _random_profiles(rng, b: int, length: int) -> dict:
    prof = rng.dirichlet(np.ones(4), size=(b, length)).astype(np.float32)
    pl_ = rng.uniform(0, 0.7, (b, length)).astype(np.float32)
    pr = rng.uniform(0, 0.7, (b, length)).astype(np.float32)
    pu = np.sqrt(np.clip(1 - pl_**2 - pr**2, 0, None)).astype(np.float32)
    lens = rng.integers(length // 2, length + 1, b).astype(np.int32)
    return {"profile": prof, "p_left": pl_, "p_right": pr, "p_unpair": pu,
            "length": lens}


def _scan_reference(kern, x, y, log_space: bool):
    """The plain scans on materialized scores at HIGHEST precision."""
    import jax
    import jax.numpy as jnp

    from stem_kernel_tpu.models.bpla import (
        local_alignment_exp, local_alignment_log, pair_mask,
    )

    with jax.default_matmul_precision("highest"):
        s = kern.scores(x, y)
        mask = pair_mask(x["length"], s.shape[1], y["length"], s.shape[2])
        la = local_alignment_log if log_space else local_alignment_exp
        return np.asarray(la(s, mask, jnp.float32(kern.beta),
                             jnp.float32(kern.gap), jnp.float32(kern.ext)))


def _closure_f64(kern, x, y) -> np.ndarray:
    """log K in float64 by the M-only closure recursion, one row at a time
    (exp-space values up to e^700 fit a double)."""
    s = np.asarray(kern.scores(x, y), np.float64)
    lx, ly = np.asarray(x["length"]), np.asarray(y["length"])
    b, n_x, n_y = s.shape
    beta, bg, be = kern.beta, np.exp(kern.beta * kern.gap), np.exp(kern.beta * kern.ext)
    d = np.arange(n_y)[None, :] - np.arange(n_y)[:, None]
    tu = np.where(d == 1, 1.0, np.where(d >= 2, bg * be ** np.maximum(d - 2, 0), 0.0))
    cols = np.arange(n_y)[None, :] < ly[:, None]
    a = np.zeros((b, n_y))
    g = np.zeros((b, n_y))
    tot = np.ones(b)
    for i in range(n_x):
        e = np.where(cols & (i < lx)[:, None], np.exp(beta * s[:, i]), 0.0)
        m = e * (1.0 + a + bg * g)
        a, g = m @ tu, be * g + a
        tot += m.sum(axis=1)
    return np.log(tot)


def bpla_kernel_checks(train_seqs: list[str]) -> None:
    import jax
    import jax.numpy as jnp

    from stem_kernel_tpu.fold.bpmatrix import bpp_for_alignments
    from stem_kernel_tpu.gram.engine import PairKernelEngine
    from stem_kernel_tpu.io.profile import Alignment
    from stem_kernel_tpu.models.bpla import BPLAKernel, la_impl
    from stem_kernel_tpu.models.featurize import bpla_features

    kern = BPLAKernel()
    rng = np.random.default_rng(0)
    alns = [Alignment(rows=[s]) for s in train_seqs]
    corpus = _pad_features(bpla_features(alns, bpp_for_alignments(alns)), 128)
    n = len(train_seqs)
    if la_impl(jax.default_backend(), 128) != "triton":
        raise SystemExit("dispatch does not pick the Triton kernel on the GPU")

    # the compiled CLI slab program holds the Triton custom call
    eng = PairKernelEngine(kern.log_value, corpus, batch_size=256,
                           slab_batches=64, log_values=True)
    ix = jnp.zeros(256 * 64, jnp.int32)
    hlo = eng._slab_fn(64).lower(eng.features, eng.features, ix, ix,
                                 jnp.int32(0)).compile().as_text()
    n_calls = hlo.count(TRITON_CALL)
    log(f"   compiled bpla_kernel slab program: {n_calls} Triton custom "
        f"call(s) ({TRITON_CALL})")
    if n_calls == 0:
        raise SystemExit("the bpla_kernel path does not reach the Triton kernel")

    # B=512 corpus pairs at the L=128 width, exp and log space
    ia = rng.integers(0, n, 512)
    ib = rng.integers(0, n, 512)
    x = {k: jnp.asarray(v[ia]) for k, v in corpus.items()}
    y = {k: jnp.asarray(v[ib]) for k, v in corpus.items()}
    got = np.asarray(jax.jit(kern)(x, y))
    want = _scan_reference(kern, x, y, False)
    fin = np.isfinite(want)
    if fin.sum() < 256 or not np.array_equal(np.isfinite(got), fin):
        raise SystemExit(f"exp-space LA: {fin.sum()} finite reference values, "
                         "or overflow pattern differs")
    check(f"LA exp B=512 L=128 ({fin.sum()} finite) Triton vs scan, max rel",
          float(np.max(np.abs(got[fin] - want[fin]) / want[fin])),
          LA_EXP_RTOL)
    got = np.asarray(jax.jit(kern.log_value)(x, y))
    want = _scan_reference(kern, x, y, True)
    check("LA log B=512 L=128 Triton vs scan, max abs",
          float(np.max(np.abs(got - want))), LA_LOG_ATOL)

    # B=64 at L=400, where exp-space values overflow float32
    d = {k: jnp.asarray(v) for k, v in _random_profiles(rng, 64, 400).items()}
    yr = {k: jnp.roll(v, 1, axis=0) for k, v in d.items()}
    got = np.asarray(jax.jit(kern.log_value)(d, yr))
    want = _scan_reference(kern, d, yr, True)
    log(f"   log K range at L=400: {want.min():.1f} .. {want.max():.1f}")
    if not np.isfinite(got).all():
        raise SystemExit("log-space LA at L=400 is not finite")
    exact = _closure_f64(kern, {k: v[:8] for k, v in d.items()},
                         {k: v[:8] for k, v in yr.items()})
    log(f"   L=400 vs float64 closure (8 pairs), max abs: Triton "
        f"{np.max(np.abs(got[:8] - exact)):.3e}, scan "
        f"{np.max(np.abs(want[:8] - exact)):.3e}")
    check("LA log B=64 L=400 Triton vs scan, max rel",
          float(np.max(np.abs(got - want) / np.abs(want))), LA_LONG_RTOL)


# ------------------------------------------------------------- four cards


def four_phase(files: dict, work: str, n_train: int) -> None:
    from stem_kernel_tpu.cli import bpla_kernel, stem_kernel_lite

    for name, cli in [("stem_kernel_lite", stem_kernel_lite),
                      ("bpla_kernel", bpla_kernel)]:
        grams = {}
        for n_dev in (4, 1):
            km = os.path.join(work, f"{name}_{n_dev}.dat")
            t0 = time.perf_counter()
            run_cli(cli.main, ["-n", "--devices", str(n_dev), km, "+1",
                               files["pos"], "-1", files["neg"]])
            log(f"   {name} --devices {n_dev}: "
                f"{time.perf_counter() - t0:.1f}s (smoke timing)")
            grams[n_dev] = read_gram(km, n_train)
        check(f"{name} Gram --devices 4 vs 1, max abs",
              float(np.max(np.abs(grams[4] - grams[1]))), FOUR_TOL[name])


# ------------------------------------------------------------------ main


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="compare the 4-device Grams with the 1-device Grams")
    ns = ap.parse_args()
    want = 4 if ns.four else 1
    devs = device_gate(want)

    work = os.path.join(ROOT, "chiprun_out", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ph = Phases()
    ph.run("native build", build_native)
    corpus = make_corpus(work)
    files, train = corpus["files"], corpus["train"]
    if ns.four:
        ph.run("four-card Grams", four_phase, files, work, len(train))
    else:
        ph.run("fold", fold_phase, train)
        ph.run("stem_kernel_lite train+svm+predict", stem_train_predict,
               files, work, len(train))
        ph.run("stem Gram references", stem_reference, train)
        ph.run("bpla_kernel train", bpla_train, files, work, len(train))
        ph.run("BPLA kernel vs scans", bpla_kernel_checks, train)

    peak = max(d.memory_stats().get("peak_bytes_in_use", 0)
               for d in devs[:want])
    log(f"peak device memory: {peak / 2**20:.1f} MiB")
    log("smoke timings (s, compilation included; not benchmark numbers): "
        + ", ".join(f"{k}={v:.1f}" for k, v in ph.times.items()))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
