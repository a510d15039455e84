"""Shared application flow: train (Gram build) and predict (test rows).

Equivalent of the reference's App<Kernel, LoaderFactory>
(/root/reference/common/framework.h:100-416):

- positional grammar ``output [label file]... [--test [label file]...]``
  (Options::parse_extra_args, framework.cpp:48-139), with glob expansion;
- train: load examples -> Gram matrix -> optional cosine normalization ->
  LIBSVM PRECOMPUTED output (gzip/bzip2 by suffix), with per-stage timing
  ("elapsed time" prints, framework.h:139, 334-345);
- predict: load train set, restrict to support vectors of provided models,
  compute test rows + self values, normalize against train diagonals, write
  matrix rows / norm file, and run in-process SVM prediction per model
  (framework.h:167-306).
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np

from ..gram.engine import PairKernelEngine, normalize_gram
from ..gram.io import write_precomputed, write_rows, write_norm, _open_write
from ..io.parsers import expand_globs, iter_alignments
from ..io.profile import Alignment
from ..svm.model import load_model, load_sv_index
from ..svm.train import svm_predict_values, svm_predict_probability


@dataclass
class AppOptions:
    """Common options (Options, framework.cpp:10-46)."""

    output: str = ""
    labels: list[str] = field(default_factory=list)
    files: list[str] = field(default_factory=list)
    ts_labels: list[str] = field(default_factory=list)
    ts_files: list[str] = field(default_factory=list)
    predict_mode: bool = False
    normalize: bool = False
    norm_output: str = ""
    predict_only: bool = False  # --no-matrix
    model_files: list[str] = field(default_factory=list)
    predict_outputs: list[str] = field(default_factory=list)
    trace_dir: str = ""
    use_pf_scale_file: bool = False
    pf_files: list[str] = field(default_factory=list)
    pf_ts_files: list[str] = field(default_factory=list)
    stream_chunk: int = 64  # test examples featurized per predict chunk
    devices: int = 0  # 0 = all global devices; 1 = single-device dispatch
    checkpoint: str = ""  # train-Gram checkpoint/resume directory


def add_common_options(p: argparse.ArgumentParser) -> None:
    p.add_argument("-n", "--normalize", action="store_true",
                   help="normalize the kernel matrix")
    p.add_argument("-x", "--norm", default="",
                   help="set the filename for norms of test examples")
    p.add_argument("--no-matrix", action="store_true",
                   help="do not output matrix")
    p.add_argument("--model", action="append", default=[],
                   help="the model file trained by svm-train if you already have")
    p.add_argument("--predict", action="append", default=[],
                   help="output file name of prediction results")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for compatibility (parallelism is device-mesh based)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the Gram pair axis over this many devices "
                        "(0 = every visible device; the multi-chip analogue "
                        "of the reference's mpirun rank count).  Multi-host "
                        "runs additionally set JAX_COORDINATOR_ADDRESS / "
                        "JAX_NUM_PROCESSES / JAX_PROCESS_ID per process")
    p.add_argument("--single-device", action="store_true",
                   help="force plain single-device dispatch (same as --devices 1)")
    p.add_argument("--checkpoint", default="",
                   help="directory for slab-granular Gram checkpointing: a "
                        "restarted train run resumes, skipping completed "
                        "slabs (the reference restarts multi-hour MPI Gram "
                        "runs from zero)")
    p.add_argument("--trace-dir", default="",
                   help="write a jax.profiler trace of the run to this "
                        "directory (view with TensorBoard / xprof)")
    p.add_argument("--stream-chunk", type=int, default=64,
                   help="predict mode: featurize this many test examples at "
                        "a time (memory stays O(train + chunk), matching the "
                        "reference's streaming predictor)")
    p.add_argument("--use-pf-scale-file", action="store_true",
                   help="positional args come as 'label file pf_scale_file' "
                        "triples (framework.cpp:26-30); the scaled fold "
                        "engine self-normalizes, so the values only validate "
                        "example counts")
    # positional grammar "output [label file]... [--test ...]" is collected
    # from unrecognized args (labels like -1 confuse argparse), mirroring the
    # reference's collect_unrecognized pattern (stem_kernel_lite/main.cpp:152-163)


def parse_args_with_positionals(p: argparse.ArgumentParser, argv):
    ns, rest = p.parse_known_args(argv)
    if not rest:
        p.error("missing positional arguments: output [label file] ...")
    ns.args = rest
    return ns


def parse_positional(ns: argparse.Namespace) -> AppOptions:
    """parse_extra_args semantics (framework.cpp:48-139)."""
    extra = ns.args
    opts = AppOptions(
        output=extra[0],
        normalize=ns.normalize,
        norm_output=ns.norm,
        predict_only=ns.no_matrix,
        model_files=list(ns.model),
        predict_outputs=list(ns.predict),
        trace_dir=getattr(ns, "trace_dir", ""),
    )
    opts.use_pf_scale_file = getattr(ns, "use_pf_scale_file", False)
    opts.stream_chunk = getattr(ns, "stream_chunk", 64)
    opts.devices = 1 if getattr(ns, "single_device", False) else getattr(ns, "devices", 0)
    opts.checkpoint = getattr(ns, "checkpoint", "")
    if "--test" in extra:
        opts.predict_mode = True
        x = extra.index("--test")
        pairs = extra[1:x]
        ts = extra[x + 1 :]
    else:
        pairs = extra[1:]
        ts = []
    stride = 3 if opts.use_pf_scale_file else 2
    opts.labels = pairs[0::stride]
    opts.files = pairs[1::stride]
    opts.ts_labels = ts[0::stride]
    opts.ts_files = ts[1::stride]
    if opts.use_pf_scale_file:
        # 'label file pf_scale_file' triples (framework.cpp:96-139;
        # DataLoader pf_is_, stem_kernel_lite/data.cpp:510-538)
        opts.pf_files = pairs[2::stride]
        opts.pf_ts_files = ts[2::stride]
    return opts


def load_pf_scales(pf_files: list[str], counts: list[int]) -> list[float]:
    """Read per-example pf_scale side files (one float per example,
    stem_kernel_lite/data.cpp:510-538).  The fold engine performs its own
    per-length rescaling, so the values are only validated against example
    counts and returned for diagnostics."""
    scales: list[float] = []
    for path, count in zip(pf_files, counts):
        vals = [float(t) for t in open(path).read().split()]
        if len(vals) < count:
            raise ValueError(
                f"{path}: {len(vals)} pf_scale values for {count} examples"
            )
        scales.extend(vals[:count])
    return scales


def load_labeled(labels: list[str], files: list[str], verbose: bool = True,
                 counts_out: list[int] | None = None):
    """Stream examples per (label, glob) pair with per-file timing.

    ``counts_out``: optional list appended with the example count of each
    (label, pattern) argument — used to validate pf_scale side files."""
    alignments: list[Alignment] = []
    out_labels: list[str] = []
    for label, pattern in zip(labels, files):
        n_before = len(alignments)
        for path in expand_globs([pattern]):
            t0 = time.time()
            n0 = len(alignments)
            for aln in iter_alignments(path):
                alignments.append(aln)
                out_labels.append(label)
            if verbose:
                print(
                    f"loading {path} as label {label} ({len(alignments)-n0} ex, "
                    f"{time.time()-t0:.1f}s) done.",
                    file=sys.stderr,
                )
        if counts_out is not None:
            counts_out.append(len(alignments) - n_before)
    return alignments, out_labels


# featurize: alignments -> (features dict, aux); make_kernel_fn: aux -> kernel_fn
Featurizer = Callable[[list[Alignment]], tuple[Mapping[str, np.ndarray], object]]


def run_app(
    opts: AppOptions,
    featurize: Featurizer,
    make_kernel_fn: Callable[[object, object], Callable],
    *,
    batch_size: int = 256,
    mesh=None,
    log_kernel: bool = False,
    featurize_buckets=None,
    merge_aux=None,
    slab_batches: int = 16,
) -> None:
    """Execute the train or predict flow.

    ``log_kernel``: the kernel_fn returns log K; normalization happens in log
    space (overflow-safe for long sequences).
    ``featurize_buckets``: alignments -> list of (indices, feats, aux)
    shape-buckets; when given, the train Gram is assembled block-wise at
    per-bucket pad shapes (gram.bucketed) instead of corpus-max padding.
    ``merge_aux``: combine train and test-chunk featurizer aux (e.g. ``max``
    for iteration bounds) when streaming predict chunks; None reuses the
    train aux.
    ``slab_batches``: dispatch granularity of the Gram engine — fast
    kernels (BPLA/string/simpal) pass 64 to amortize per-slab dispatch
    latency; compute-bound kernels keep 16.

    Device setup happens HERE, inside the binary — the shipped CLIs are the
    distributed programs, exactly as the reference's binaries are the MPI
    entry points (MPIState in main(), /root/reference/common/framework.h:
    418-433): `jax.distributed` is initialized from the environment (no-op
    single-host), the Gram pair axis is sharded over all visible devices
    (``--devices N`` / ``--single-device`` narrow it), and file output is
    gated on process 0 (framework.h:135-163).  An explicit ``mesh=``
    argument overrides the flag-resolved mesh (library use).
    """
    if mesh is None:
        from ..parallel.distributed import initialize
        from ..parallel.mesh import resolve_mesh

        initialize()
        mesh = resolve_mesh(getattr(opts, "devices", 0))
    if opts.trace_dir:
        import contextlib

        import jax

        ctx = jax.profiler.trace(opts.trace_dir)
    else:
        import contextlib

        ctx = contextlib.nullcontext()
    with ctx:
        return _run_app_inner(opts, featurize, make_kernel_fn,
                              batch_size=batch_size, mesh=mesh,
                              log_kernel=log_kernel,
                              featurize_buckets=featurize_buckets,
                              merge_aux=merge_aux, slab_batches=slab_batches)


def _run_app_inner(opts, featurize, make_kernel_fn, *, batch_size, mesh,
                   log_kernel, featurize_buckets=None, merge_aux=None,
                   slab_batches=16):
    from ..parallel.mesh import process_zero

    io_rank = process_zero()  # rank-0 I/O (framework.h:135-163)
    t_start = time.time()
    counts: list[int] | None = [] if opts.use_pf_scale_file else None
    train_alns, train_labels = load_labeled(opts.labels, opts.files,
                                            counts_out=counts)
    if opts.use_pf_scale_file:
        load_pf_scales(opts.pf_files, counts)
    if not opts.predict_mode:
        if featurize_buckets is not None:
            from ..gram.bucketed import bucketed_gram

            buckets = featurize_buckets(train_alns)
            g = bucketed_gram(
                buckets, make_kernel_fn, normalize=opts.normalize,
                batch_size=batch_size, mesh=mesh, log_values=log_kernel,
                checkpoint_path=opts.checkpoint or None,
            )
        else:
            feats, aux = featurize(train_alns)
            kernel_fn = make_kernel_fn(aux)
            eng = PairKernelEngine(kernel_fn, feats, batch_size=batch_size,
                                   slab_batches=slab_batches,
                                   mesh=mesh, log_values=log_kernel)
            g = eng.gram(normalize=opts.normalize,
                         checkpoint_path=opts.checkpoint or None)
        if io_rank:
            write_precomputed(opts.output, train_labels, g)
        print(f"elapsed time: {time.time()-t_start:.1f}s", file=sys.stderr)
        return

    # ---- predict mode (streaming: fixed-size test chunks) ----
    # The reference streams one test sequence at a time against the resident
    # training set (common/framework.h:226-303); here test examples are
    # featurized in fixed-size chunks with their OWN pad shapes (every kernel
    # is shape-generic in x vs y), so peak memory is O(train + chunk), never
    # O(test set).
    sv_index = None
    models = []
    if opts.model_files:
        sv_index = load_sv_index(opts.model_files)
        models = [load_model(m) for m in opts.model_files]

    ts_counts: list[int] | None = [] if opts.use_pf_scale_file else None
    test_alns, test_labels = load_labeled(opts.ts_labels, opts.ts_files,
                                          counts_out=ts_counts)
    if opts.use_pf_scale_file:
        load_pf_scales(opts.pf_ts_files, ts_counts)

    train_feats, aux_tr = featurize(train_alns)
    eng = PairKernelEngine(make_kernel_fn(aux_tr), train_feats,
                           slab_batches=slab_batches,
                           batch_size=batch_size, mesh=mesh,
                           log_values=log_kernel)
    diag = eng.diagonal(sv_index=sv_index)

    chunk = max(1, int(getattr(opts, "stream_chunk", 64) or 64))
    n_test = len(test_alns)
    all_norm_rows = []
    all_self = []
    for lo in range(0, n_test, chunk):
        chunk_alns = test_alns[lo : lo + chunk]
        feats_c, aux_c = featurize(chunk_alns)
        if merge_aux is not None:
            eng.kernel_fn = make_kernel_fn(merge_aux(aux_tr, aux_c))
        # self values are consumed only by normalization and the norm file;
        # the unnormalized no-norm predict flow skips that dispatch entirely
        need_self = bool(opts.normalize) or bool(opts.norm_output)
        rows, self_vals = eng.rows(feats_c, sv_index=sv_index,
                                   with_self=need_self)

        if log_kernel:
            cols = (np.arange(rows.shape[1]) if sv_index is None
                    else np.asarray(sv_index))
            norm_rows = np.zeros_like(rows)
            if opts.normalize:
                norm_rows[:, cols] = np.exp(
                    rows[:, cols] - 0.5 * (diag[None, cols] + self_vals[:, None])
                )
            else:
                norm_rows[:, cols] = np.exp(rows[:, cols].astype(np.float64))
            self_vals = np.exp(self_vals.astype(np.float64))
        else:
            norm_rows = rows.copy()
            if opts.normalize:
                denom = np.sqrt(np.clip(diag, 1e-300, None))[None, :] * np.sqrt(
                    np.clip(self_vals, 1e-300, None)
                )[:, None]
                cols = np.flatnonzero(diag > 0)
                norm_rows[:, cols] = rows[:, cols] / denom[:, cols]
        all_norm_rows.append(norm_rows)
        all_self.append(self_vals)

    norm_rows = (np.concatenate(all_norm_rows) if all_norm_rows
                 else np.zeros((0, len(train_alns)), np.float32))
    self_vals = (np.concatenate(all_self) if all_self
                 else np.zeros((0,), np.float64))

    if not opts.predict_only and io_rank:
        with _open_write(opts.output) as f:
            write_rows(f, test_labels, norm_rows)
    if opts.norm_output and io_rank:
        write_norm(opts.norm_output, self_vals)

    for model, out_path in zip(models if io_rank else [], opts.predict_outputs or
                               [f"{opts.output}.pred{i}" for i in range(len(models))]):
        with open(out_path, "w") as f:
            for t, label in enumerate(test_labels):
                if model.prob_A is not None:
                    pred, prob = svm_predict_probability(model, norm_rows[t])
                    f.write(f"{label} {pred} {' '.join(f'{p:g}' for p in prob)}\n")
                else:
                    pred, dec = svm_predict_values(model, norm_rows[t])
                    f.write(f"{label} {dec[0]:g}\n")
    print(f"elapsed time: {time.time()-t_start:.1f}s", file=sys.stderr)
