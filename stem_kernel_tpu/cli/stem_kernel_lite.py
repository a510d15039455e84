"""stem_kernel_lite CLI — Gram matrices of stem (+ string) kernels.

Usage mirrors /root/reference/stem_kernel_lite/main.cpp:77-231:

    stem_kernel_lite [options] output label1 data1 [label2 data2 ...] \
                     [--test label file ...]
"""

from __future__ import annotations

import argparse

from ..fold.bpmatrix import BPMatrixOptions
from ..models.composite import (
    StemLiteConfig,
    featurize_stem_examples,
    make_stem_lite_kernel_fn,
)
from .app import add_common_options, parse_args_with_positionals, parse_positional, run_app


def add_fold_options(p: argparse.ArgumentParser) -> None:
    """Folding options (BPMatrix::Options::add_options, bpmatrix.cpp:45-82)."""
    p.add_argument("--noGU", action="store_true",
                   help="disallow GU wobble base-pairs")
    p.add_argument("--noClosingGU", action="store_true",
                   help="disallow GU pairs closing hairpin/multibranch loops")
    p.add_argument("--noLonelyPairs", action="store_true",
                   help="disallow isolated base-pairs (Vienna pf heuristic: "
                        "a pair must be stackable on a canonical neighbour)")
    p.add_argument("--use-alifold", action="store_true",
                   help="use consensus folding for alignments")
    p.add_argument("--use-contrafold", metavar="PARAMS", default=None,
                   help="fold with the CONTRAfold CLLM (fold.contrafold): "
                        "PARAMS is a CONTRAfold-format weight file, a "
                        "Vienna .par, or the literal 'default' for the "
                        "shipped thermodynamically-seeded weights")
    p.add_argument("--fast-fold", action="store_true",
                   help="fast folding tier: drop the int11/int21/int22/"
                        "bulge-1 special tables and collapse the interior "
                        "mismatch classes (generic-formula energies for "
                        "every loop) — a cheaper fold program at some BPP "
                        "accuracy")


def fold_opts_from(ns: argparse.Namespace) -> BPMatrixOptions:
    """Energy-model gate flags, matching the reference's folding options
    (BPMatrix::Options, /root/reference/common/bpmatrix.cpp:45-82)."""
    opts = BPMatrixOptions(alifold=ns.use_alifold)
    if getattr(ns, "use_contrafold", None):
        if ns.use_contrafold == "default":
            from ..fold.contrafold import (
                contrafold_energy_params, default_weights,
            )

            opts.params = contrafold_energy_params(default_weights())
        else:
            from ..fold.params import load_params_file

            opts.params = load_params_file(ns.use_contrafold)
    if ns.noGU or getattr(ns, "noClosingGU", False) or getattr(ns, "noLonelyPairs", False):
        from ..fold.params import default_params

        params = opts.params or default_params()
        params.no_gu = bool(ns.noGU)
        params.no_closing_gu = bool(getattr(ns, "noClosingGU", False))
        params.no_lonely_pairs = bool(getattr(ns, "noLonelyPairs", False))
        opts.params = params
    if getattr(ns, "fast_fold", False):
        from ..fold.params import default_params, fast_variant

        opts.params = fast_variant(opts.params or default_params())
    return opts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stem_kernel_lite",
        description="Kernel Matrix Calculator for Stem Kernels",
    )
    k = p.add_argument_group("Kernel Options")
    k.add_argument("--no-ribosum", action="store_true",
                   help="do not use the RIBOSUM substitution matrix")
    k.add_argument("--no-string", action="store_true",
                   help="do not convolute the string kernel")
    k.add_argument("--log", action="store_true",
                   help="use the logarithm of the kernel")
    s = p.add_argument_group("Options for the stem kernel")
    s.add_argument("-p", "--basepair", type=float, default=0.01,
                   help="threshold of basepairing probability")
    s.add_argument("-b", "--beta", type=float, default=0.3,
                   help="weight of the RIBOSUM for the stem kernel")
    s.add_argument("-g", "--loop-gap", type=float, default=0.2,
                   help="gap weight for loop regions")
    s.add_argument("-s", "--stack", type=float, default=1.3,
                   help="match weight for stacking base pairs (with --no-ribosum)")
    s.add_argument("-v", "--covariant", type=float, default=0.8,
                   help="substitution weight for base pairs (with --no-ribosum)")
    s.add_argument("--precision", choices=["highest", "high", "default"],
                   default="high",
                   help="float32 matmul precision of the stem closure: "
                        "'high' (the default; TF32 on a GPU, normalized "
                        "Gram within ~1e-3 of 'highest'), 'highest' (full "
                        "f32, validation), 'default' (TF32 on a GPU too)")
    s.add_argument("--length-band", type=int, default=10,
                   help="band of length difference between bases")
    s.add_argument("--coarse-shapes", action="store_true",
                   help="featurize the whole corpus as ONE shape bucket "
                        "(geometric corpus-max padding) instead of "
                        "per-node-count buckets: <=2x padded compute, but "
                        "a fresh process loads a handful of cached XLA "
                        "executables instead of dozens — the fast-startup "
                        "mode for short-lived CLI runs")
    t = p.add_argument_group("Options for the string kernel")
    t.add_argument("-a", "--alpha", type=float, default=0.2,
                   help="weight of the RIBOSUM for the string kernel")
    t.add_argument("-G", "--gap", type=float, default=0.8,
                   help="gap weight for the string kernel")
    t.add_argument("--match", type=float, default=1.0,
                   help="match weight for the string kernel (with --no-ribosum)")
    t.add_argument("--mismatch", type=float, default=0.8,
                   help="mismatch weight for the string kernel (with --no-ribosum)")
    add_fold_options(p)
    add_common_options(p)
    return p


def main(argv=None) -> int:
    ns = parse_args_with_positionals(build_parser(), argv)
    opts = parse_positional(ns)
    bp_opts = fold_opts_from(ns)
    config = StemLiteConfig(
        th=ns.basepair,
        beta=ns.beta,
        loop_gap=ns.loop_gap,
        stack=ns.stack,
        covar=ns.covariant,
        len_band=ns.length_band,
        alpha=ns.alpha,
        gap=ns.gap,
        str_match=ns.match,
        str_mismatch=ns.mismatch,
        no_ribosum=ns.no_ribosum,
        no_string=ns.no_string,
        use_log=ns.log,
        bp_opts=bp_opts,
        precision=ns.precision,
    )

    def featurize(alignments):
        return featurize_stem_examples(alignments, config)

    def featurize_buckets(alignments):
        from ..models.composite import featurize_stem_bucketed

        return featurize_stem_bucketed(alignments, config)

    def make_fn(iters):
        return make_stem_lite_kernel_fn(config, iters)

    run_app(opts, featurize, make_fn,
            featurize_buckets=None if ns.coarse_shapes else featurize_buckets,
            merge_aux=max)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
