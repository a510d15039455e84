"""la_kernel CLI — protein local-alignment kernel with BLOSUM62.

Mirrors /root/reference/bpla_kernel/la_main.cpp: the BPLA machinery run with
noBP semantics on amino-acid profiles (defaults gap=-10, ext=-1, beta=0.11).
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from ..io.aaprofile import aa_features
from ..models.blosum_data import BLOSUM62
from ..models.bpla import (
    la_score_matrix, local_alignment_exp, local_alignment_max, pair_mask,
)
from .app import add_common_options, parse_args_with_positionals, parse_positional, run_app


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="la_kernel", description="Kernel Matrix Calculator for Local Alignment Kernels"
    )
    p.add_argument("-g", "--gap", type=float, default=-10.0)
    p.add_argument("-e", "--ext", type=float, default=-1.0)
    p.add_argument("-b", "--beta", type=float, default=0.11)
    p.add_argument("--SW", action="store_true",
                   help="Smith-Waterman kernel instead of local alignment kernel")
    add_common_options(p)
    return p


def main(argv=None) -> int:
    ns = parse_args_with_positionals(build_parser(), argv)
    opts = parse_positional(ns)
    table = jnp.asarray(BLOSUM62)

    def featurize(alignments):
        return aa_features(alignments), None

    def make_fn(_aux):
        def kernel_fn(x, y):
            s = la_score_matrix(x["profile"], y["profile"], table)
            mask = pair_mask(x["length"], s.shape[1], y["length"], s.shape[2])
            if ns.SW:
                return local_alignment_max(s, mask, ns.gap, ns.ext)
            return local_alignment_exp(s, mask, ns.beta, ns.gap, ns.ext)

        return kernel_fn

    run_app(opts, featurize, make_fn, slab_batches=64)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
