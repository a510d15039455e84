"""stem_kernel CLI — the full O(n^4) stem kernel (reference implementation).

Mirrors /root/reference/stem_kernel/main.cpp:36-150: flags gap/stack/
substitution/loop, optional GU wobble pairs, base-pair probability bound
(switches the pair predicate to folded BPP matrices), diagonal band width,
and PHMM alignment constraints.
"""

from __future__ import annotations

import argparse

import numpy as np
import jax.numpy as jnp

from ..models.full_stem import full_stem_kernel, pair_weights
from .app import add_common_options, parse_args_with_positionals, parse_positional, run_app


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stem_kernel", description="Kernel Matrix Calculator for Stem Kernels (full DP)"
    )
    p.add_argument("-g", "--gap", type=float, default=0.8, help="gap weight")
    p.add_argument("-s", "--stack", type=float, default=1.0, help="stacking weight")
    p.add_argument("-l", "--loop", type=int, default=3, help="minimum loop length")
    p.add_argument("-v", "--substitution", type=float, default=0.5,
                   help="substitution weight for base pairs")
    p.add_argument("-p", "--basepair-probability", type=float, default=0.0,
                   help=">0: use folded BPP matrices with this bound")
    p.add_argument("--noGU", action="store_true", help="disallow GU pairs")
    p.add_argument("-b", "--band-width", type=int, default=0,
                   help="diagonal band width for the match region")
    p.add_argument("-a", "--alignment-constraint", type=float, default=0.0,
                   help="PHMM MAP-path posterior bound for banding")
    add_common_options(p)
    return p


def main(argv=None) -> int:
    ns = parse_args_with_positionals(build_parser(), argv)
    opts = parse_positional(ns)

    def featurize(alignments):
        seqs = [a.ungapped_rows()[0] for a in alignments]
        from ..io.alphabet import encode

        n = max(len(s) for s in seqs) + 1
        codes = np.zeros((len(seqs), n), np.uint8)
        lens = np.zeros(len(seqs), np.int32)
        bp = np.zeros((len(seqs), n, n), np.float32)
        bpps = None
        if ns.basepair_probability > 0:
            from ..fold.bpmatrix import fold_sequences

            bpps = fold_sequences(seqs)
        for i, s in enumerate(seqs):
            c = encode(s)
            codes[i, : len(c)] = c
            lens[i] = len(c)
            w = pair_weights(
                c, len(c), use_GU=not ns.noGU, min_loop=ns.loop,
                bpp=None if bpps is None else bpps[i],
                bp_bound=ns.basepair_probability,
            )
            bp[i, : len(c), : len(c)] = w
        return {"codes": codes, "length": lens, "bp": bp}, None

    # -b/--band-width routes to the banded windowed-memory engine
    # (log-valued + scaled: no f32 overflow at any length; staircase
    # anchors handle lx != ly — partial_dp's band branch,
    # /root/reference/stem_kernel/stem_kernel.cpp:70-76,165-246).  With
    # -a > 0 too, the window anchors follow the pair-HMM alignment instead
    # of the scaled diagonal (partial_dp's alignment_constraints mode,
    # conformed to the staircase — models.full_stem.phmm_anchor).  The
    # dense O(n^4)-state path remains for band=0 (with or without
    # posterior windows).
    use_banded = ns.band_width > 0

    def make_fn(_aux):
        if use_banded:
            from ..models.full_stem import full_stem_kernel_banded_log

            def kernel_fn(x, y):
                return full_stem_kernel_banded_log(
                    x["codes"], y["codes"], x["length"], y["length"],
                    x["bp"], y["bp"], ns.gap, ns.stack, ns.substitution,
                    band=ns.band_width,
                    ali_bound=ns.alignment_constraint,
                )

            return kernel_fn

        def kernel_fn(x, y):
            win_lo = win_hi = None
            if ns.alignment_constraint > 0.0:
                from ..models.phmm import posterior_windows

                win_lo, win_hi = posterior_windows(
                    x["codes"], x["length"], y["codes"], y["length"],
                    ns.alignment_constraint, ns.band_width,
                )
            return full_stem_kernel(
                x["codes"], y["codes"], x["length"], y["length"],
                x["bp"], y["bp"], ns.gap, ns.stack, ns.substitution,
                band=0 if win_lo is not None else ns.band_width,
                win_lo=win_lo, win_hi=win_hi,
            )

        return kernel_fn

    run_app(opts, featurize, make_fn, batch_size=16, log_kernel=use_banded)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
