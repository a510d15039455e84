"""CONTRAfold-style conditional log-linear model (CLLM) for folding.

A real replacement for the reference's CONTRAFOLD method, which delegates
posterior computation to libcontrafold
(/root/reference/common/bpmatrix.cpp:264-283, ``CONTRAfold<float>
cf; cf.ComputePosterior(s, posterior)``).  Instead of binding a C++
library, the model itself lives here, in three pieces:

1. **Feature space** — the CONTRAfold v2.02 default (complementary-pair)
   feature classes (Do, Woods & Batzoglou, Bioinformatics 2006): base-pair
   identity, helix stacking, terminal mismatches, helix closings, left/right
   dangles, hairpin/bulge/internal loop lengths, internal asymmetry,
   explicit small-internal-loop sizes, 1x1 internal and 0x1 bulge
   nucleotides, multiloop and external-loop affine weights.  Weights are
   log-potentials (a structure's probability is exp of the feature sum,
   normalized by the partition function) — no temperature, no kcal/mol.

2. **Inference** — :func:`contrafold_energy_params` maps a weight set onto
   the framework's LUT-driven McCaskill engines (fold.tables /
   fold.mccaskill{,_scaled}), so CONTRAfold-model BPPs run at the exact
   same speed as the Turner model: posteriors = the engines' outside
   pass.  The mapping is exact for every feature class above given the
   engine switches added for it (``mismatch_all_hairpins``,
   ``bulge1_no_stack``/``bulge1_nuc``, ``interior_explicit``,
   ``interior_asym_table``, ``ext_paired``/``ext_unpaired``), with two
   documented deviations: (a) helix closings are used
   orientation-symmetrized, (b) bulge-loop junctions score closings but not
   terminal mismatches.

3. **Training** — :func:`train_contrafold` maximizes conditional
   log-likelihood sum_i [score(x_i, y_i) - logZ(x_i)] over (sequence,
   structure) pairs, with gradients from :func:`cf_logZ` — an INDEPENDENT
   differentiable inside pass written directly on the weight arrays (jax
   AD).  ``tests/test_contrafold.py`` pins cf_logZ == engine logZ under the
   mapping for random weights, so the trainer's objective and the fast
   inference path are provably the same model.

Both halves accept any weights produced by :func:`load_contrafold_params`
(text ``feature_name value`` lines, CONTRAfold's parameter-file shape,
including cumulative ``_at_least_`` length features).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .params import (
    EnergyParams,
    KT37,
    MAXLOOP_TAB,
    N_PAIR,
    PAIR_TYPE,
    REV_PAIR,
    STACK_DG,
    TERMINAL_AU_DG,
    _len_table,
)

NEG = -1e30
MIN_HAIRPIN = 3
MAX_INTERIOR = 30
ASYM_DIM = 29  # internal asymmetry |n1 - n2| in 0..28

# (name, shape) schema; scalars use shape ().
SCHEMA: list[tuple[str, tuple]] = [
    ("base_pair", (N_PAIR,)),
    ("helix_stacking", (N_PAIR, N_PAIR)),
    ("terminal_mismatch", (N_PAIR, 4, 4)),
    ("helix_closing", (N_PAIR,)),
    ("dangle_left", (N_PAIR, 4)),
    ("dangle_right", (N_PAIR, 4)),
    ("hairpin_length", (MAXLOOP_TAB + 1,)),
    ("bulge_length", (MAXLOOP_TAB + 1,)),
    ("internal_length", (MAXLOOP_TAB + 1,)),
    ("internal_asymmetry", (ASYM_DIM,)),
    ("internal_explicit", (5, 5)),
    ("internal_1x1_nucleotides", (4, 4)),
    ("bulge_0x1_nucleotides", (4,)),
    ("multi_base", ()),
    ("multi_paired", ()),
    ("multi_unpaired", ()),
    ("external_paired", ()),
    ("external_unpaired", ()),
]

PAIR_STR = ["CG", "GC", "GU", "UG", "AU", "UA"]
_PAIR_IDX = {s: i for i, s in enumerate(PAIR_STR)}
_NUC_IDX = {"A": 0, "C": 1, "G": 2, "U": 3, "T": 3}


def zero_weights() -> dict[str, np.ndarray]:
    return {name: np.zeros(shape) for name, shape in SCHEMA}


def default_weights() -> dict[str, np.ndarray]:
    """Thermodynamically-seeded default weights.

    CONTRAfold's learned parameters famously recover thermodynamics-like
    values; without the published weight file in this offline environment,
    the shipped default seeds the feature space from the transcribed Turner
    core (stacking, loop-length shapes, terminal-AU closings) so
    ``--use-contrafold`` produces sensible posteriors out of the box and
    :func:`train_contrafold` refits from a good starting point.
    """
    w = zero_weights()
    w["helix_stacking"] = -STACK_DG / KT37
    closing = np.zeros(N_PAIR)
    closing[2:] = -TERMINAL_AU_DG / KT37
    w["helix_closing"] = closing
    # impossible sizes are gated structurally (never read), so the unused
    # leading entries stay 0 — a finite weight vector keeps L2/gradients sane
    hp = _len_table(-5.7 / KT37, -1.75, MIN_HAIRPIN, 3)
    bl = _len_table(-3.8 / KT37, -1.75, 1, 1)
    il = _len_table(-1.7 / KT37, -1.75, 2, 2)
    w["hairpin_length"] = np.where(np.isfinite(hp), hp, 0.0)
    w["bulge_length"] = np.where(np.isfinite(bl), bl, 0.0)
    w["internal_length"] = np.where(np.isfinite(il), il, 0.0)
    w["internal_asymmetry"] = np.maximum(-0.6 / KT37 * np.arange(ASYM_DIM),
                                         -3.0 / KT37)
    ex = np.zeros((5, 5))
    for a in range(1, 5):
        for b in range(1, 5):
            ex[a, b] = il[a + b] + max(-0.6 / KT37 * abs(a - b), -3.0 / KT37)
    w["internal_explicit"] = ex
    w["multi_base"] = np.asarray(-3.4 / KT37)
    w["multi_paired"] = np.asarray(-0.4 / KT37)
    return w


def weights_to_vector(w: dict[str, np.ndarray]) -> np.ndarray:
    return np.concatenate(
        [np.asarray(w[name], np.float64).reshape(-1) for name, _ in SCHEMA]
    )


def vector_to_weights(v) -> dict:
    out = {}
    pos = 0
    for name, shape in SCHEMA:
        size = int(np.prod(shape)) if shape else 1
        chunk = v[pos : pos + size]
        out[name] = chunk.reshape(shape) if shape else chunk.reshape(())
        pos += size
    return out


# ---------------------------------------------------------------------------
# Parameter-file loading (CONTRAfold text format: "feature_name value")
# ---------------------------------------------------------------------------

def is_contrafold_params(path: str) -> bool:
    """Sniff: every non-comment line is '<known_feature...> <float>'."""
    prefixes = tuple(name for name, _ in SCHEMA)
    seen = False
    try:
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) != 2 or not parts[0].startswith(prefixes):
                    return False
                try:
                    float(parts[1])
                except ValueError:
                    return False
                seen = True
        return seen
    except OSError:
        return False


def _parse_feature(name: str) -> tuple[str, tuple]:
    """'helix_stacking_CG_AU' -> ('helix_stacking', (0, 4)); raises on junk.

    Length features accept both exact-size (``hairpin_length_7``) and
    CONTRAfold cumulative (``hairpin_length_at_least_7``) spellings; the
    latter is flagged with a trailing ``'cum'`` marker in the index tuple.
    """
    base = None
    for cand, _ in sorted(SCHEMA, key=lambda t: -len(t[0])):
        if name == cand or name.startswith(cand + "_"):
            base = cand
            break
    if base is None:
        raise ValueError(f"unknown CONTRAfold feature {name!r}")
    rest = name[len(base):].strip("_")
    cum = False
    if rest.startswith("at_least_"):
        cum = True
        rest = rest[len("at_least_"):]
    idx: list = []
    for tok in rest.split("_") if rest else []:
        t = tok.upper()
        if t.isdigit():
            idx.append(int(t))
        elif len(t) == 2 and t in _PAIR_IDX:
            idx.append(_PAIR_IDX[t])
        elif len(t) == 1 and t in _NUC_IDX:
            idx.append(_NUC_IDX[t])
        elif len(t) == 2 and t[0] in _NUC_IDX and t[1] in _NUC_IDX:
            # two-nucleotide group that is not a canonical pair (e.g. the
            # AA in internal_1x1_nucleotides_AA): split into two indices
            idx.extend([_NUC_IDX[t[0]], _NUC_IDX[t[1]]])
        else:
            raise ValueError(f"bad token {tok!r} in feature {name!r}")
    if cum:
        idx.append("cum")
    return base, tuple(idx)


def load_contrafold_params(path: str) -> dict[str, np.ndarray]:
    """Load CONTRAfold-format weights (``feature_name value`` lines).

    Unlisted features stay 0 (CONTRAfold's convention).  Cumulative
    ``_at_least_N`` length/asymmetry features add their value to every
    size >= N, reproducing CONTRAfold's length encoding.  Directional
    helix_closing entries for a pair and its reverse are both accepted
    (inference symmetrizes, see :func:`contrafold_energy_params`).
    """
    w = zero_weights()
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"{path}:{lineno}: expected 'name value'")
            try:
                base, idx = _parse_feature(parts[0])
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
            val = float(parts[1])
            arr = w[base]
            if idx and idx[-1] == "cum":
                n0 = int(idx[0])
                arr[min(n0, arr.shape[0] - 1):] += val
            elif not idx:
                w[base] = np.asarray(val)
            else:
                # validate arity/bounds against the SCHEMA array: full
                # CONTRAfold files carry non-canonical tokens (e.g.
                # base_pair_AA splits into two indices against a rank-1
                # array) that would otherwise surface as a bare IndexError
                ints = tuple(int(i) for i in idx)
                if len(ints) != arr.ndim or any(
                    i < 0 or i >= s for i, s in zip(ints, arr.shape)
                ):
                    raise ValueError(
                        f"{path}:{lineno}: feature {parts[0]!r} indexes "
                        f"{base} with {ints}, outside its shape {arr.shape} "
                        "(non-canonical feature outside the complementary "
                        "feature space this model implements)"
                    )
                arr[ints] = val
    return w


def save_contrafold_params(path: str, w: dict) -> None:
    """Write weights in the same text format (exact-size spelling)."""
    with open(path, "w") as f:
        for name, shape in SCHEMA:
            arr = np.asarray(w[name])
            if not shape:
                f.write(f"{name} {float(arr):.10g}\n")
                continue
            for idx in np.ndindex(*shape):
                v = float(arr[idx])
                if v == 0.0:
                    continue
                toks = []
                for ax, i in enumerate(idx):
                    if shape[ax] == N_PAIR:
                        toks.append(PAIR_STR[i])
                    elif shape[ax] == 4:
                        toks.append("ACGU"[i])
                    else:
                        toks.append(str(i))
                f.write(f"{name}_{'_'.join(toks)} {v:.10g}\n")


# ---------------------------------------------------------------------------
# Mapping onto the LUT engines (fast inference path)
# ---------------------------------------------------------------------------

def contrafold_energy_params(w: dict) -> EnergyParams:
    """Express CONTRAfold weights as an EnergyParams for the McCaskill
    engines.  Scores stay in log-potential units (no kT).

    Per-feature mapping (engine lut <- CONTRAfold features):
      pair_bonus      <- base_pair
      stack           <- helix_stacking
      terminal        <- helix_closing (orientation-symmetrized)
      mismatch_h/i/*  <- helix_closing + terminal_mismatch   (junction B)
      mismatch_m/e    <- dangle_left + dangle_right          (junction A;
                         closing arrives via the terminal slot)
      dangle5/3       <- dangle_left / dangle_right
      int11/21/22     <- internal_explicit + junction B both sides
                         (+ internal_1x1_nucleotides for 1x1)
      hairpin/bulge/interior_len <- *_length tables, lxc = 0 (flat clamp
                         beyond 30 = CONTRAfold's at_least encoding)
      interior_asym_table / interior_explicit <- asymmetry / explicit
      ml_close/branch/unpaired <- multi_base/paired/unpaired
      ext_paired/unpaired      <- external_paired/unpaired
      bulge1_nuc      <- bulge_0x1_nucleotides (with bulge1_no_stack)
    """
    cs = 0.5 * (np.asarray(w["helix_closing"])
                + np.asarray(w["helix_closing"])[REV_PAIR])
    tm = np.asarray(w["terminal_mismatch"], np.float64)
    dL = np.asarray(w["dangle_left"], np.float64)
    dR = np.asarray(w["dangle_right"], np.float64)
    mmB = cs[:, None, None] + tm
    mmA = dL[:, :, None] + dR[:, None, :]

    expl = np.asarray(w["internal_explicit"], np.float64)
    expl = 0.5 * (expl + expl.T)
    nuc11 = np.asarray(w["internal_1x1_nucleotides"], np.float64)

    # int11[p, q, x, y] = expl(1,1) + nuc11 + mmB[p, x, y] + mmB[q, y, x]
    int11 = (expl[1, 1] + nuc11[None, None, :, :]
             + mmB[:, None, :, :]
             + np.transpose(mmB, (0, 2, 1))[None, :, :, :])
    # int21[p, q, a, b, c] = expl(1,2) + mmB[p, a, c] + mmB[q, b, a]
    int21 = (expl[1, 2]
             + mmB[:, None, :, None, :]
             + np.transpose(mmB, (0, 2, 1))[None, :, :, :, None])
    # int22[p, q, a, b, c, d] = expl(2,2) + mmB[p, a, d] + mmB[q, c, b]
    int22 = (expl[2, 2]
             + mmB[:, None, :, None, None, :]
             + np.transpose(mmB, (0, 2, 1))[None, :, None, :, :, None])

    def len_tab(name: str, min_size: int) -> np.ndarray:
        t = np.asarray(w[name], np.float64).copy()
        t[:min_size] = -np.inf
        return t

    return EnergyParams(
        stack=np.asarray(w["helix_stacking"], np.float64),
        pair_bonus=np.asarray(w["base_pair"], np.float64),
        terminal=cs,
        hairpin_len=len_tab("hairpin_length", MIN_HAIRPIN),
        bulge_len=len_tab("bulge_length", 1),
        interior_len=len_tab("internal_length", 2),
        lxc=0.0,
        mismatch_h=mmB, mismatch_i=mmB, mismatch_i1n=mmB, mismatch_i23=mmB,
        mismatch_m=mmA, mismatch_e=mmA,
        dangle5=dL, dangle3=dR,
        int11=int11, int21=int21, int22=int22,
        ninio=0.0, ninio_max=0.0,
        ml_close=float(w["multi_base"]),
        ml_branch=float(w["multi_paired"]),
        ml_unpaired=float(w["multi_unpaired"]),
        special_hairpins={},
        max_interior=MAX_INTERIOR,
        min_hairpin=MIN_HAIRPIN,
        ext_unpaired=float(w["external_unpaired"]),
        ext_paired=float(w["external_paired"]),
        mismatch_all_hairpins=True,
        bulge1_no_stack=True,
        bulge1_nuc=np.asarray(w["bulge_0x1_nucleotides"], np.float64),
        interior_explicit=expl,
        interior_asym_table=np.asarray(w["internal_asymmetry"], np.float64),
    )


def contrafold_bpp(seqs: list[str], w: dict | None = None) -> list[np.ndarray]:
    """BPP matrices under the CONTRAfold model (fast engine path)."""
    from .bpmatrix import BPMatrixOptions, fold_sequences

    w = w or default_weights()
    return fold_sequences(seqs, BPMatrixOptions(params=contrafold_energy_params(w)))


# ---------------------------------------------------------------------------
# Differentiable inside pass (training path, independent implementation)
# ---------------------------------------------------------------------------

def _wj(w: dict):
    """Weights as a jnp pytree (f64 when enabled)."""
    return {k: jnp.asarray(v) for k, v in w.items()}


def _offset_lists():
    """Static (a, b) interior/bulge offsets (excluding the (1,1) stack)."""
    bulges, interiors = [], []
    for a in range(1, MAX_INTERIOR + 2):
        for b in range(1, MAX_INTERIOR + 2):
            n1, n2 = a - 1, b - 1
            tot = n1 + n2
            if tot == 0 or tot > MAX_INTERIOR:
                continue
            if n1 == 0 or n2 == 0:
                bulges.append((a, b))
            else:
                interiors.append((a, b))
    return bulges, interiors


_BULGES, _INTERIORS = _offset_lists()

# static gather indices for the differentiable penalty vectors
_B_SIZE = np.array([(a - 1) + (b - 1) for a, b in _BULGES], np.int32)
_I_NS = np.array([min(a - 1, b - 1) for a, b in _INTERIORS], np.int32)
_I_NL = np.array([max(a - 1, b - 1) for a, b in _INTERIORS], np.int32)
_I_EXPL = (_I_NS <= 4) & (_I_NL <= 4)
_I_DIFF = np.minimum(_I_NL - _I_NS, ASYM_DIM - 1).astype(np.int32)


def _pen_vectors(w):
    """Differentiable per-offset penalty vectors (static-index gathers)."""
    expl = 0.5 * (w["internal_explicit"] + w["internal_explicit"].T)
    pen_b = w["bulge_length"][jnp.asarray(_B_SIZE)]
    pen_len = (w["internal_length"][jnp.asarray(_I_NS + _I_NL)]
               + w["internal_asymmetry"][jnp.asarray(_I_DIFF)])
    pen_ex = expl[jnp.asarray(np.clip(_I_NS, 0, 4)),
                  jnp.asarray(np.clip(_I_NL, 0, 4))]
    pen_i = jnp.where(jnp.asarray(_I_EXPL), pen_ex, pen_len)
    return pen_b, pen_i


def cf_logZ(w, codes: np.ndarray, length: int | None = None):
    """Differentiable log partition function under the CONTRAfold model.

    Written directly on the weight arrays (independent of fold.tables);
    must equal the engine logZ under :func:`contrafold_energy_params` —
    pinned by tests.  O(n^2 * MAXLOOP + n^3) with a Python loop over span
    lengths (n is small in training); use inside jit/grad.
    """
    codes = jnp.asarray(codes, jnp.int32)
    n = int(codes.shape[0])
    L = n if length is None else int(length)

    cs6 = 0.5 * (w["helix_closing"] + w["helix_closing"][jnp.asarray(REV_PAIR)])
    tm = w["terminal_mismatch"]
    dLt, dRt = w["dangle_left"], w["dangle_right"]
    rev = jnp.asarray(REV_PAIR)

    ii = jnp.arange(n)
    dmat = ii[None, :] - ii[:, None]
    pt = jnp.asarray(PAIR_TYPE)[codes[:, None], codes[None, :]]
    in_len = ii[None, :] < L
    can = (pt >= 0) & (dmat > MIN_HAIRPIN) & in_len
    ptc = jnp.clip(pt, 0)
    c_ip1 = codes[jnp.clip(ii + 1, 0, n - 1)]
    c_im1 = codes[jnp.clip(ii - 1, 0)]
    c_jm1 = c_im1
    c_jp1 = c_ip1

    gate = jnp.where(can, 0.0, NEG)
    WPAIR = w["base_pair"][ptc] + gate
    CS = cs6[ptc]  # closing of the pair as seen from any adjacent loop
    # junction B factors (x = s[i+1], y = s[j-1]); outer form and the
    # reversed inner form (neighbours s[l+1], s[k-1])
    MMB_OUT = CS + tm[ptc, c_ip1[:, None], c_jm1[None, :]]
    MMB_IN = cs6[rev[ptc]] + tm[rev[ptc], c_jp1[None, :], c_im1[:, None]]
    NUC11 = w["internal_1x1_nucleotides"][c_ip1[:, None], c_jm1[None, :]]
    B0X1 = w["bulge_0x1_nucleotides"]

    sizes = jnp.clip(dmat - 1, 0, MAXLOOP_TAB)
    HAIRPIN = w["hairpin_length"][sizes] + MMB_OUT \
        + jnp.where(dmat - 1 >= MIN_HAIRPIN, 0.0, NEG)

    pt_in = jnp.roll(jnp.roll(pt, -1, 0), 1, 1)  # pair type of (i+1, j-1)
    STK = jnp.where(
        (pt >= 0) & (pt_in >= 0),
        w["helix_stacking"][ptc, jnp.clip(pt_in, 0)], NEG)

    # multiloop stems (junction A), closing stem reversed
    MLSTEM = (w["multi_paired"] + CS
              + dLt[ptc, c_im1[:, None]] + dRt[ptc, c_jp1[None, :]])
    MLCLOSE = (w["multi_base"] + w["multi_paired"] + CS
               + dLt[rev[ptc], c_jm1[None, :]] + dRt[rev[ptc], c_ip1[:, None]])
    # exterior stems: dangles only where a neighbour exists
    has5 = (ii[:, None] >= 1) & jnp.ones((1, n), bool)
    has3 = jnp.ones((n, 1), bool) & ((ii[None, :] + 1) < L)
    EXT = (w["external_paired"] + CS
           + jnp.where(has5, dLt[ptc, c_im1[:, None]], 0.0)
           + jnp.where(has3, dRt[ptc, c_jp1[None, :]], 0.0))

    pen_b, pen_i = _pen_vectors(w)
    c_ml = w["multi_unpaired"]
    c_ext = w["external_unpaired"]

    def diag(mat, d):
        v = jnp.diagonal(mat, offset=d)  # (n - d,)
        return jnp.pad(v, (0, d), constant_values=NEG)

    # span-layout tables [d, i] built row by row (python loop over d)
    neg_row = jnp.full((n,), NEG)
    Qb = [neg_row] * n
    QbC = [neg_row] * n   # Qb + closing of the pair (bulge inner factor)
    QbM = [neg_row] * n   # Qb + junction-B inner factor
    QbS = [neg_row] * n   # Qb + multiloop branch factor
    Qm1 = [neg_row] * n
    Qm = [neg_row] * n
    Qm2 = [neg_row] * n

    CSd = [diag(CS, d) for d in range(n)]
    MMINd = [diag(MMB_IN, d) for d in range(n)]
    MLSTEMd = [diag(MLSTEM, d) for d in range(n)]

    def shifted(rows, d_inner, shift):
        if d_inner < 0:
            return neg_row
        r = rows[d_inner]
        return jnp.concatenate([r[shift:], jnp.full((shift,), NEG)]) \
            if shift else r

    for d in range(MIN_HAIRPIN + 1, n):
        terms = [diag(HAIRPIN, d)]
        # stack
        terms.append(diag(STK, d) + shifted(Qb, d - 2, 1))
        # bulges: closing both ends, no mismatch; 0x1 nucleotide for size 1
        vb = []
        for k, (a, b) in enumerate(_BULGES):
            dd = d - a - b
            if dd <= MIN_HAIRPIN:
                continue
            extra = 0.0
            if (a, b) == (2, 1):
                extra = B0X1[c_ip1]  # bulged base s[i+1], vector over i
            elif (a, b) == (1, 2):
                extra = B0X1[codes[jnp.clip(ii + d - 1, 0, n - 1)]]  # s[j-1]
            vb.append(pen_b[k] + extra + shifted(QbC, dd, a))
        # interiors: junction B both sides (+1x1 nucleotides)
        vi = []
        for k, (a, b) in enumerate(_INTERIORS):
            dd = d - a - b
            if dd <= MIN_HAIRPIN:
                continue
            v = pen_i[k] + shifted(QbM, dd, a)
            if (a, b) == (2, 2):
                v = v + diag(NUC11, d)
            vi.append(v)
        if vb or vi:
            loops_i = (jax.nn.logsumexp(jnp.stack(vi), axis=0)
                       + diag(MMB_OUT, d)) if vi else neg_row
            loops_b = (jax.nn.logsumexp(jnp.stack(vb), axis=0)
                       + diag(CS, d)) if vb else neg_row
            terms.append(jnp.logaddexp(loops_i, loops_b))
        # multiloop
        terms.append(diag(MLCLOSE, d) + shifted(Qm2, d - 2, 1))

        qb_row = diag(WPAIR, d) + jax.nn.logsumexp(jnp.stack(terms), axis=0)
        valid = (ii + d < n)
        qb_row = jnp.where(valid, qb_row, NEG)
        Qb[d] = qb_row
        QbC[d] = qb_row + CSd[d]
        QbM[d] = qb_row + MMINd[d]
        QbS[d] = qb_row + MLSTEMd[d]

        # Qm1[i, j] = (Qm1[i, j-1] + c) ⊕ (ml_stem + Qb)
        qm1_row = jnp.logaddexp(Qm1[d - 1] + c_ml, QbS[d])
        Qm1[d] = jnp.where(valid, qm1_row, NEG)
        # Qm2[i, j] = sum_{t>=1} Qm[i, i+t-1] + Qm1[i+t, j]
        vals = [Qm[t - 1] + shifted(Qm1, d - t, t) for t in range(1, d + 1)]
        qm2_row = jax.nn.logsumexp(jnp.stack(vals), axis=0)
        Qm2[d] = jnp.where(valid, qm2_row, NEG)
        # Qm[i, j] = Qm2 ⊕ sum_{t>=0} t*c + Qm1[i+t, j]
        vals = [t * c_ml + shifted(Qm1, d - t, t) for t in range(0, d + 1)]
        qm_row = jnp.logaddexp(
            Qm2[d], jax.nn.logsumexp(jnp.stack(vals), axis=0))
        Qm[d] = jnp.where(valid, qm_row, NEG)

    # exterior chain
    QbE = [Qb[d] + diag(EXT, d) for d in range(n)]
    ql = [jnp.asarray(0.0)] + [None] * n  # ql[j+1] = log Ql[j]
    for j in range(n):
        branches = [ql[k] + QbE[j - k][k] for k in range(j - MIN_HAIRPIN)]
        unp = ql[j] + (c_ext if j < L else 0.0)
        if branches and j < L:
            ql[j + 1] = jnp.logaddexp(
                unp, jax.nn.logsumexp(jnp.stack(branches)))
        else:
            ql[j + 1] = unp
    return ql[L]


def cf_structure_score(w, codes: np.ndarray, pairs) -> jax.Array:
    """Differentiable CONTRAfold score of one structure (feature sum).

    Mirrors the loop decomposition the engines integrate over (the Vienna
    shape with the CONTRAfold junction semantics from the mapping).
    """
    s = np.asarray(codes)
    n = len(s)
    pairs = sorted(tuple(p) for p in pairs)
    pair_of = dict(pairs)
    rev = REV_PAIR
    cs6 = 0.5 * (w["helix_closing"] + w["helix_closing"][jnp.asarray(rev)])

    def pt(i, j):
        t = int(PAIR_TYPE[s[i], s[j]])
        if t < 0:
            raise ValueError(f"non-canonical pair ({i},{j})")
        return t

    def junction_b(t, x, y):
        return cs6[t] + w["terminal_mismatch"][t, x, y]

    def children_of(i, j):
        out, k = [], i + 1
        while k < j:
            if k in pair_of and pair_of[k] < j:
                out.append((k, pair_of[k]))
                k = pair_of[k] + 1
            else:
                k += 1
        return out

    total = jnp.asarray(0.0)
    ext = children_of(-1, n)
    total = total + w["external_unpaired"] * (
        n - sum(l - k + 1 for (k, l) in ext))
    for (k, l) in ext:
        t = pt(k, l)
        total = total + w["external_paired"] + cs6[t]
        if k > 0:
            total = total + w["dangle_left"][t, s[k - 1]]
        if l < n - 1:
            total = total + w["dangle_right"][t, s[l + 1]]

    expl = 0.5 * (w["internal_explicit"] + w["internal_explicit"].T)
    for (i, j) in pairs:
        t = pt(i, j)
        total = total + w["base_pair"][t]
        ch = children_of(i, j)
        if not ch:
            size = j - i - 1
            if size < MIN_HAIRPIN:
                raise ValueError("hairpin below minimum size")
            total = total + w["hairpin_length"][min(size, MAXLOOP_TAB)] \
                + junction_b(t, s[i + 1], s[j - 1])
        elif len(ch) == 1:
            (k, l) = ch[0]
            t2 = pt(k, l)
            n1, n2 = k - i - 1, j - l - 1
            ns, nl = min(n1, n2), max(n1, n2)
            if nl == 0:
                total = total + w["helix_stacking"][t, t2]
            elif ns == 0:
                total = total + w["bulge_length"][min(nl, MAXLOOP_TAB)] \
                    + cs6[t] + cs6[t2]
                if nl == 1:
                    bulged = s[i + 1] if n1 == 1 else s[j - 1]
                    total = total + w["bulge_0x1_nucleotides"][bulged]
            else:
                if ns <= 4 and nl <= 4:
                    total = total + expl[ns, nl]
                else:
                    total = total + w["internal_length"][ns + nl] \
                        + w["internal_asymmetry"][min(nl - ns, ASYM_DIM - 1)]
                if (ns, nl) == (1, 1):
                    total = total + w["internal_1x1_nucleotides"][
                        s[i + 1], s[j - 1]]
                total = total + junction_b(t, s[i + 1], s[j - 1]) \
                    + junction_b(rev[t2], s[l + 1], s[k - 1])
        else:
            unpaired = (j - i - 1) - sum(l - k + 1 for (k, l) in ch)
            total = total + w["multi_base"] + w["multi_paired"] + cs6[t] \
                + w["dangle_left"][rev[t], s[j - 1]] \
                + w["dangle_right"][rev[t], s[i + 1]] \
                + w["multi_unpaired"] * unpaired
            for (k, l) in ch:
                t2 = pt(k, l)
                total = total + w["multi_paired"] + cs6[t2] \
                    + w["dangle_left"][t2, s[k - 1]] \
                    + w["dangle_right"][t2, s[l + 1]]
    return total


# ---------------------------------------------------------------------------
# Training (maximum conditional likelihood)
# ---------------------------------------------------------------------------

def parse_dotbracket(db: str) -> tuple[tuple[int, int], ...]:
    stack, out = [], []
    for i, c in enumerate(db):
        if c == "(":
            stack.append(i)
        elif c == ")":
            out.append((stack.pop(), i))
    if stack:
        raise ValueError("unbalanced dot-bracket")
    return tuple(sorted(out))


def train_contrafold(
    examples: list[tuple[str, str]],
    *,
    init: dict | None = None,
    steps: int = 200,
    lr: float = 0.05,
    l2: float = 1e-4,
) -> tuple[dict, list[float]]:
    """Fit CONTRAfold weights by maximum conditional likelihood.

    ``examples``: (sequence, dot-bracket structure) pairs.  Returns
    (weights, loss history); loss = -sum_i log P(y_i | x_i) + l2*|w|^2,
    gradients by jax AD through :func:`cf_logZ`.  Matches the reference
    CLLM's training principle (CONTRAfold trains by conditional likelihood;
    the reference consumes the trained model for posteriors).
    """
    import optax

    from ..io.alphabet import encode

    data = []
    for seq, db in examples:
        codes = encode(seq)
        pairs = parse_dotbracket(db)
        data.append((codes, pairs))

    w0 = init if init is not None else default_weights()
    vec0 = jnp.asarray(weights_to_vector(w0))

    # one jitted value_and_grad PER EXAMPLE: XLA compile time grows
    # superlinearly with graph size, so N small programs beat one huge one
    def make_vg(codes, pairs):
        def nll(vec):
            w = vector_to_weights(vec)
            return cf_logZ(w, codes) - cf_structure_score(w, codes, pairs)

        return jax.jit(jax.value_and_grad(nll))

    vgs = [make_vg(codes, pairs) for codes, pairs in data]

    opt = optax.adam(lr)
    state = opt.init(vec0)
    vec = vec0
    history = []
    for _ in range(steps):
        total = l2 * float(jnp.sum(vec * vec))
        g = 2.0 * l2 * vec
        for vg in vgs:
            val_i, g_i = vg(vec)
            total += float(val_i)
            g = g + g_i
        history.append(total)
        updates, state = opt.update(g, state)
        vec = optax.apply_updates(vec, updates)
    out = {k: np.asarray(v) for k, v in vector_to_weights(np.asarray(vec)).items()}
    return out, history
