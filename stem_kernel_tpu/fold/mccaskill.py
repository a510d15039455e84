"""McCaskill partition function + base-pair probabilities, batched in JAX.

In-framework replacement for the reference's Vienna `pf_fold` calls
(/root/reference/common/bpmatrix.cpp:151-177, common/pf_wrapper.cpp:15-36),
implementing the full Vienna-structured energy model (see fold.params and
fold.tables for the loop-class taxonomy).

Design:

- all DP tables live in **span layout** ``T[d, i]`` = value of subsequence
  (i, i+d), so each anti-diagonal of the classic triangular tables is one
  contiguous row — the scan over span length d does O(n)-to-O(n^2) of fully
  vectorized work per step instead of per-cell updates;
- everything is **log-space** (logaddexp/logsumexp), which makes Vienna's
  `pf_scale` overflow machinery (bpmatrix.cpp:158-165) unnecessary;
- split-point sums (multiloop segment composition) are batched gathers over
  shifted rows, the O(n^3) core;
- interior loops enumerate static (a, b) offset lists bounded by
  ``max_interior`` exactly like Vienna's MAXLOOP bound, split into Vienna's
  loop classes (generic / 1xn / 2x3 / bulge) with per-class mismatch tables
  and explicit terms for stack, bulge-1, int11, int21, int22;
- base-pair probabilities come from an **explicit outside pass** (same span
  layout, scanned top-down), keeping memory at O(n^2) — reverse-mode AD
  through the inside scan would store O(n^3) residuals.  The identity
  bpp = d logZ / d w_pair is used in tests as an independent oracle.

Recursions (log-space; ⊕ = logaddexp; luts from fold.tables):
    Qb[i,j] = wpair[i,j] + ( hairpin[i,j]
                ⊕ stack[i,j] + Qb[i+1,j-1]
                ⊕ bulge1/int11/int21/int22 lut terms
                ⊕ (+)_{class, a,b} pen_cls(a,b) + mm_out_cls[i,j]
                        + mm_in_cls[i+a,j-b] + Qb[i+a,j-b]
                ⊕ ml_close[i,j] + Qm2[i+1,j-1] )
    Qm1[i,j] = (Qm1[i,j-1] + c) ⊕ (ml_stem[i,j] + Qb[i,j])
    Qm2[i,j] = (+)_{t>=1} Qm[i,i+t-1] + Qm1[i+t,j]
    Qm[i,j]  = Qm2[i,j] ⊕ (+)_{t>=0} t*c + Qm1[i+t,j]
    Ql[j]    = Ql[j-1] ⊕ (+)_k Ql[k-1] + Qb[k,j] + ext_stem[k,j]
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .params import EnergyParams, default_params, loop_len_score
from .tables import build_luts

NEG = -1e30

# interior-loop class ids for the offset sweep
_CLS_GEN, _CLS_1N, _CLS_23, _CLS_BUL = 0, 1, 2, 3


def _interior_offsets(params: EnergyParams):
    """Static (a, b, penalty, class) offset lists for the loop-class sweep.

    Covers every interior/bulge with a lut-free penalty: generic, 1xn, 2x3
    and bulges >= 2.  Stack/bulge-1/int11/int21/int22 are explicit lut terms.
    """
    offs, pens, clss = [], [], []
    fast = getattr(params, "fast", False)
    for a in range(1, params.max_interior + 2):
        for b in range(1, params.max_interior + 2):
            n1, n2 = a - 1, b - 1
            if n1 + n2 > params.max_interior:
                continue
            ns, nl = min(n1, n2), max(n1, n2)
            if nl == 0:
                continue  # stack: always an explicit lut term
            if not fast and (ns >= 1 and nl <= 2 and ns <= 2 and (ns, nl) in (
                    (1, 1), (1, 2), (2, 2))):
                continue  # int11 / int21 / int22: explicit luts (full model)
            if ns == 0:
                if nl == 1 and not fast:
                    continue  # bulge-1: explicit lut (keeps stacking)
                # fast tier: bulge-1 rides the generic bulge length table
                pen = float(loop_len_score(params.bulge_len, params.lxc, nl))
                cls = 1 if fast else _CLS_BUL
            elif fast:
                # fast tier: ONE interior class (generic mismatch) with the
                # generic length + NINIO asymmetry formula for every loop,
                # including the 1x1/2x1/2x2 and 1xn/2x3 specials
                asym = max(params.ninio * (nl - ns), params.ninio_max)
                if params.interior_asym_table is not None:
                    at = params.interior_asym_table
                    asym = float(at[min(nl - ns, len(at) - 1)])
                pen = float(
                    loop_len_score(params.interior_len, params.lxc, ns + nl)
                ) + asym
                cls = 0
            else:
                if params.interior_asym_table is not None:
                    at = params.interior_asym_table
                    asym = float(at[min(nl - ns, len(at) - 1)])
                else:
                    asym = max(params.ninio * (nl - ns), params.ninio_max)
                pen = float(
                    loop_len_score(params.interior_len, params.lxc, ns + nl)
                ) + asym
                if (params.interior_explicit is not None
                        and ns <= 4 and nl <= 4):
                    # CONTRAfold internal_explicit: total (length+asymmetry)
                    # score for small loops (1x1/1x2/2x2 ride the luts)
                    pen = float(params.interior_explicit[ns, nl])
                if ns == 1:  # nl >= 3 here
                    cls = _CLS_1N
                elif ns == 2 and nl == 3:
                    cls = _CLS_23
                else:
                    cls = _CLS_GEN
            offs.append((a, b))
            pens.append(pen)
            clss.append(cls)
    offs = np.asarray(offs, dtype=np.int32)
    return (offs[:, 0], offs[:, 1], np.asarray(pens),
            np.asarray(clss, dtype=np.int32))


_EXPLICIT_TERMS = (
    ("bulge1_l", 3, 2), ("bulge1_r", 3, 1),
    ("int11", 4, 2),
    ("int21_l", 5, 2), ("int21_r", 5, 3),
    ("int22", 6, 3),
)


def _explicit_terms(params):
    """Explicit small-loop lut terms; empty in the fast tier."""
    return () if getattr(params, "fast", False) else _EXPLICIT_TERMS


def _class_lut_names(params):
    """(out, in) mismatch-lut names per loop class; 2 classes in fast."""
    if getattr(params, "fast", False):
        return (("mm_i_out", "term_out"), ("mm_i_in", "term_in"))
    return (("mm_i_out", "mm_1n_out", "mm_23_out", "term_out"),
            ("mm_i_in", "mm_1n_in", "mm_23_in", "term_in"))


def _span_gather(table: jax.Array, rows: jax.Array, cols: jax.Array) -> jax.Array:
    """table[rows, cols] with out-of-range -> NEG.  rows/cols broadcast."""
    n = table.shape[-1]
    valid = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < n)
    flat = jnp.clip(rows, 0, n - 1) * n + jnp.clip(cols, 0, n - 1)
    return jnp.where(valid, jnp.take(table.reshape(-1), flat), NEG)


def _luts_f(codes, length, params, w_extra, dt, pt_ov=None):
    luts = build_luts(codes, length, params, w_extra, pt_override=pt_ov)
    return {k: v.astype(dt) for k, v in luts.items()}


@partial(jax.jit, static_argnums=(2,))
def _inside(codes: jax.Array, length: jax.Array, params_key, w_extra, pt_ov, ia, ib, ipen, icls, dt_probe):
    """Inside pass.  Returns span-layout tables + luts dict."""
    params = _PARAMS_REGISTRY[params_key]
    n = codes.shape[-1]  # codes may be (R, n) alignment rows (true alifold)
    dt = dt_probe.dtype
    L = _luts_f(codes, length, params, w_extra, dt, pt_ov)

    i_idx = jnp.arange(n)
    t_idx = jnp.arange(n)  # split offsets
    c_ml = dt.type(params.ml_unpaired)

    def ij_diag(mat, d):
        # mat is [i, j]-layout; return mat[i, i+d] as a vector over i
        return _span_gather(mat, i_idx, i_idx + d)

    # class tables: mm_out rows gathered per step; mm_in folded into shadow
    # copies of Qb (QbX[d, i] = Qb[d, i] + mm_in_cls[i, i+d])
    out_names, in_names = _class_lut_names(params)
    cls_out = [L[nm] for nm in out_names]
    cls_in = [L[nm] for nm in in_names]
    ncls = len(cls_out)

    full = lambda: jnp.full((n, n), NEG, dt)
    init = (
        full(),  # Qb   (span layout [d, i])
        [full() for _ in range(ncls)],  # class-weighted Qb shadows
        full(),  # Qm1
        full(),  # Qm
        full(),  # Qm2
    )

    def step(carry, d):
        Qb, QbX, Qm1, Qm, Qm2 = carry
        w_row = ij_diag(L["wpair"], d)  # (n,)

        # hairpin (full lut: length + mismatch/terminal + specials + gates)
        acc = ij_diag(L["hairpin"], d)

        # stack (a=b=1)
        acc = jnp.logaddexp(
            acc, ij_diag(L["stack"], d)
            + _span_gather(Qb, jnp.full((n,), d - 2), i_idx + 1)
        )
        # explicit small-loop luts: (lut, inner span offset, inner start
        # shift); empty in the fast tier (params.fast)
        for name, ds, sh in _explicit_terms(params):
            acc = jnp.logaddexp(
                acc, ij_diag(L[name], d)
                + _span_gather(Qb, jnp.full((n,), d - ds), i_idx + sh)
            )

        # class sweep over (a, b) offsets: gather the class-weighted Qb
        # shadow per offset from one concatenated (4n, n) table
        rows = d - (ia + ib)  # (K,)
        out_k = jnp.stack(
            [ij_diag(cls_out[c], d) for c in range(ncls)], axis=0
        )  # (ncls, n)
        qb_cat = jnp.concatenate(QbX, axis=0)  # (ncls*n, n)
        cols = i_idx[None, :] + ia[:, None]
        r2 = rows[:, None]
        valid = (r2 >= 0) & (r2 < n) & (cols >= 0) & (cols < n)
        flat = (icls[:, None] * n + jnp.clip(r2, 0, n - 1)) * n + jnp.clip(cols, 0, n - 1)
        inner = jnp.where(valid, jnp.take(qb_cat.reshape(-1), flat), NEG)
        it = ipen[:, None] + out_k[icls] + inner
        acc = jnp.logaddexp(acc, jax.nn.logsumexp(it, axis=0))

        # multiloop closing (lut includes a + b + terminal + mismatch + gate)
        ml = ij_diag(L["ml_close"], d) + _span_gather(
            Qm2, jnp.full((n,), d - 2), i_idx + 1
        )
        acc = jnp.logaddexp(acc, ml)

        qb_row = w_row + acc

        # Qm1 incremental; branch lut includes b + terminal + mismatch_m
        qm1_row = jnp.logaddexp(
            Qm1[d - 1] + c_ml, ij_diag(L["ml_stem"], d) + qb_row
        )

        # split gathers: A[t, i] = Qm1[i+t, i+d] (span d-t)
        A = _span_gather(Qm1, (d - t_idx)[:, None], i_idx[None, :] + t_idx[:, None])
        A = A.at[0].set(qm1_row)  # t = 0 uses this step's fresh row
        # B[t, i] = Qm[i, i+t-1] (span t-1); t = 0 row invalid -> NEG
        B = _span_gather(Qm, (t_idx - 1)[:, None], jnp.broadcast_to(i_idx, (n, n)))

        qm2_row = jax.nn.logsumexp(jnp.where(t_idx[:, None] >= 1, B + A, NEG), axis=0)
        unp = jax.nn.logsumexp(c_ml * t_idx[:, None].astype(dt) + A, axis=0)
        qm_row = jnp.logaddexp(qm2_row, unp)

        Qb = Qb.at[d].set(qb_row)
        QbX = [
            QbX[c].at[d].set(qb_row + ij_diag(cls_in[c], d))
            for c in range(ncls)
        ]
        Qm1 = Qm1.at[d].set(qm1_row)
        Qm = Qm.at[d].set(qm_row)
        Qm2 = Qm2.at[d].set(qm2_row)
        return (Qb, QbX, Qm1, Qm, Qm2), None

    (Qb, QbX, Qm1, Qm, Qm2), _ = jax.lax.scan(step, init, jnp.arange(1, n))

    # external chain over prefixes: Ql[j], with Ql[-1] = 0 at index 0
    ext_diag = jnp.arange(n)
    QbE = Qb + _span_gather(
        L["ext_stem"], i_idx[None, :], i_idx[None, :] + ext_diag[:, None]
    )  # span layout: ext_stem[i, i+d] added to Qb[d, i]

    c_ext = dt.type(params.ext_unpaired)

    def ext_step(ql, j):
        prev = ql[j]  # Ql[j-1]
        qb_col = _span_gather(QbE, j - i_idx, i_idx)  # QbE[k, j] over k
        paired = jax.nn.logsumexp(ql[:n] + qb_col, axis=0)
        val = jnp.logaddexp(prev + c_ext, paired)
        val = jnp.where(j < length, val, prev)
        ql = ql.at[j + 1].set(val)
        return ql, None

    ql0 = jnp.concatenate([jnp.zeros((1,), dt), jnp.full((n,), NEG, dt)])
    ql, _ = jax.lax.scan(ext_step, ql0, jnp.arange(n))
    logZ = ql[length]
    return Qb, QbE, Qm1, Qm, Qm2, ql, logZ


@partial(jax.jit, static_argnums=(2,))
def _outside(codes, length, params_key, w_extra, pt_ov, ia, ib, ipen, icls,
             Qb, QbE, Qm1, Qm, Qm2, ql, logZ):
    """Outside pass: log outside values for Qb, then base-pair probabilities.

    Mirrors the inside recursions in reverse (span scanned top-down); each
    outside table receives the derivative flow of every inside use site.
    Finally bpp[i,j] = exp(Qb[i,j] + Ob[i,j] - logZ).
    """
    params = _PARAMS_REGISTRY[params_key]
    n = codes.shape[-1]  # codes may be (R, n) alignment rows (true alifold)
    dt = Qb.dtype
    L = _luts_f(codes, length, params, w_extra, dt, pt_ov)

    i_idx = jnp.arange(n)
    u_idx = jnp.arange(n)
    c_ml = dt.type(params.ml_unpaired)

    out_names, in_names = _class_lut_names(params)
    cls_out = [L[nm] for nm in out_names]
    cls_in = [L[nm] for nm in in_names]
    ncls = len(cls_out)

    # --- outside of the external chain: OQl[j] over j ---
    c_ext = dt.type(params.ext_unpaired)

    def oql_step(oql, j):
        unpaired = jnp.where(
            j + 1 < length, jnp.take(oql, jnp.clip(j + 1, 0, n - 1)), dt.type(NEG)
        )
        # pairs (j+1, l): QbE[j+1, l] = QbE_span[l-(j+1), j+1]
        qb_vec = _span_gather(QbE, u_idx - (j + 1), jnp.full((n,), j + 1))
        paired = jax.nn.logsumexp(qb_vec + oql, axis=0)
        val = jnp.logaddexp(unpaired + c_ext, paired)
        val = jnp.where(j == length - 1, dt.type(0.0), val)
        val = jnp.where(j > length - 1, dt.type(NEG), val)
        oql = oql.at[j].set(val)
        return oql, None

    oql0 = jnp.full((n,), NEG, dt)
    oql, _ = jax.lax.scan(oql_step, oql0, jnp.arange(n - 1, -1, -1))

    def ij_gather(mat, r, c):
        return _span_gather(mat, r, c)

    full = lambda: jnp.full((n, n), NEG, dt)
    init = (full(), full(), full(), full())  # Ob, Om1, Om, Om2

    def step(carry, D):
        Ob, Om1, Om, Om2 = carry
        j = i_idx + D  # right end per start i

        # --- Om[D][i]: from Qm2 splits with left part Qm[i, i+D] ---
        A2 = _span_gather(Qm1, (u_idx - D - 1)[:, None], jnp.broadcast_to(i_idx + D + 1, (n, n))) \
            + _span_gather(Om2, u_idx[:, None], jnp.broadcast_to(i_idx, (n, n)))
        om_row = jax.nn.logsumexp(jnp.where(u_idx[:, None] > D, A2, NEG), axis=0)
        Om = Om.at[D].set(om_row)

        # --- Om2[D][i]: multiloop closing by pair (i-1, j+1); plus Qm flow ---
        close = ij_gather(Ob, jnp.full((n,), D + 2), i_idx - 1)  # Ob_span[D+2, i-1]
        close = close + ij_gather(L["wpair"], i_idx - 1, j + 1) \
            + ij_gather(L["ml_close"], i_idx - 1, j + 1)
        om2_row = jnp.logaddexp(close, om_row)
        Om2 = Om2.at[D].set(om2_row)

        # --- Om1[D][i] ---
        inc = Om1[jnp.clip(D + 1, 0, n - 1)] + c_ml
        inc = jnp.where(D + 1 < n, inc, NEG)
        # (b) split right part: t >= 1: Qm[t-1, i-t] + Om2[D+t, i-t]
        Tb = _span_gather(Qm, (u_idx - 1)[:, None], i_idx[None, :] - u_idx[:, None]) \
            + _span_gather(Om2, (D + u_idx)[:, None], i_idx[None, :] - u_idx[:, None])
        term_b = jax.nn.logsumexp(jnp.where(u_idx[:, None] >= 1, Tb, NEG), axis=0)
        # (c) unpaired prefix: t >= 0: c*t + Om[D+t, i-t]
        Tc = c_ml * u_idx[:, None].astype(dt) \
            + _span_gather(Om, (D + u_idx)[:, None], i_idx[None, :] - u_idx[:, None])
        term_c = jax.nn.logsumexp(Tc, axis=0)
        om1_row = jnp.logaddexp(jnp.logaddexp(inc, term_b), term_c)
        Om1 = Om1.at[D].set(om1_row)

        # --- Ob[D][i] ---
        # exterior: Ql[i-1] + OQl[j] + ext_stem[i, j]
        ext = ql[jnp.clip(i_idx, 0, n)] \
            + jnp.where(j < n, jnp.take(oql, jnp.clip(j, 0, n - 1)), dt.type(NEG)) \
            + ij_gather(L["ext_stem"], i_idx, j)
        # stack as inner pair of (i-1, j+1)
        stk = ij_gather(Ob, jnp.full((n,), D + 2), i_idx - 1) \
            + ij_gather(L["wpair"], i_idx - 1, j + 1) \
            + ij_gather(L["stack"], i_idx - 1, j + 1)
        acc = jnp.logaddexp(ext, stk)
        # explicit small-loop luts as inner pair of (i-sh, j+(ds-sh));
        # empty in the fast tier
        for name, ds, sh in _explicit_terms(params):
            t = ij_gather(Ob, jnp.full((n,), D + ds), i_idx - sh) \
                + ij_gather(L["wpair"], i_idx - sh, j + (ds - sh)) \
                + ij_gather(L[name], i_idx - sh, j + (ds - sh))
            acc = jnp.logaddexp(acc, t)
        # class sweep as inner pair of (i-a, j+b); add this pair's mm_in after
        out_cat = jnp.concatenate(cls_out, axis=0)  # (ncls*n, n) [i, j]
        ro = i_idx[None, :] - ia[:, None]
        co = j[None, :] + ib[:, None]
        valid_o = (ro >= 0) & (ro < n) & (co >= 0) & (co < n)
        flat_o = (icls[:, None] * n + jnp.clip(ro, 0, n - 1)) * n + jnp.clip(co, 0, n - 1)
        out_lut = jnp.where(valid_o, jnp.take(out_cat.reshape(-1), flat_o), NEG)
        it = ipen[:, None] \
            + _span_gather(Ob, (D + ia + ib)[:, None], ro) \
            + ij_gather(L["wpair"], ro, co) \
            + out_lut
        in_sel = jnp.stack(
            [ij_gather(cls_in[c], i_idx, j) for c in range(ncls)], axis=0
        )  # (ncls, n)
        acc = jnp.logaddexp(
            acc, jax.nn.logsumexp(it + in_sel[icls], axis=0)
        )
        # multiloop branch entry (lut includes b + terminal + mismatch)
        acc = jnp.logaddexp(acc, ij_gather(L["ml_stem"], i_idx, j) + om1_row)
        Ob = Ob.at[D].set(acc)

        return (Ob, Om1, Om, Om2), None

    (Ob, Om1, Om, Om2), _ = jax.lax.scan(step, init, jnp.arange(n - 1, 0, -1))

    # bpp in [i, j] layout
    dgrid = i_idx[None, :] - i_idx[:, None]  # j - i
    qb_ij = _span_gather(Qb, dgrid, jnp.broadcast_to(i_idx[:, None], (n, n)))
    ob_ij = _span_gather(Ob, dgrid, jnp.broadcast_to(i_idx[:, None], (n, n)))
    bpp = jnp.where(dgrid > 0, jnp.exp(qb_ij + ob_ij - logZ), 0.0)
    return bpp


# params objects are static to jit; register them by CONTENT digest so two
# equal EnergyParams (e.g. repeated default_params() calls) hit the same
# compiled program instead of retracing per object identity.
_PARAMS_REGISTRY: dict[str, EnergyParams] = {}


def _register(params: EnergyParams) -> str:
    import hashlib

    h = hashlib.sha1()
    for f in (
        params.stack, params.pair_bonus, params.terminal,
        params.hairpin_len, params.bulge_len, params.interior_len, params.lxc,
        params.mismatch_h, params.mismatch_i, params.mismatch_i1n,
        params.mismatch_i23, params.mismatch_m, params.mismatch_e,
        params.dangle5, params.dangle3,
        params.int11, params.int21, params.int22,
        params.ninio, params.ninio_max,
        params.ml_close, params.ml_branch, params.ml_unpaired,
        params.max_interior, params.min_hairpin,
        params.no_gu, params.no_closing_gu, params.no_lonely_pairs,
        params.ext_unpaired, params.ext_paired, params.mismatch_all_hairpins,
        params.bulge1_no_stack, getattr(params, "fast", False),
        np.zeros(4) if params.bulge1_nuc is None else params.bulge1_nuc,
        np.zeros(1) if params.interior_explicit is None
        else params.interior_explicit,
        np.zeros(1) if params.interior_asym_table is None
        else params.interior_asym_table,
    ):
        h.update(np.nan_to_num(
            np.asarray(f, np.float64), neginf=-1e300
        ).tobytes())
    for seq in sorted(params.special_hairpins):
        h.update(seq.encode())
        h.update(np.float64(params.special_hairpins[seq]).tobytes())
    key = h.hexdigest()
    _PARAMS_REGISTRY.setdefault(key, params)
    return key


def _prep(params: EnergyParams, dtype):
    ia, ib, ipen, icls = _interior_offsets(params)
    return (jnp.asarray(ia), jnp.asarray(ib), jnp.asarray(ipen, dtype),
            jnp.asarray(icls))


def mccaskill_logZ(
    seq_codes: np.ndarray,
    length: int | None = None,
    params: EnergyParams | None = None,
    *,
    w_extra: np.ndarray | None = None,
    pt_override: np.ndarray | None = None,
    dtype=jnp.float32,
) -> float:
    """Log partition function of a single sequence (codes in A,C,G,U=0..3)."""
    params = params or default_params()
    codes = jnp.asarray(seq_codes, jnp.int32)
    length = codes.shape[0] if length is None else length
    ia, ib, ipen, icls = _prep(params, dtype)
    key = _register(params)
    *_, logZ = _inside(codes, jnp.asarray(length), key,
                       None if w_extra is None else jnp.asarray(w_extra, dtype),
                       None if pt_override is None else jnp.asarray(pt_override, jnp.int32),
                       ia, ib, ipen, icls, jnp.zeros((), dtype))
    return float(logZ)


def mccaskill_bpp(
    seq_codes: np.ndarray,
    length: int | None = None,
    params: EnergyParams | None = None,
    *,
    w_extra: np.ndarray | None = None,
    pt_override: np.ndarray | None = None,
    dtype=jnp.float32,
) -> tuple[np.ndarray, float]:
    """(bpp, logZ) for one sequence; bpp[i, j] = P(i pairs j), i < j, 0-based.

    The in-framework replacement for Vienna pf_fold + pr-matrix extraction
    (/root/reference/common/bpmatrix.cpp:166-174, common/pf_wrapper.cpp:15-36).
    """
    params = params or default_params()
    codes = jnp.asarray(seq_codes, jnp.int32)
    length = codes.shape[0] if length is None else length
    ia, ib, ipen, icls = _prep(params, dtype)
    key = _register(params)
    we = None if w_extra is None else jnp.asarray(w_extra, dtype)
    po = None if pt_override is None else jnp.asarray(pt_override, jnp.int32)
    Qb, QbE, Qm1, Qm, Qm2, ql, logZ = _inside(
        codes, jnp.asarray(length), key, we, po, ia, ib, ipen, icls,
        jnp.zeros((), dtype),
    )
    bpp = _outside(
        codes, jnp.asarray(length), key, we, po, ia, ib, ipen, icls,
        Qb, QbE, Qm1, Qm, Qm2, ql, logZ,
    )
    return np.asarray(bpp), float(logZ)


def mccaskill_bpp_batch(
    codes_batch: np.ndarray,
    lengths: np.ndarray,
    params: EnergyParams | None = None,
    *,
    dtype=jnp.float32,
    engine: str = "scaled",
) -> tuple[np.ndarray, np.ndarray]:
    """Batched (bpp, logZ) over padded code arrays (B, n).

    ``engine="scaled"`` (default) runs the whole batch as ONE vmapped
    device program in the scaled linear domain (see
    :mod:`.mccaskill_scaled`) — no gathers, per-span rescaling, orders of
    magnitude faster.  ``engine="log"`` keeps the exact log-space
    per-example path (the oracle): its gather-heavy steps explode XLA
    compile time under vmap, so the batch is dispatched as a Python loop
    over the two per-example jits with async dispatch overlapping the
    examples.
    """
    params = params or default_params()
    if engine == "scaled":
        from .mccaskill_scaled import mccaskill_bpp_batch_scaled

        return mccaskill_bpp_batch_scaled(codes_batch, lengths, params)
    codes = jnp.asarray(codes_batch, jnp.int32)
    ia, ib, ipen, icls = _prep(params, dtype)
    key = _register(params)
    lengths = np.asarray(lengths)

    pending = []
    for b in range(codes.shape[0]):
        c = codes[b]
        l = jnp.asarray(int(lengths[b]))
        Qb, QbE, Qm1, Qm, Qm2, ql, logZ = _inside(
            c, l, key, None, None, ia, ib, ipen, icls, jnp.zeros((), dtype)
        )
        bpp = _outside(c, l, key, None, None, ia, ib, ipen, icls,
                       Qb, QbE, Qm1, Qm, Qm2, ql, logZ)
        pending.append((bpp, logZ))
    bpps = np.stack([np.asarray(b) for b, _ in pending])
    logZs = np.asarray([float(z) for _, z in pending])
    return bpps, logZs
