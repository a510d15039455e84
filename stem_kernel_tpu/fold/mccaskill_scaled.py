"""Scaled linear-domain McCaskill engine — the fast batched device path.

Same Vienna-structured model and recursions as :mod:`.mccaskill` (the
log-space oracle), but designed for the machine instead of for numerical
convenience:

- **linear (exp) domain with per-span rescaling**: every DP row (one span
  length d across all starts i) is renormalized to max 1.0 and its log scale
  accumulated in ``mu[d]`` — Vienna's global ``pf_scale``
  (/root/reference/common/bpmatrix.cpp:158-165) done exactly, per row, with
  no a-priori estimate needed.  All combining arithmetic is multiply/add.
- **zero gathers inside the scan**: every read is a ``dynamic_slice`` out of
  a reversed row buffer (rows stored at ``n-1-d`` so "all spans below d" is
  one contiguous slab), a static shift, a small convolution, or a
  pad-reshape skew.  All sequence-dependent energy terms are precomputed
  span-layout tables (fold.tables LUTs gathered once outside the scan).
- **interior loops as conv2d, one per Vienna loop class**: the (a, b)
  offset double sum becomes a (C+1, A+1) correlation kernel of
  exp(penalties) applied to a slab of class-weighted Qb rows (the inner
  mismatch factor is folded into the slab when each row is written; the
  outer factor multiplies the conv output) — ``lax.conv_general_dilated``
  as matmuls.  Stack / bulge-1 / int11 / int21 / int22 are explicit
  shifted-row terms with their own LUT rows.
- **multiloop split sums as slab reductions**; **batching via vmap**.

Scale-correct combining: a row computed at provisional scale p gets
contributions X̂·exp(mu_X - p); p is the max over all candidate offsets so
every factor is <= 1 (terms more than ~87 log units below the row's dominant
contribution underflow — standard partition-function practice; the exact
log-space engine remains as the oracle and fallback).

Outside pass mirrors the structure top-down (per-span offsets ``om[D]``)
with the same machinery plus pad-reshape skew sums for the split terms whose
shift varies with the summation index.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .params import EnergyParams, default_params
from .mccaskill import (
    _interior_offsets,
    _span_gather,
    _PARAMS_REGISTRY,
    _register,
)
from .tables import build_luts

NEG = -1e30
TINY = 1e-38

# explicit small-loop terms: (lut name, inner span offset, inner start shift)
_EXPLICIT = (
    ("bulge1_l", 3, 2), ("bulge1_r", 3, 1),
    ("int11", 4, 2),
    ("int21_l", 5, 2), ("int21_r", 5, 3),
    ("int22", 6, 3),
)
_CLS_OUT = ("mm_i_out", "mm_1n_out", "mm_23_out", "term_out")
_CLS_IN = ("mm_i_in", "mm_1n_in", "mm_23_in", "term_in")
# fast tier: 2 classes (generic interior, bulge), no explicit small-loop luts
_CLS_OUT_FAST = ("mm_i_out", "term_out")
_CLS_IN_FAST = ("mm_i_in", "term_in")


def _cls_names(params) -> tuple[tuple[str, ...], tuple[str, ...]]:
    if getattr(params, "fast", False):
        return _CLS_OUT_FAST, _CLS_IN_FAST
    return _CLS_OUT, _CLS_IN


def _expl_terms(params):
    return () if getattr(params, "fast", False) else _EXPLICIT


def _class_kernels(params: EnergyParams) -> list[np.ndarray]:
    """One exp(penalty) conv kernel per loop class, K[c, a] with c = a + b.

    Built from the SAME offset classification as the log engine
    (mccaskill._interior_offsets), so the two engines cover identical terms
    — including the 2-class fast tier (params.fast).
    """
    cdim = params.max_interior + 3
    n_cls = 2 if getattr(params, "fast", False) else 4
    ks = [np.zeros((cdim, cdim), dtype=np.float64) for _ in range(n_cls)]
    ia, ib, ipen, icls = _interior_offsets(params)
    for a, b, pen, cls in zip(ia, ib, ipen, icls):
        ks[cls][a + b, a] = np.exp(pen)
    return ks


def _shift_left(v: jax.Array, k, width: int) -> jax.Array:
    """out[..., i] = v[..., i+k] with zero fill; k may be traced."""
    pad = jnp.zeros(v.shape[:-1] + (width,), v.dtype)
    vp = jnp.concatenate([v, pad], axis=-1)
    start = (0,) * (v.ndim - 1) + (k,)
    return jax.lax.dynamic_slice(vp, start, v.shape)


def _shift_right(v: jax.Array, k, width: int) -> jax.Array:
    """out[..., i] = v[..., i-k] with zero fill; k may be traced."""
    pad = jnp.zeros(v.shape[:-1] + (width,), v.dtype)
    vp = jnp.concatenate([pad, v], axis=-1)
    start = (0,) * (v.ndim - 1) + (width - k,)
    return jax.lax.dynamic_slice(vp, start, v.shape)


def _skew_sum(c: jax.Array) -> jax.Array:
    """sum_t C[t, i - t] over rows, via the pad-reshape diagonal trick.

    C: (m, n) -> out: (n,) with out[i] = sum_t C[t, i-t] (zero outside).
    """
    m, n = c.shape
    cp = jnp.pad(c, ((0, 0), (0, m)))  # (m, n + m)
    flat = cp.reshape(-1)[: m * (n + m - 1)]
    sk = flat.reshape(m, n + m - 1)  # sk[t, y] = C[t, y - t]
    return jnp.sum(sk, axis=0)[:n]


def _conv_rows(slab: jax.Array, kernel: jax.Array, flip: bool) -> jax.Array:
    """out[i] = sum_{c,a} slab[c, i + a] * K[c, a]   (flip=False)
       out[i] = sum_{c,a} slab[c, i - a] * K[c, a]   (flip=True)
    slab: (C, n), kernel: (C, A) -> out: (n,).

    Factored as one (A, C) @ (C, n) matmul followed by a pad-reshape skew
    sum over the offset axis — NOT conv_general_dilated: a (C, A) = 33x33
    window conv made the fold program's XLA compile pathologically slow;
    this formulation removes the conv entirely at identical flops."""
    w = jnp.einsum(
        "ca,cn->an", kernel.astype(slab.dtype), slab,
        precision=jax.lax.Precision.HIGHEST,
    )
    if flip:
        return _skew_sum(w)
    return _skew_sum(w[:, ::-1])[::-1]


def _skew_ij_to_span(m: jax.Array, fill: float) -> jax.Array:
    """[i, j]-layout (n, n) -> span layout S[d, i] = m[i, i+d].

    Pure pad-reshape (no gather): flat index of the padded row-major matrix
    re-chunked with stride 2n+1 walks the diagonals.
    """
    n = m.shape[0]
    mp = jnp.pad(m, ((0, 0), (0, n)), constant_values=fill)  # (n, 2n)
    flat = jnp.concatenate([mp.reshape(-1), jnp.full((n,), fill, m.dtype)])
    sk = flat.reshape(n, 2 * n + 1)  # sk[i, d] = mp[i, i+d]
    return sk[:, :n].T


def _skew_span_to_ij(s: jax.Array, fill: float) -> jax.Array:
    """Span layout (n, n) -> [i, j]-layout M[i, j] = s[j-i, i] (no gather)."""
    n = s.shape[0]
    st = s.T  # st[i, d]
    cp = jnp.pad(st, ((0, 0), (0, n)), constant_values=fill)  # (n, 2n)
    flat = cp.reshape(-1)[: n * (2 * n - 1)]
    sk = flat.reshape(n, 2 * n - 1)  # sk[i, j] = cp[i, j-i]
    return sk[:, :n]


def _span_tables(codes, length, params, w_extra, dt, pt_ov=None):
    """All LUTs in span layout ([d, i] = lut[i, i+d]).

    Returns (log tables dict, exp tables dict): log form for things that
    set row scales (wpair via logQbS, hairpin, ext), exp form (capped) for
    multiplicative factors.  The layout change is a pad-reshape skew, not a
    gather — gathers under vmap multiply XLA compile time.
    """
    luts = build_luts(codes, length, params, w_extra, pt_override=pt_ov)
    logs, exps = {}, {}
    for k, v in luts.items():
        s = _skew_ij_to_span(v.astype(dt), NEG)
        logs[k] = s
        exps[k] = jnp.exp(jnp.minimum(s, 60.0))
    return logs, exps


@partial(jax.jit, static_argnums=(2,))
def _inside_scaled(codes, length, params_key, w_extra, pt_ov):
    """Scaled inside pass.  Returns span-layout scaled tables + offsets.

    Output: dict with Qb, Qm1, Qm, Qm2 (n, n) scaled rows; mu (n,) log
    offsets; ql (n+1,) log external prefixes; logZ scalar.
    """
    params = _PARAMS_REGISTRY[params_key]
    n = codes.shape[-1]  # codes may be (R, n) alignment rows (true alifold)
    dt = jnp.float32

    logs, exps = _span_tables(codes, length, params, w_extra, dt, pt_ov)
    wpairS = exps["wpair"]
    hairpinS = logs["hairpin"]  # log form: sets row scale
    i_idx = jnp.arange(n)

    kernels = [jnp.asarray(k, dt) for k in _class_kernels(params)]
    cls_out, cls_in = _cls_names(params)
    ncls = len(cls_out)
    cdim = kernels[0].shape[0]
    c_lin = jnp.float32(np.exp(params.ml_unpaired))
    cpow = jnp.asarray(
        np.exp(params.ml_unpaired * np.arange(n, dtype=np.float64)), dt
    )

    zrow = jnp.zeros((n,), dt)
    nrev = n + max(n, cdim) + 1  # rev buffers must fit (start, cdim|n) slices
    carry = dict(
        rqb=jnp.zeros((nrev, n), dt),            # rev span Qb rows at n-1-d
        rqbx=jnp.zeros((ncls, nrev, n), dt),     # class-weighted Qb shadows
        rqm1e=jnp.zeros((nrev, n), dt),          # rev end-layout Qm1 rows
        qm_tbl=jnp.zeros((n, n), dt),            # start-layout Qm rows
        mu=jnp.full((n,), NEG, dt),
        mu_rev=jnp.full((nrev,), NEG, dt),
        qm1_prev=zrow,
        qm2_prev=zrow,
        qm2_prev2=zrow,
    )

    def row_of(tab, d):
        return jax.lax.dynamic_slice(tab, (d, 0), (1, n))[0]

    def step(carry, d):
        start = n - 1 - d
        t_slab = jax.lax.dynamic_slice(carry["rqb"], (start, 0), (cdim, n))
        tx_slab = jax.lax.dynamic_slice(
            carry["rqbx"], (0, start, 0), (ncls, cdim, n)
        )
        mu_t = jax.lax.dynamic_slice(carry["mu_rev"], (start,), (cdim,))
        s_slab = jax.lax.dynamic_slice(carry["rqm1e"], (start, 0), (n, n))
        mu_s = jax.lax.dynamic_slice(carry["mu_rev"], (start,), (n,))
        mu_sh = jnp.concatenate([jnp.full((1,), NEG, dt), carry["mu"][:-1]])

        hp_row = row_of(hairpinS, d)
        p = jnp.maximum(
            jnp.maximum(jnp.max(mu_sh + mu_s), jnp.max(mu_s)), jnp.max(hp_row)
        )
        p = jnp.where(p < -1e29, jnp.float32(0.0), p)

        f_t = jnp.exp(mu_t - p)  # (cdim,)
        f_s = jnp.exp(mu_s - p)  # (n,)
        f_w = jnp.exp(mu_sh + mu_s - p)  # (n,)

        # ---- Qb row ----
        tf = t_slab * f_t[:, None]
        txf = tx_slab * f_t[None, :, None]
        acc = jnp.exp(hp_row - p)  # hairpin (full lut)
        acc = acc + row_of(exps["stack"], d) * _shift_left(tf[2], 1, 1)
        for (name, ds, sh) in _expl_terms(params):
            acc = acc + row_of(exps[name], d) * _shift_left(tf[ds], sh, sh)
        for c in range(ncls):
            acc = acc + row_of(exps[cls_out[c]], d) * _conv_rows(
                txf[c], kernels[c], flip=False
            )
        acc = acc + row_of(exps["ml_close"], d) * _shift_left(
            carry["qm2_prev2"] * f_t[2], 1, 1
        )
        qb = row_of(wpairS, d) * acc

        # ---- Qm1 row (ml_stem lut includes b + terminal + mismatch) ----
        qm1 = c_lin * carry["qm1_prev"] * f_s[1] + row_of(exps["ml_stem"], d) * qb

        # ---- split slabs ----
        u_slab = _shift_left(s_slab, d, n)  # row t: Qm1E[d-t] at position i+d
        u_slab = u_slab.at[0].set(qm1)      # t = 0: fresh row (already at p)
        w_sh = jnp.concatenate(
            [jnp.zeros((1, n), dt), carry["qm_tbl"][:-1]], axis=0
        )  # row t = Qm[t-1]
        qm2 = jnp.sum(w_sh * u_slab * f_w[:, None], axis=0)
        f_unp = (cpow * f_s).at[0].set(1.0)
        qm = qm2 + jnp.sum(u_slab * f_unp[:, None], axis=0)

        # keep junk in invalid lanes (i + d >= length) out of the row scale
        valid = (i_idx + d < length).astype(dt)
        qb, qm1, qm, qm2 = qb * valid, qm1 * valid, qm * valid, qm2 * valid

        # ---- joint rescale ----
        m = jnp.max(
            jnp.maximum(jnp.maximum(jnp.max(qb), jnp.max(qm1)),
                        jnp.maximum(jnp.max(qm), jnp.max(qm2)))
        )
        scale = jnp.where(m > 0, m, jnp.float32(1.0))
        inv = 1.0 / scale
        qb, qm1, qm, qm2 = qb * inv, qm1 * inv, qm * inv, qm2 * inv
        mu_d = jnp.where(m > 0, p + jnp.log(scale), jnp.float32(NEG))

        qbx = jnp.stack(
            [qb * row_of(exps[cls_in[c]], d) for c in range(ncls)], axis=0
        )
        qm1e = _shift_right(qm1, d, n)
        carry = dict(
            rqb=jax.lax.dynamic_update_slice(carry["rqb"], qb[None], (start, 0)),
            rqbx=jax.lax.dynamic_update_slice(
                carry["rqbx"], qbx[:, None], (0, start, 0)
            ),
            rqm1e=jax.lax.dynamic_update_slice(
                carry["rqm1e"], qm1e[None], (start, 0)
            ),
            qm_tbl=jax.lax.dynamic_update_slice(
                carry["qm_tbl"], qm[None], (d, 0)
            ),
            mu=jax.lax.dynamic_update_slice(carry["mu"], mu_d[None], (d,)),
            mu_rev=jax.lax.dynamic_update_slice(
                carry["mu_rev"], mu_d[None], (start,)
            ),
            qm1_prev=qm1,
            qm2_prev=qm2,
            qm2_prev2=carry["qm2_prev"],
        )
        return carry, (qb, qm1, qm, qm2)

    carry, rows = jax.lax.scan(step, carry, jnp.arange(1, n))
    qb_rows, qm1_rows, qm_rows, qm2_rows = rows
    pad0 = jnp.zeros((1, n), dt)
    Qb = jnp.concatenate([pad0, qb_rows], axis=0)
    Qm1 = jnp.concatenate([pad0, qm1_rows], axis=0)
    Qm = jnp.concatenate([pad0, qm_rows], axis=0)
    Qm2 = jnp.concatenate([pad0, qm2_rows], axis=0)
    mu = carry["mu"]

    # ---- external chain (log domain; n^2 total, no gathers) ----
    logQbS = jnp.where(Qb > 0, jnp.log(jnp.maximum(Qb, TINY)) + mu[:, None], NEG)
    logQbE = jnp.maximum(logQbS + logs["ext_stem"], NEG)  # exterior-weighted
    # end-layout transpose: QbE_T[j, t] = log QbE(span t, end j)
    m_rows = n
    sk = jnp.pad(logQbE, ((0, 0), (0, m_rows)), constant_values=NEG)
    flat = sk.reshape(-1)[: m_rows * (n + m_rows - 1)]
    qbe = flat.reshape(m_rows, n + m_rows - 1)[:, :n]  # qbe[t, j] = logQbE[t, j-t]
    qbe_T = qbe.T  # (j, t)

    c_ext = dt(params.ext_unpaired)

    def ql_step(c, j):
        qlv, rev = c
        row = qbe_T[j]
        w = jax.lax.dynamic_slice(rev, (n - j + n,), (n,))  # w[t] = Ql[j-t-1]
        paired = jax.nn.logsumexp(row + w)
        val = jnp.logaddexp(qlv[j] + c_ext, paired)
        val = jnp.where(j < length, val, qlv[j])
        qlv = jax.lax.dynamic_update_slice(qlv, val[None], (j + 1,))
        rev = jax.lax.dynamic_update_slice(rev, val[None], (n - (j + 1) + n,))
        return (qlv, rev), None

    qlv0 = jnp.concatenate([jnp.zeros((1,), dt), jnp.full((n,), NEG, dt)])
    rev0 = jnp.full((3 * n + 2,), NEG, dt)
    rev0 = jax.lax.dynamic_update_slice(rev0, jnp.zeros((1,), dt), (2 * n,))
    (qlv, _), _ = jax.lax.scan(ql_step, (qlv0, rev0), jnp.arange(n))
    logZ = qlv[length]

    return dict(Qb=Qb, Qm1=Qm1, Qm=Qm, Qm2=Qm2, mu=mu, logQbS=logQbS,
                logQbE=logQbE, qlv=qlv, logZ=logZ)


@partial(jax.jit, static_argnums=(2,))
def _outside_scaled(codes, length, params_key, w_extra, pt_ov, ins):
    """Scaled outside pass -> bpp (n, n) in [i, j] layout."""
    params = _PARAMS_REGISTRY[params_key]
    n = codes.shape[-1]  # codes may be (R, n) alignment rows (true alifold)
    dt = jnp.float32

    logs, exps = _span_tables(codes, length, params, w_extra, dt, pt_ov)
    i_idx = jnp.arange(n)

    kernels = [jnp.asarray(k, dt) for k in _class_kernels(params)]
    cdim = kernels[0].shape[0]
    PAD = max(cdim, 8)  # row padding for span-(D+k) reads, k <= 6 or cdim

    def padded(name):
        return jnp.pad(exps[name], ((0, PAD), (0, 0)))

    wpadS = padded("wpair")
    stkpadS = padded("stack")
    mlclosepadS = padded("ml_close")
    expl_pads = {name: padded(name) for (name, _, _) in _expl_terms(params)}
    cls_out, cls_in = _cls_names(params)
    ncls = len(cls_out)
    clsout_pads = [padded(nm) for nm in cls_out]

    c_lin = jnp.float32(np.exp(params.ml_unpaired))
    cpow = jnp.asarray(
        np.exp(params.ml_unpaired * np.arange(n, dtype=np.float64)), dt
    )

    Qm1, Qm, mu = ins["Qm1"], ins["Qm"], ins["mu"]
    logQbE, qlv, logZ = ins["logQbE"], ins["qlv"], ins["logZ"]

    # ---- OQl chain (log domain, descending j) ----
    logQbE_T = logQbE.T  # [i, t]
    oql_pad0 = jnp.full((2 * n,), NEG, dt)

    def oql_step(oql_pad, j):
        row = logQbE_T[jnp.clip(j + 1, 0, n - 1)]  # over t: QbE(start j+1, span t)
        win = jax.lax.dynamic_slice(oql_pad, (j + 1,), (n,))  # oql[j+1+t]
        paired = jax.nn.logsumexp(row + win)
        paired = jnp.where(j + 1 < n, paired, jnp.float32(NEG))
        unp = jnp.where(
            j + 1 < length,
            jax.lax.dynamic_slice(oql_pad, (jnp.clip(j + 1, 0),), (1,))[0]
            + dt(params.ext_unpaired),
            jnp.float32(NEG),
        )
        val = jnp.logaddexp(unp, paired)
        val = jnp.where(j == length - 1, jnp.float32(0.0), val)
        val = jnp.where(j > length - 1, jnp.float32(NEG), val)
        oql_pad = jax.lax.dynamic_update_slice(oql_pad, val[None], (j,))
        return oql_pad, None

    oql_pad, _ = jax.lax.scan(oql_step, oql_pad0, jnp.arange(n - 1, -1, -1))
    ql_shift = jnp.concatenate([jnp.zeros((1,), dt), qlv[1:n]])  # Ql[i-1]

    zrow = jnp.zeros((n,), dt)
    nbuf = 2 * n + cdim + 8  # covers slices (D+k, n|cdim) for any D < n
    carry = dict(
        ob_pad=jnp.zeros((nbuf, n), dt),
        om2_pad=jnp.zeros((nbuf, n), dt),
        om_pad=jnp.zeros((nbuf, n), dt),
        om=jnp.full((nbuf,), NEG, dt),  # offsets, padded indexing by D
        om1_prev=zrow,
    )
    mu_sh = jnp.concatenate([jnp.full((1,), NEG, dt), mu[:-1]])  # mu[t-1]
    qm_sh = jnp.concatenate([jnp.zeros((1, n), dt), Qm[:-1]], axis=0)  # Qm[t-1]

    def row_at(tab, D):
        return jax.lax.dynamic_slice(tab, (D, 0), (1, n))[0]

    def step(carry, D):
        om_off = carry["om"]
        om_up = jax.lax.dynamic_slice(om_off, (D,), (n,))       # om[D+t]
        om_up1 = jax.lax.dynamic_slice(om_off, (D + 1,), (n,))  # om[D+1+t]
        oql_sh = _shift_left(oql_pad[:n], D, n)  # oql[i+D] (NEG pad -> use where)
        oql_sh = jnp.where(i_idx + D < n, oql_sh, jnp.float32(NEG))
        ext_log = ql_shift + oql_sh + row_at(logs["ext_stem"], D)

        p = jnp.maximum(
            jnp.maximum(jnp.max(mu_sh + om_up1), jnp.max(om_up1)),
            jnp.maximum(jnp.max(ext_log), jnp.max(mu + om_up)),
        )
        p = jnp.where(p < -1e29, jnp.float32(0.0), p)

        # ---- Om[D]: sum_{u>D} Qm1[u-D-1, i+D+1] * Om2[u, i] ----
        qm1_sh = _shift_left(Qm1, D + 1, n)  # row r at position i+D+1
        om2_slab = jax.lax.dynamic_slice(
            carry["om2_pad"], (D + 1, 0), (n, n)
        )  # row r = Om2[D+1+r]
        f = jnp.exp(mu + om_up1 - p)  # mu[r] + om[D+1+r]
        om_row = jnp.sum(qm1_sh * om2_slab * f[:, None], axis=0)

        # ---- Om2[D]: multiloop close + Om flow ----
        ob2 = row_at(carry["ob_pad"], D + 2)
        wp2 = row_at(wpadS, D + 2)
        close = _shift_right(
            ob2 * wp2 * row_at(mlclosepadS, D + 2) * jnp.exp(om_off[D + 2] - p),
            1, 1,
        )
        om2_row = close + om_row

        # ---- Om1[D] ----
        inc = c_lin * carry["om1_prev"] * jnp.exp(om_off[D + 1] - p)
        om2_up = jax.lax.dynamic_slice(carry["om2_pad"], (D, 0), (n, n))
        g_b = jnp.exp(mu_sh + om_up - p).at[0].set(0.0)  # mu[t-1]+om[D+t], t>=1
        cb = qm_sh * om2_up * g_b[:, None]
        term_b = _skew_sum(cb)
        om_up_slab = jax.lax.dynamic_slice(carry["om_pad"], (D, 0), (n, n))
        g_c = (cpow * jnp.exp(om_up - p)).at[0].set(0.0)
        cc = om_up_slab * g_c[:, None]
        term_c = om_row + _skew_sum(cc)  # t=0 term is this step's Om row
        om1_row = inc + term_b + term_c

        # ---- Ob[D] ----
        ext = jnp.exp(jnp.minimum(ext_log - p, 60.0))
        stack_term = _shift_right(
            ob2 * wp2 * row_at(stkpadS, D + 2) * jnp.exp(om_off[D + 2] - p),
            1, 1,
        )
        acc = ext + stack_term
        for (name, ds, sh) in _expl_terms(params):
            obk = row_at(carry["ob_pad"], D + ds)
            wpk = row_at(wpadS, D + ds)
            lk = row_at(expl_pads[name], D + ds)
            acc = acc + _shift_right(
                obk * wpk * lk * jnp.exp(om_off[D + ds] - p), sh, sh
            )
        # interior classes: slab rows c = Ob[D+c]*wpair[D+c]*mm_out[D+c]
        ob_cslab = jax.lax.dynamic_slice(carry["ob_pad"], (D, 0), (cdim, n))
        wp_cslab = jax.lax.dynamic_slice(wpadS, (D, 0), (cdim, n))
        f_c = jnp.exp(jax.lax.dynamic_slice(om_off, (D,), (cdim,)) - p)
        for c in range(ncls):
            mo_cslab = jax.lax.dynamic_slice(clsout_pads[c], (D, 0), (cdim, n))
            slab = ob_cslab * wp_cslab * mo_cslab * f_c[:, None]
            acc = acc + row_at(exps[cls_in[c]], D) * _conv_rows(
                slab, kernels[c], flip=True
            )
        # multiloop branch entry
        ob_row = acc + row_at(exps["ml_stem"], D) * om1_row

        # ---- joint rescale ----
        m = jnp.maximum(
            jnp.maximum(jnp.max(ob_row), jnp.max(om1_row)),
            jnp.maximum(jnp.max(om_row), jnp.max(om2_row)),
        )
        scale = jnp.where(m > 0, m, jnp.float32(1.0))
        inv = 1.0 / scale
        ob_row, om1_row = ob_row * inv, om1_row * inv
        om_row, om2_row = om_row * inv, om2_row * inv
        om_d = jnp.where(m > 0, p + jnp.log(scale), jnp.float32(NEG))

        carry = dict(
            ob_pad=jax.lax.dynamic_update_slice(
                carry["ob_pad"], ob_row[None], (D, 0)
            ),
            om2_pad=jax.lax.dynamic_update_slice(
                carry["om2_pad"], om2_row[None], (D, 0)
            ),
            om_pad=jax.lax.dynamic_update_slice(
                carry["om_pad"], om_row[None], (D, 0)
            ),
            om=jax.lax.dynamic_update_slice(carry["om"], om_d[None], (D,)),
            om1_prev=om1_row,
        )
        return carry, (ob_row, om_d)

    carry, (ob_rows, om_ds) = jax.lax.scan(
        step, carry, jnp.arange(n - 1, 0, -1)
    )
    # rows were emitted for D = n-1 .. 1; reassemble span-major
    Ob = jnp.concatenate([jnp.zeros((1, n), dt), ob_rows[::-1]], axis=0)
    om = jnp.concatenate([jnp.full((1,), NEG, dt), om_ds[::-1]])

    logOb = jnp.where(Ob > 0, jnp.log(jnp.maximum(Ob, TINY)) + om[:, None], NEG)
    logQb = ins["logQbS"]
    # bpp in [i, j] layout: inverse skew (no gather)
    djj = i_idx[None, :] - i_idx[:, None]
    lq = _skew_span_to_ij(logQb, NEG)
    lo = _skew_span_to_ij(logOb, NEG)
    bpp = jnp.where(djj > 0, jnp.exp(jnp.minimum(lq + lo - logZ, 0.0)), 0.0)
    return bpp


def _bpp_one(codes, length, params_key, w_extra, pt_ov=None):
    ins = _inside_scaled(codes, length, params_key, w_extra, pt_ov)
    bpp = _outside_scaled(codes, length, params_key, w_extra, pt_ov, ins)
    return bpp, ins["logZ"]


@partial(jax.jit, static_argnums=(2,))
def _bpp_vmapped(codes, lengths, params_key, w_extra, pt_ov):
    wax = None if w_extra is None else 0
    pax = None if pt_ov is None else 0
    return jax.vmap(_bpp_one, in_axes=(0, 0, None, wax, pax))(
        codes, lengths, params_key, w_extra, pt_ov
    )


MAX_FOLD_BATCH = 128


def _batch_bucket(b: int, n: int = 128) -> int:
    """Geometric batch buckets (8, 16, ..., cap): recompiles are bounded by
    O(log B) variants instead of one per dataset size.  The cap bounds device
    memory —
    per-example device memory scales as O(n^2) LUTs + scan buffers, so the
    cap shrinks quadratically with sequence length (128 at n<=128 down to 8
    at n>=512); larger corpora are folded in cap-sized chunks."""
    cap = MAX_FOLD_BATCH
    if n > 128:
        cap = int(max(8, MAX_FOLD_BATCH * (128 / n) ** 2))
        cap = 1 << (cap.bit_length() - 1)  # round down to a power of two
    out = 8
    while out < b and out < cap:
        out *= 2
    return out


def mccaskill_bpp_batch_scaled(
    codes_batch: np.ndarray,
    lengths: np.ndarray,
    params: EnergyParams | None = None,
    *,
    w_extra: np.ndarray | None = None,
    pt_override: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched (bpp, logZ): one vmapped device program for the whole batch.

    ``pt_override`` — optional (B, n, n) int pair-type matrices (-1 = cannot
    pair) replacing code-derived pair admissibility (see tables.build_luts).

    Both the sequence-length axis (bucketed by the caller) and the batch
    axis (bucketed here) are padded so any corpus hits a small, cached set
    of compiled programs; padded rows fold a zero-length sequence.
    """
    params = params or default_params()
    key = _register(params)
    codes_np = np.asarray(codes_batch)
    # (B, n) single sequences, or (B, R, n) alignment-row batches for the
    # true-alifold averaged LUTs (tables._build_luts_averaged)
    b, n = codes_np.shape[0], codes_np.shape[-1]
    cap = _batch_bucket(1 << 30, n)  # length-dependent chunk cap
    if b > cap:
        # bounded in-flight chunked dispatch: keep at most MAX_PENDING chunk
        # results queued on device before fetching the oldest, so peak device memory
        # is capped while dispatch, compute, and fetch still overlap.
        MAX_PENDING = 2
        pending: list = []
        done_b: list[np.ndarray] = []
        done_z: list[np.ndarray] = []

        def drain_one():
            (pb, pz), pn = pending.pop(0)
            done_b.append(np.asarray(pb[:pn]))
            done_z.append(np.asarray(pz[:pn]))

        for s in range(0, b, cap):
            chunk = codes_np[s : s + cap]
            lens_c = np.asarray(lengths)[s : s + cap]
            we_c = None if w_extra is None else np.asarray(w_extra)[s : s + cap]
            po_c = (None if pt_override is None
                    else np.asarray(pt_override)[s : s + cap])
            pending.append(_bpp_dispatch(chunk, lens_c, key, we_c, po_c))
            if len(pending) > MAX_PENDING:
                drain_one()
        while pending:
            drain_one()
        return np.concatenate(done_b), np.concatenate(done_z)
    (bpp, logZ), nb = _bpp_dispatch(
        codes_np, np.asarray(lengths), key, w_extra, pt_override)
    return np.asarray(bpp[:nb]), np.asarray(logZ[:nb])


def _bpp_dispatch(codes_np, lens_np, key, w_extra, pt_override=None):
    """Pad one chunk to its batch bucket and dispatch (async)."""
    b, n = codes_np.shape[0], codes_np.shape[-1]
    b_pad = _batch_bucket(b, n)
    pad_w = [(0, b_pad - b)] + [(0, 0)] * (codes_np.ndim - 1)
    # batch padding for row batches uses all-gap rows (code 4): they join
    # no averaged entry, so padded examples still fold a zero-length seq
    codes_np = np.pad(codes_np, pad_w,
                      constant_values=4 if codes_np.ndim == 3 else 0)
    lens_p = np.pad(lens_np, (0, b_pad - b))
    codes = jnp.asarray(codes_np, jnp.int32)
    lens = jnp.asarray(lens_p, jnp.int32)
    we = None
    if w_extra is not None:
        we = jnp.asarray(
            np.pad(np.asarray(w_extra, np.float32),
                   ((0, b_pad - b), (0, 0), (0, 0)))
        )
    po = None
    if pt_override is not None:
        po = jnp.asarray(
            np.pad(np.asarray(pt_override, np.int32),
                   ((0, b_pad - b), (0, 0), (0, 0)), constant_values=-1)
        )
    return _bpp_vmapped(codes, lens, key, we, po), b
