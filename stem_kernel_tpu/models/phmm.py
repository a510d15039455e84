"""Pair HMM: log-space forward/backward/posterior + MAP alignment path.

Equivalent of the reference's 3-state (M/IX/IY) pair HMM with RIBOSUM
emissions (/root/reference/stem_kernel/phmm.{h,cpp}): unnormalized log
transition weights ribosum_trans (phmm.cpp:231-236), match emissions
ribosum_emit = RIBOSUM85-60 singles (phmm.cpp:238-244), gap states emit
weight 1.  The reference computes in a log-value number class
(stem_kernel/log_value.h); here everything is plain log-space JAX with the
column recursions as associative logsumexp scans.

The MAP path maximizes summed posteriors along an alignment path
(PairHMM::forward over the FB table + traceback, phmm.cpp:116-215) and is
evaluated host-side (it feeds per-pair banding constraints, used once per
pair).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.recurrence import logsumexp_recurrence
from .ribosum_data import RIBOSUM_S

M, IX, IY = 0, 1, 2
NEG = -1e30

# log transition weights (phmm.cpp:229-236), [from][to]
TRANS = np.array(
    [
        [0.0, -5.0, -5.0],  # M ->
        [-10.0, -5.0, -15.0],  # IX ->
        [-10.0, -5.0, -15.0],  # IY ->
    ],
    dtype=np.float32,
)


def _emit_matrix(x_codes: jax.Array, y_codes: jax.Array) -> jax.Array:
    """(B, n, m) match emission log-weights e(x_i, y_j)."""
    rib = jnp.asarray(RIBOSUM_S)
    return rib[x_codes[:, :, None], y_codes[:, None, :]]


@jax.jit
def phmm_forward(x_codes: jax.Array, lx: jax.Array, y_codes: jax.Array, ly: jax.Array):
    """Log-space forward tables.  Returns (fw (3, B, n+1, m+1), logZ (B,)).

    Recursion (phmm.cpp:11-51): fw[M][i][j] = e(i,j) * sum_s fw[s][i-1][j-1]
    * t[s][M]; IX along i; IY along j (in-row first-order logsumexp scan).
    """
    bsz, n = x_codes.shape
    m = y_codes.shape[1]
    t = jnp.asarray(TRANS)
    e = _emit_matrix(x_codes, y_codes)  # (B, n, m)
    # mask out-of-length emissions hard so padded cells never win
    mx = jnp.arange(n)[None, :] < lx[:, None]
    my = jnp.arange(m)[None, :] < ly[:, None]
    e = jnp.where(mx[:, :, None] & my[:, None, :], e, NEG)

    # row 0: M = 0 at (0,0); IX = NEG; IY accumulates along j
    m_row = jnp.full((bsz, m + 1), NEG).at[:, 0].set(0.0)
    ix_row = jnp.full((bsz, m + 1), NEG)
    iy0 = jnp.logaddexp(m_row[:, :-1] + t[M, IY], jnp.full((bsz, m), NEG))
    iy_row = jnp.concatenate(
        [jnp.full((bsz, 1), NEG),
         logsumexp_recurrence(jnp.full((bsz, m), t[IY, IY]), iy0)],
        axis=-1,
    )
    iy_row = jnp.where(jnp.arange(m + 1)[None, :] <= ly[:, None], iy_row, NEG)

    def row_step(carry, e_row):
        m_prev, ix_prev, iy_prev = carry
        diag = jnp.stack([m_prev[:, :-1], ix_prev[:, :-1], iy_prev[:, :-1]])
        m_new = jnp.concatenate(
            [jnp.full((bsz, 1), NEG),
             e_row + jax.nn.logsumexp(diag + t[:, M][:, None, None], axis=0)],
            axis=-1,
        )
        up = jnp.stack([m_prev, ix_prev, iy_prev])
        ix_new = jax.nn.logsumexp(up + t[:, IX][:, None, None], axis=0)
        q = jnp.logaddexp(
            m_new[:, :-1] + t[M, IY], ix_new[:, :-1] + t[IX, IY]
        )
        iy_new = jnp.concatenate(
            [jnp.full((bsz, 1), NEG),
             logsumexp_recurrence(jnp.full((bsz, m), t[IY, IY]), q)],
            axis=-1,
        )
        out = (m_new, ix_new, iy_new)
        return out, jnp.stack(out)

    init = (m_row, ix_row, iy_row)
    _, rows = jax.lax.scan(row_step, init, jnp.swapaxes(e, 0, 1))
    # rows: (n, 3, B, m+1); prepend row 0
    fw = jnp.concatenate([jnp.stack(init)[None], rows], axis=0)  # (n+1, 3, B, m+1)
    fw = jnp.transpose(fw, (1, 2, 0, 3))  # (3, B, n+1, m+1)
    logZ = fw[M, jnp.arange(bsz), lx, ly]
    return fw, logZ


@jax.jit
def phmm_backward(x_codes: jax.Array, lx: jax.Array, y_codes: jax.Array, ly: jax.Array):
    """Log-space backward tables (3, B, n+1, m+1) (phmm.cpp:53-93).

    bk[s][i][j] = sum over completions from state s at (i, j) to the end.
    """
    bsz, n = x_codes.shape
    m = y_codes.shape[1]
    t = jnp.asarray(TRANS)
    e = _emit_matrix(x_codes, y_codes)
    mx = jnp.arange(n)[None, :] < lx[:, None]
    my = jnp.arange(m)[None, :] < ly[:, None]
    e = jnp.where(mx[:, :, None] & my[:, None, :], e, NEG)

    # terminal: bk[M][lx][ly] = 0 — handled via a mask row seeded at (lx, ly)
    end_col = jnp.arange(m + 1)[None, :] == ly[:, None]

    def row_step(carry, xs):
        m_next, ix_next, iy_next = carry  # rows for i+1
        e_row, is_end_row = xs  # e_row: (B, m) at x index i; is_end_row: (B,)
        # bk[s][i][j] gets: e(i,j)*t[s][M]*bk[M][i+1][j+1]  (diag)
        #                  t[s][IX]*bk[IX][i+1][j]          (down)
        #                  t[s][IY]*bk[IY][i][j+1]          (right, in-row)
        diag = jnp.concatenate([e_row + m_next[:, 1:], jnp.full((bsz, 1), NEG)], axis=-1)
        down = ix_next
        base_m = jnp.logaddexp(diag + t[M, M], down + t[M, IX])
        base_ix = jnp.logaddexp(diag + t[IX, M], down + t[IX, IX])
        base_iy = jnp.logaddexp(diag + t[IY, M], down + t[IY, IX])
        # end seeding: bk[M][lx][ly] = 0 on the terminal row
        base_m = jnp.where(is_end_row[:, None] & end_col, jnp.logaddexp(base_m, 0.0), base_m)
        # in-row IY recursion (right to left): bk_s gets t[s][IY]*bk[IY][i][j+1]
        # where bk[IY][i][j] itself = base_iy[j] ⊕ t[IY][IY]*bk[IY][i][j+1]
        iy_row = logsumexp_recurrence(
            jnp.full((bsz, m + 1), t[IY, IY]),
            jnp.concatenate([base_iy[:, :-1], base_iy[:, -1:]], axis=-1),
            reverse=True,
        )
        shift_iy = jnp.concatenate([iy_row[:, 1:], jnp.full((bsz, 1), NEG)], axis=-1)
        m_row = jnp.logaddexp(base_m, shift_iy + t[M, IY])
        ix_row = jnp.logaddexp(base_ix, shift_iy + t[IX, IY])
        out = (m_row, ix_row, iy_row)
        return out, jnp.stack(out)

    init = (
        jnp.full((bsz, m + 1), NEG),
        jnp.full((bsz, m + 1), NEG),
        jnp.full((bsz, m + 1), NEG),
    )
    is_end = jnp.arange(n + 1)[None, :] == lx[:, None]  # (B, n+1)
    e_ext = jnp.concatenate([e, jnp.full((bsz, 1, m), NEG)], axis=1)  # row n dummy
    _, rows = jax.lax.scan(
        row_step, init,
        (jnp.swapaxes(e_ext, 0, 1), is_end.T),
        reverse=True,
    )
    bk = jnp.transpose(rows, (1, 2, 0, 3))  # (3, B, n+1, m+1)
    return bk


def phmm_posterior(x_codes, lx, y_codes, ly):
    """Posterior state probabilities fb = fw*bk/Z (forward_backward)."""
    fw, logZ = phmm_forward(x_codes, lx, y_codes, ly)
    bk = phmm_backward(x_codes, lx, y_codes, ly)
    fb = jnp.exp(fw + bk - logZ[None, :, None, None])
    return np.asarray(fb), np.asarray(logZ)


def map_path(fb: np.ndarray, lx: int, ly: int) -> list[tuple[int, int, int]]:
    """Posterior-sum-maximizing path [(state, i, j), ...] (phmm.cpp:116-215)."""
    n, m = lx, ly
    fw = np.full((3, n + 1, m + 1), -np.inf)
    tr = np.full((3, n + 1, m + 1), -1, dtype=int)
    fw[:, 0, 0] = fb[:, 0, 0]
    for i in range(1, n + 1):
        v = fw[:, i - 1, 0] + fb[IX, i, 0]
        tr[IX, i, 0] = int(np.argmax(v))
        fw[IX, i, 0] = v[tr[IX, i, 0]]
    for j in range(1, m + 1):
        v = fw[:, 0, j - 1] + fb[IY, 0, j]
        tr[IY, 0, j] = int(np.argmax(v))
        fw[IY, 0, j] = v[tr[IY, 0, j]]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            for (s, pi, pj) in ((M, i - 1, j - 1), (IX, i - 1, j), (IY, i, j - 1)):
                v = fw[:, pi, pj] + fb[s, i, j]
                a = int(np.argmax(v))
                if v[a] > fw[s, i, j]:
                    fw[s, i, j] = v[a]
                    tr[s, i, j] = a
    path = []
    s, i, j = M, n, m
    path.append((s, i, j))
    while i != 0 and j != 0:
        ps = tr[s, i, j]
        if s == M:
            i, j = i - 1, j - 1
        elif s == IX:
            i -= 1
        else:
            j -= 1
        s = ps
        path.insert(0, (s, i, j))
    return path


def alignment_constraints(
    fb: np.ndarray, lx: int, ly: int, ali_bound: float, band: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Per-i column windows (c_low, c_high) from MAP-path anchors.

    Mirrors StemKernel::alignment_constraints
    (/root/reference/stem_kernel/stem_kernel.cpp:13-81).
    """
    c_low = np.zeros(lx + 1, dtype=np.int64)
    c_high = np.full(lx + 1, ly, dtype=np.int64)
    if ali_bound > 0.0:
        path = map_path(fb, lx, ly)
        low_x = low_y = 0
        for (s, px, py) in path:
            if s == M and fb[s, px, py] >= ali_bound:
                c_low[low_x:px] = low_y
                c_high[low_x:px] = py
                c_low[px] = c_high[px] = py
                low_x = px + 1
                low_y = py
        c_low[low_x:] = low_y
        c_high[low_x:] = ly
        if band > 0:
            narrow = c_high - c_low < 2 * band
            mid = (c_high + c_low) // 2
            c_low = np.where(narrow, np.maximum(mid - band, 0), c_low)
            c_high = np.where(narrow, np.minimum(mid + band, ly), c_high)
    elif band > 0:
        j = np.round(np.arange(lx + 1) / max(lx, 1) * ly).astype(np.int64)
        c_low = np.maximum(j - band, 0)
        c_high = np.minimum(j + band, ly)
    return c_low, c_high


@jax.jit
def posterior_windows(x_codes, lx, y_codes, ly, bound, band=0):
    """Per-position y-windows (c_low, c_high), batched and jit-friendly.

    Array-native form of alignment_constraints: instead of tracing the MAP
    path host-side (stem_kernel.cpp:13-81), anchor rows are those whose
    match posterior exceeds ``bound`` anywhere; window bounds interpolate
    between anchors via exclusive running max/min (the alignment is
    monotone, so the y-image of x position i lies between the anchors
    before and after it).  ``band`` widens windows narrower than 2*band,
    as the reference does.  Returns int32 (B, n+1) arrays over x indices
    0..n in y coordinates 0..m.
    """
    fw, logZ = phmm_forward(x_codes, lx, y_codes, ly)
    bk = phmm_backward(x_codes, lx, y_codes, ly)
    pm = jnp.exp(fw[M] + bk[M] - logZ[:, None, None])  # (B, n+1, m+1)
    bsz, np1, mp1 = pm.shape
    m = mp1 - 1
    jj = jnp.arange(mp1)
    # mask to true lengths
    valid = (jnp.arange(np1)[None, :, None] <= lx[:, None, None]) & (
        jj[None, None, :] <= ly[:, None, None]
    )
    hit = (pm >= bound) & valid
    row_any = hit.any(-1)
    anchor_hi = jnp.where(row_any, jnp.max(jnp.where(hit, jj[None, None], 0), -1), 0)
    anchor_lo = jnp.where(
        row_any, jnp.min(jnp.where(hit, jj[None, None], m), -1), m
    )
    # exclusive running max of anchor highs (below i) / min of anchor lows (above i)
    c_low = jnp.concatenate(
        [jnp.zeros((bsz, 1), anchor_hi.dtype),
         jax.lax.cummax(anchor_hi, axis=1)[:, :-1]], axis=1)
    c_high = jnp.concatenate(
        [jax.lax.cummin(anchor_lo[:, ::-1], axis=1)[:, ::-1][:, 1:],
         jnp.full((bsz, 1), m, anchor_lo.dtype)], axis=1)
    c_high = jnp.minimum(jnp.maximum(c_high, c_low), ly[:, None])
    band = jnp.asarray(band)  # band=0 makes the widening a no-op
    narrow = (c_high - c_low) < 2 * band
    mid = (c_high + c_low) // 2
    c_low = jnp.where(narrow, jnp.maximum(mid - band, 0), c_low)
    c_high = jnp.where(narrow, jnp.minimum(mid + band, ly[:, None]), c_high)
    return c_low.astype(jnp.int32), c_high.astype(jnp.int32)
