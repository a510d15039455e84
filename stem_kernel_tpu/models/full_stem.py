"""The full O(n^2 m^2) stem kernel (the reference implementation's kernel).

Redesign of /root/reference/stem_kernel/stem_kernel.cpp:83-351: the
8-state DP (K0-K3/G0-G3) over pairs of substrings (i,j) x (k,l).  The
reference walks a 4-index loop nest with lazily allocated per-(i,j) tables;
here the DP is a `lax.scan` over x-span length d with everything else
vectorized:

- level d holds all blocks (i, i+d) as one (B, n+1, m+1, m+1) tensor per
  state; a block depends only on levels d-1 ((i, j-1) and (i+1, j)) and d-2
  (G0 of (i+1, j-1)) — an anti-diagonal wavefront over x-spans;
- within a block the reference's k-descending / l-ascending sweeps are
  first-order recurrences:
      K3(k,l) = K3(k+1,l) + inj(k,l)          reverse cumsum over k
      G3(k,l) = g*G3(k+1,l) + injG(k,l)       reverse linear recurrence
      K2(k,l) = K2(k,l-1) + K3(k,l)           cumsum over l
      G2(k,l) = g*G2(k,l-1) + G3(k,l)         linear recurrence over l
      K1/G1, K0/G0: elementwise adds from the d-1 level (dp_init/dp_update,
      stem_kernel.cpp:85-111);
- the match injection (stem_kernel.cpp:293-326):
      pairable(i,j-1) & pairable(k,l-1):
        equal end bases:  K3 += G0_{d-2}(i+1)(k+1,l-1)*stack*bp_ij*bp_kl
                          G3 += G0_{d-2}(i+1)(k+1,l-1)
        else:             K3 += G0_{d-2}(i+1)(k+1,l-1)*stack*subst*bp_ij*bp_kl
- banding (partial_dp's c_low/c_high windows) masks the match injection
  outside per-i column windows; the reference's out-of-band boundary
  approximations (stem_kernel.cpp:165-246) trade accuracy for memory, which
  the dense formulation does not need.

Base-pair predicates mirror stem_kernel.cpp:353-421: Normal (Watson-Crick),
Wobble (+GU), or a supplied BPP matrix with probability bound.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.alphabet import RNA_A, RNA_C, RNA_G, RNA_U
from ..ops.recurrence import linear_recurrence


def pair_weights(
    codes: np.ndarray,
    length: int,
    *,
    use_GU: bool = True,
    min_loop: int = 3,
    bpp: np.ndarray | None = None,
    bp_bound: float = 0.0,
) -> np.ndarray:
    """(n, n) pair weight matrix w[i, j] for closing positions (i, j).

    Predicate variants give weight 1 to allowed pairs (NormalBasePair /
    WobbleBasePair, stem_kernel.cpp:353-390); with a BPP matrix the weight is
    the probability, zeroed below ``bp_bound`` (Vienna-backed BPMatrix,
    :392-421).  Pairs must enclose at least ``min_loop`` unpaired bases.
    """
    n = len(codes)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    if bpp is not None:
        w = np.where(bpp > bp_bound, bpp, 0.0)
    else:
        a, b = codes[ii], codes[jj]
        wc = ((a == RNA_A) & (b == RNA_U)) | ((a == RNA_U) & (b == RNA_A)) | (
            (a == RNA_C) & (b == RNA_G)
        ) | ((a == RNA_G) & (b == RNA_C))
        if use_GU:
            wc |= ((a == RNA_G) & (b == RNA_U)) | ((a == RNA_U) & (b == RNA_G))
        w = wc.astype(np.float64)
    w = np.where(jj - ii > min_loop, w, 0.0)
    w = np.where((ii < length) & (jj < length), w, 0.0)
    return w


@partial(jax.jit, static_argnames=("band",))
def full_stem_kernel(
    x_codes: jax.Array,  # (B, n)
    y_codes: jax.Array,  # (B, m)
    lx: jax.Array,
    ly: jax.Array,
    bp_x: jax.Array,  # (B, n, n) pair weights
    bp_y: jax.Array,  # (B, m, m)
    gap: jax.Array,
    stack: jax.Array,
    subst: jax.Array,
    band: int = 0,
    win_lo: jax.Array | None = None,  # (B, n+1) per-position y-window lows
    win_hi: jax.Array | None = None,  # (B, n+1) y-window highs
) -> jax.Array:
    """Batched full stem kernel values (B,).

    ``band > 0`` restricts match injections to per-position diagonal
    windows: y-start k within +-band of x-start i's diagonal image and
    y-end l within +-band of the x-end j's — the band-only variant of
    alignment_constraints (stem_kernel.cpp:70-76).  NOTE: the reference's
    partial_dp also *approximates* out-of-window table reads
    (stem_kernel.cpp:165-246) to save memory; the dense formulation keeps
    everything else exact, so banded values are a tighter approximation
    than the reference's.
    """
    bsz, n = x_codes.shape
    m = y_codes.shape[1]
    dt = bp_x.dtype
    gap = jnp.asarray(gap, dt)
    stack = jnp.asarray(stack, dt)
    subst = jnp.asarray(subst, dt)

    k_idx = jnp.arange(m + 1)
    l_idx = jnp.arange(m + 1)
    low_tri = (k_idx[:, None] <= l_idx[None, :]).astype(dt)  # valid k <= l
    diag_kl = (k_idx[:, None] == l_idx[None, :]).astype(dt)

    eq = (x_codes[:, :, None] == y_codes[:, None, :])  # (B, n, m)

    # level d = 0: K0 = 1 everywhere, G0(k,l) = g^(l-k) on k <= l
    gpow = gap ** (l_idx[None, :] - k_idx[:, None]).astype(dt)
    K0_0 = jnp.ones((bsz, n + 1, m + 1, m + 1), dt)
    G0_0 = jnp.broadcast_to((gpow * low_tri)[None, None], (bsz, n + 1, m + 1, m + 1)).astype(dt)
    zeros = jnp.zeros((bsz, n + 1, m + 1, m + 1), dt)

    def shift_i(t):  # value at start i+1 (block to the "lower-left")
        return jnp.concatenate([t[:, 1:], jnp.zeros_like(t[:, :1])], axis=1)

    def level_step(carry, d):
        (K0p, G0p, K1p, G1p, G0pp) = carry
        # gather ingredients
        K1_base = shift_i(K1p)  # K1(i+1, j) level d-1
        G1_base = shift_i(G1p)
        K0_base = K0p  # K0(i, j-1) level d-1 (same start index)
        G0_base = G0p
        G0_inner = shift_i(G0pp)  # G0(i+1, j-1) level d-2

        # match injection over (B, i, k, l)
        i_idx = jnp.arange(n + 1)
        jm1 = jnp.clip(i_idx + d - 1, 0, n - 1)  # j-1 per start i
        valid_i = (i_idx + d <= n)
        # bp_x(i, j-1) per start i
        bpx_d = jnp.where(
            valid_i[None, :], bp_x[:, jnp.minimum(i_idx, n - 1), jm1], 0.0
        )  # (B, n+1)
        # eq1[i, k] = x[i] == y[k]; eq2[i, l] = x[j-1] == y[l-1]
        eq1 = eq[:, jnp.minimum(i_idx, n - 1), :]  # (B, n+1, m)
        eq2 = eq[:, jm1, :]  # (B, n+1, m) indexed by l-1
        # G0_inner at (k+1, l-1): shift k down, l up
        base = G0_inner[:, :, 1:, :]  # k+1
        base = jnp.concatenate([base, jnp.zeros_like(base[:, :, :1])], axis=2)
        base = jnp.concatenate([jnp.zeros_like(base[..., :1]), base[..., :-1]], axis=3)  # l-1
        # bp_y(k, l-1): (B, m+1, m+1)
        bpy_kl = jnp.pad(bp_y, ((0, 0), (0, 1), (1, 0)))
        both_eq = (
            jnp.pad(eq1, ((0, 0), (0, 0), (0, 1)))[:, :, :, None]
            * jnp.pad(eq2, ((0, 0), (0, 0), (1, 0)))[:, :, None, :]
        )
        wfac = bpx_d[:, :, None, None] * bpy_kl[:, None, :, :]
        inj_k3 = base * stack * wfac * jnp.where(both_eq > 0, 1.0, subst)
        inj_g3 = base * both_eq * jnp.where(wfac > 0, 1.0, 0.0)
        if band > 0:
            # per-position diagonal windows: k near image of i, l near image of j
            kl = jnp.arange(m + 1)
            # floor(x + 0.5), matching the reference's uint(double(i)/n*m + 0.5)
            # (stem_kernel.cpp:70-76) and the banded kernel's staircase anchor
            ci = jnp.floor(
                jnp.minimum(i_idx[None, :], lx[:, None]) / jnp.maximum(lx[:, None], 1)
                * ly[:, None] + 0.5)
            cj = jnp.floor(
                jnp.minimum(jnp.minimum(i_idx[None, :] + d, n), lx[:, None])
                / jnp.maximum(lx[:, None], 1) * ly[:, None] + 0.5)
            k_ok = jnp.abs(kl[None, None, :] - ci[:, :, None]) <= band
            l_ok = jnp.abs(kl[None, None, :] - cj[:, :, None]) <= band
            bm = (k_ok[:, :, :, None] & l_ok[:, :, None, :]).astype(dt)
            inj_k3 = inj_k3 * bm
            inj_g3 = inj_g3 * bm
        if win_lo is not None:
            # pair-HMM alignment windows (partial_dp's c_low/c_high,
            # stem_kernel.cpp:165-246): k in the window of start i, l in
            # the window of end j = i + d
            kl = jnp.arange(m + 1)
            j_at = jnp.minimum(i_idx[None, :] + d, n)  # (1, n+1)
            lo_i = win_lo[:, :]                        # (B, n+1) at i
            hi_i = win_hi[:, :]
            lo_j = jnp.take_along_axis(win_lo, jnp.broadcast_to(j_at, win_lo.shape), 1)
            hi_j = jnp.take_along_axis(win_hi, jnp.broadcast_to(j_at, win_hi.shape), 1)
            k_ok = (kl[None, None, :] >= lo_i[:, :, None]) & (kl[None, None, :] <= hi_i[:, :, None])
            l_ok = (kl[None, None, :] >= lo_j[:, :, None]) & (kl[None, None, :] <= hi_j[:, :, None])
            wm = (k_ok[:, :, :, None] & l_ok[:, :, None, :]).astype(dt)
            inj_k3 = inj_k3 * wm
            inj_g3 = inj_g3 * wm
        # zero out k > l-? and out-of-range blocks
        mask_kl = low_tri[None, None]
        inj_k3 = inj_k3 * mask_kl * valid_i[None, :, None, None]
        inj_g3 = inj_g3 * mask_kl * valid_i[None, :, None, None]

        # within-block recursions
        # K3: reverse cumsum over k; G3: reverse linear recurrence (decay g)
        K3 = jnp.cumsum(inj_k3[:, :, ::-1, :], axis=2)[:, :, ::-1, :]
        G3 = jnp.swapaxes(
            linear_recurrence(
                gap, jnp.swapaxes(inj_g3, 2, 3), reverse=True
            ),
            2,
            3,
        )
        # K2: cumsum over l; G2: linear recurrence over l (decay g)
        K2 = jnp.cumsum(K3, axis=3)
        G2 = linear_recurrence(gap, G3)
        K1 = K1_base + K2
        G1 = G1_base * gap + G2
        K0 = K0_base + K1
        G0 = G0_base * gap + G1
        # boundary overrides on the (l, l) diagonal and upper triangle
        K0 = K0 * low_tri + (1.0 - low_tri) * 0.0
        K0 = jnp.where(diag_kl[None, None] > 0, 1.0, K0)
        G0 = G0 * low_tri
        G0 = jnp.where(diag_kl[None, None] > 0, gap ** jnp.asarray(d, dt), G0)
        K1 = K1 * low_tri * (1.0 - diag_kl)
        G1 = G1 * low_tri * (1.0 - diag_kl)

        out = K0[:, 0, 0, :]  # value row for spans (0, d): K0(0, d, 0, l)
        return (K0, G0, K1, G1, G0p), out

    init = (K0_0, G0_0, zeros, zeros, zeros)
    _, outs = jax.lax.scan(level_step, init, jnp.arange(1, n + 1))
    # outs: (n, B, m+1); pick level lx, column ly
    outs = jnp.concatenate([K0_0[None, :, 0, 0, :], outs], axis=0)  # level 0..n
    return outs[lx, jnp.arange(bsz), ly]


def _pad_pair_to_common(x_codes, y_codes, bp_x, bp_y):
    """Pad both sides to one width: the banded window algebra indexes x and
    y through one block/lane geometry, but predict-mode streams featurize
    test chunks at their own pad shapes (cli/app.py)."""
    nx, ny = x_codes.shape[1], y_codes.shape[1]
    n = max(nx, ny)
    if nx < n:
        x_codes = jnp.pad(x_codes, ((0, 0), (0, n - nx)))
        bp_x = jnp.pad(bp_x, ((0, 0), (0, n - nx), (0, n - nx)))
    if ny < n:
        y_codes = jnp.pad(y_codes, ((0, 0), (0, n - ny)))
        bp_y = jnp.pad(bp_y, ((0, 0), (0, n - ny), (0, n - ny)))
    return x_codes, y_codes, bp_x, bp_y


def _staircase_anchor(lx: jax.Array, ly: jax.Array, n: int):
    """Monotone window anchors a[t] = floor(min(t, lx) * ly / lx + 0.5).

    The reference's scaled-diagonal band center
    (/root/reference/stem_kernel/stem_kernel.cpp:70-76:
    ``j = uint(double(i)/x.size()*y.size()+0.5)``), evaluated per pair.
    Requires ly <= lx so consecutive anchors differ by 0 or 1 (the
    conditional-shift window algebra below relies on it); callers swap the
    pair otherwise (the kernel is symmetric).  Returns (a, delta_k) with
    a: (B, n+1) int32 and delta_k[t] = a[t+1] - a[t] in {0, 1}.
    """
    t = jnp.arange(n + 1)
    lx_ = jnp.maximum(lx, 1).astype(jnp.float32)
    a = jnp.floor(
        jnp.minimum(t[None, :], lx[:, None]).astype(jnp.float32)
        * ly[:, None].astype(jnp.float32) / lx_[:, None] + 0.5
    ).astype(jnp.int32)  # (B, n+1)
    delta_k = jnp.concatenate(
        [a[:, 1:] - a[:, :-1], jnp.zeros_like(a[:, :1])], axis=1
    )  # (B, n+1), in {0, 1}
    return a, delta_k


def phmm_anchor(x_codes, lx, y_codes, ly, bound: float):
    """PHMM-alignment window anchors conformed to a valid staircase.

    The reference's partial_dp centers its per-position windows on the
    pair-HMM MAP alignment when -a is given
    (/root/reference/stem_kernel/stem_kernel.cpp:13-69); here the posterior
    window midpoints (models.phmm.posterior_windows) are conformed to the
    banded kernel's staircase requirements — monotone, deltas in {0, 1},
    a(0) = 0, a(t >= lx) = ly (callers guarantee ly <= lx by swapping):
    a forward pass clamps each step to the previous value +0/+1, a backward
    max against ly - (lx - t) guarantees the endpoint is reached.  Steep
    alignment segments (y-insertions) therefore get covered slightly later
    than the MAP path places them, within the band's slack — the same class
    of approximation partial_dp's own out-of-window reads make.
    """
    from .phmm import posterior_windows

    win_lo, win_hi = posterior_windows(x_codes, lx, y_codes, ly, bound, 0)
    n = x_codes.shape[1]
    mid = jnp.clip((win_lo + win_hi) // 2, 0, ly[:, None])  # (B, n+1)

    def step(prev, m_t):
        a_t = jnp.minimum(prev + 1, jnp.maximum(m_t, prev))
        return a_t, a_t

    _, a_fw = jax.lax.scan(step, jnp.zeros(mid.shape[0], mid.dtype),
                           mid.T[1:])
    a = jnp.concatenate(
        [jnp.zeros((mid.shape[0], 1), mid.dtype), a_fw.T], axis=1
    )
    t_idx = jnp.arange(n + 1)
    floor = jnp.clip(ly[:, None] - (lx[:, None] - t_idx[None, :]), 0, None)
    a = jnp.maximum(a, floor)
    a = jnp.where(t_idx[None, :] >= lx[:, None], ly[:, None], a)
    a = jnp.minimum(a, ly[:, None]).astype(jnp.int32)
    delta_k = jnp.concatenate(
        [a[:, 1:] - a[:, :-1], jnp.zeros_like(a[:, :1])], axis=1
    )
    return a, delta_k


def _banded_precompute(x_codes, y_codes, lx, ly, bp_x, bp_y, band: int,
                       with_eg: bool = True, anchor=None):
    """Device-side, once-per-batch ingredients for the banded scan.

    Everything the level scan needs is either carried state or one of these
    tensors consumed by cheap dynamic slices — the scan body itself contains
    NO gathers (the round-3 banded kernel gathered (B,n,W,W) windows every
    step, which dominated its 8 pairs/s).
    """
    bsz, n = x_codes.shape
    W = 2 * band + 1
    if anchor is None:
        a, delta_k = _staircase_anchor(lx, ly, n)
    else:
        a, delta_k = anchor
    i_idx = jnp.arange(n + 1)
    w_idx = jnp.arange(W)

    # a padded so a[i+d] reads are dynamic slices: a_pad[:, t] = a[min(t, n)]
    a_pad = jnp.concatenate([a, jnp.broadcast_to(a[:, -1:], (bsz, n))], axis=1)
    dk_pad = jnp.concatenate([delta_k, jnp.zeros((bsz, n), jnp.int32)], axis=1)

    # absolute k of (block i, slot wk): a[i] - band + wk
    k_abs = a[:, :, None] - band + w_idx[None, None, :]  # (B, n+1, W)
    k_ok = (k_abs >= 0) & (k_abs < ly[:, None, None])
    kk = jnp.clip(k_abs, 0, n - 1)

    # eq1_win[b, i, wk] = (x[i] == y[k_abs])  (d-independent)
    xi = jnp.where(
        i_idx[None, :] < lx[:, None],
        jnp.take_along_axis(
            x_codes,
            jnp.broadcast_to(jnp.minimum(i_idx, n - 1)[None, :], (bsz, n + 1)),
            1,
        ),
        255,
    )
    yk = jnp.take_along_axis(y_codes, kk.reshape(bsz, -1), 1).reshape(bsz, n + 1, W)
    eq1_win = (xi[:, :, None] == yk) & k_ok

    # E2pad[b, r + ?]: E2[b, r, wl] = (x[r] == y[a[r+1] - band + wl - 1]),
    # read at r = i + d - 1 via a dynamic slice of the padded copy.
    r_idx = jnp.arange(n + 1)
    xr = jnp.where(r_idx[None, :] < lx[:, None],
                   jnp.take_along_axis(
                       x_codes, jnp.broadcast_to(
                           jnp.minimum(r_idx, n - 1)[None, :], (bsz, n + 1)), 1),
                   255)
    a_r1 = a_pad[:, 1:n + 2]  # a[r+1]
    l_abs_e2 = a_r1[:, :, None] - band + w_idx[None, None, :] - 1
    l_ok_e2 = (l_abs_e2 >= 0) & (l_abs_e2 < ly[:, None, None])
    yl = jnp.take_along_axis(
        y_codes, jnp.clip(l_abs_e2, 0, n - 1).reshape(bsz, -1), 1
    ).reshape(bsz, n + 1, W)
    E2 = (xr[:, :, None] == yl) & l_ok_e2  # (B, n+1, W)
    E2pad = jnp.concatenate([E2, jnp.zeros((bsz, n, W), bool)], axis=1)

    # SXT[b, d, i] = bp_x[i, i + d - 1] (zero out of range): per-step row read
    d_idx = jnp.arange(n + 1)
    col = i_idx[None, None, :] + d_idx[None, :, None] - 1  # (1, n+1_d, n+1_i)
    col_ok = (col >= 0) & (col < lx[:, None, None]) & (i_idx[None, None, :] < lx[:, None, None])
    flat = (jnp.minimum(i_idx, n - 1)[None, None, :] * n
            + jnp.clip(col, 0, n - 1))
    SXT = jnp.where(
        col_ok,
        jnp.take_along_axis(
            bp_x.reshape(bsz, -1), flat.reshape(1, -1).repeat(bsz, 0), 1
        ).reshape(bsz, n + 1, n + 1),
        0.0,
    )  # (B, n+1 levels, n+1 blocks)

    # EG[b, d-1, i, wk] = bp_y[k_abs(i, wk), a[i+d] + band]: the bp window
    # column that ENTERS when the l-window slides at level d.  Only the XLA
    # scan consumes this (the Pallas kernel's block-shift formulation needs
    # the entering k-ROW instead); with_eg=False skips the gather.
    d_lvl = jnp.arange(1, n + 1)
    idx_id = d_lvl[:, None] + i_idx[None, :]  # (n, n+1)
    a_at = jnp.take_along_axis(
        a_pad, jnp.broadcast_to(idx_id.reshape(1, -1), (bsz, n * (n + 1))), 1
    ).reshape(bsz, n, n + 1)  # a[i+d]
    EG = None
    if with_eg:
        # entering slot wl = W-1 holds bp_y(k, l-1) at l-1 = a[i+d] + band - 1
        c_eg = a_at + band - 1  # (B, n, n+1)
        c_ok = (c_eg >= 0) & (c_eg < ly[:, None, None])
        flat_eg = (kk[:, None, :, :] * n + jnp.clip(c_eg, 0, n - 1)[:, :, :, None])
        EG = jnp.where(
            c_ok[:, :, :, None] & k_ok[:, None, :, :],
            jnp.take_along_axis(
                bp_y.reshape(bsz, -1), flat_eg.reshape(bsz, -1), 1
            ).reshape(bsz, n, n + 1, W),
            0.0,
        )  # (B, n, n+1, W)

    # initial bp_y window at level d = 0 (the scan's step-d slide update
    # turns BW(d-1) into BW(d)): BW0[i, wk, wl] = bp_y[k_abs, a[i]-1-band+wl]
    l0 = a[:, :, None] - 1 - band + w_idx[None, None, :]  # (B, n+1, W)
    l0_ok = (l0 >= 0) & (l0 < ly[:, None, None])
    flat0 = kk[:, :, :, None] * n + jnp.clip(l0, 0, n - 1)[:, :, None, :]
    BW0 = jnp.where(
        l0_ok[:, :, None, :] & k_ok[:, :, :, None],
        jnp.take_along_axis(
            bp_y.reshape(bsz, -1), flat0.reshape(bsz, -1), 1
        ).reshape(bsz, n + 1, W, W),
        0.0,
    )
    return a, a_pad, dk_pad, eq1_win, E2pad, SXT, EG, BW0


def full_stem_kernel_banded(*args, **kwargs) -> np.ndarray:
    """Raw-value wrapper over :func:`full_stem_kernel_banded_log`.

    Returns a host-side float64 array: the exp is evaluated with NumPy so the
    double range is real even when ``jax_enable_x64`` is off (a jnp float64
    cast silently degrades to float32 in that default config, turning long
    well-pairing inputs into inf).  The reference computes in C++ doubles,
    which still overflow eventually (values grow like 10^(0.15 n)) — use the
    log variant with the Gram engine's ``log_values=True`` for production.
    """
    log_vals = full_stem_kernel_banded_log(*args, **kwargs)
    return np.exp(np.asarray(log_vals, dtype=np.float64))


@partial(jax.jit, static_argnames=("band", "precision", "ali_bound"))
def full_stem_kernel_banded_log(
    x_codes: jax.Array,  # (B, n)
    y_codes: jax.Array,  # (B, n) — same pad as x (swap support)
    lx: jax.Array,
    ly: jax.Array,
    bp_x: jax.Array,  # (B, n, n)
    bp_y: jax.Array,  # (B, n, n)
    gap: jax.Array,
    stack: jax.Array,
    subst: jax.Array,
    band: int = 16,
    precision: str = "highest",
    ali_bound: float = 0.0,
) -> jax.Array:
    """Windowed-memory full stem kernel: O(B n W^2) live state, W = 2*band+1.

    The array-native equivalent of the reference's banded partial_dp with row
    recycling (/root/reference/stem_kernel/stem_kernel.cpp:165-246,
    stem_kernel/dptable.h:41-116): each block (i, j=i+d) stores only a
    (W, W) window of the (k, l) plane anchored on the SCALED diagonal —
    k in a(i) +- band, l in a(j) +- band with a(t) = round(t*ly/lx), the
    same staircase the reference's band branch uses
    (stem_kernel.cpp:70-76).  Pairs are swapped internally so lx >= ly
    (the kernel is symmetric), which makes consecutive anchors differ by
    delta in {0, 1}; window re-anchoring between levels becomes a
    per-block conditional shift.

    Window algebra: out-of-window state values have closed forms —
    K-states are CONSTANT beyond the band (cumsums of band-masked
    injections), so a shifting window clamp-fills its entering edge;
    G-states DECAY by exactly ``gap`` per step beyond the band, so the
    entering edge is gap * edge.  For lx == ly the staircase is slope 1,
    every shift fires, and the banded kernel equals the dense
    ``full_stem_kernel(band=band)`` to floating-point accuracy.  For
    lx != ly the skipped shifts introduce the same class of boundary
    approximation the reference's partial_dp makes explicitly
    (stem_kernel.cpp:179-191: clamped out-of-window reads), so values
    track the dense scaled-band kernel closely rather than exactly.

    ``precision``: float32 matmul precision of the (W, W) window contractions,
    with the meanings of models/stem_kernel.py:PRECISIONS.

    Returns log K.  Kernel values grow like 10^(0.15 n) on well-pairing
    inputs (the reference holds them in C++ doubles, stem_kernel.cpp:83);
    to stay in float32 the scan rescales all states per level
    by the running maximum of K0 and tracks the log-scale per pair —
    exactly the pf_scale trick of the McCaskill engine
    (fold/mccaskill_scaled.py).  Fresh-diagonal seeds entering below the
    float32 noise floor of the rescaled states underflow to zero, which
    matches their true relative weight.
    """
    x_codes, y_codes, bp_x, bp_y = _pad_pair_to_common(
        x_codes, y_codes, bp_x, bp_y)
    bsz, n = x_codes.shape
    dt = bp_x.dtype
    gap = jnp.asarray(gap, dt)
    stack = jnp.asarray(stack, dt)
    subst = jnp.asarray(subst, dt)
    W = 2 * band + 1

    # swap pairs so lx >= ly (anchor deltas stay in {0, 1})
    swap = ly > lx
    x_codes, y_codes = (
        jnp.where(swap[:, None], y_codes, x_codes),
        jnp.where(swap[:, None], x_codes, y_codes),
    )
    bp_x, bp_y = (
        jnp.where(swap[:, None, None], bp_y, bp_x),
        jnp.where(swap[:, None, None], bp_x, bp_y),
    )
    lx, ly = jnp.where(swap, ly, lx), jnp.where(swap, lx, ly)

    anchor = None
    if ali_bound > 0.0:
        # MAP-alignment window anchors (partial_dp's -a mode,
        # stem_kernel.cpp:13-69), conformed to the staircase algebra
        anchor = phmm_anchor(x_codes, lx, y_codes, ly, ali_bound)
    (a, a_pad, dk_pad, eq1_win, E2pad, SXT, EG, BW0) = _banded_precompute(
        x_codes, y_codes, lx, ly, bp_x, bp_y, band, anchor=anchor
    )

    i_idx = jnp.arange(n + 1)
    w_idx = jnp.arange(W)
    dk = jnp.take_along_axis(
        dk_pad, jnp.broadcast_to(i_idx[None, :], (bsz, n + 1)), 1
    )  # delta_k at block i (d-independent)
    dk_m = (dk > 0)[:, :, None, None]

    rel = w_idx[None, :] - w_idx[:, None]  # wl - wk at d = 0 (anchors equal)
    G0_0 = jnp.broadcast_to(
        (gap ** rel.astype(dt)) * (rel >= 0).astype(dt), (bsz, n + 1, W, W)
    ).astype(dt)
    K0_0 = jnp.ones((bsz, n + 1, W, W), dt)
    zeros = jnp.zeros((bsz, n + 1, W, W), dt)

    # triangular contraction matrices (see round-3 notes: einsum, not scan —
    # the associative_scan lowering crashed an XLA fusion emitter at
    # W >= 33 on these shapes, and matmuls are the cheap path anyway)
    rel_w = w_idx[:, None] - w_idx[None, :]
    up_ones = (rel_w <= 0).astype(dt)
    up_gap = up_ones * gap ** jnp.maximum(-rel_w, 0).astype(dt)
    prec = {"highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT}[precision]

    def shift_i(t):  # block at start i+1
        return jnp.concatenate([t[:, 1:], jnp.zeros_like(t[:, :1])], axis=1)

    def level_step(carry, xs):
        (K0p, G0p, K1p, G1p, G0pp, BW, logS) = carry
        d, eg = xs
        # ---- per-step slices (no gathers) ----
        a_d = jax.lax.dynamic_slice_in_dim(a_pad, d, n + 1, axis=1)  # a[i+d]
        off = a_d - a  # (B, n+1) anchor offset a(i+d) - a(i)
        dj = jax.lax.dynamic_slice_in_dim(dk_pad, d - 1, n + 1, axis=1)  # a[i+d]-a[i+d-1]
        dj_m = (dj > 0)[:, :, None, None]
        e2 = jax.lax.dynamic_slice_in_dim(E2pad, d - 1, n + 1, axis=1)  # (B, n+1, W)
        bpx_d = jax.lax.dynamic_slice_in_dim(SXT, d, 1, axis=1)[:, 0]  # (B, n+1)

        # ---- bp_y window slides with the l-anchor ----
        BW_s = jnp.concatenate([BW[..., 1:], eg[:, :, :, None]], -1)
        BW = jnp.where(dj_m, BW_s, BW)

        # ---- state re-anchoring ----
        # K1(i+1, j): k-anchor a(i+1) -> a(i): conditional wk-shift
        t = shift_i(K1p)
        K1_base = jnp.where(
            dk_m, jnp.concatenate([t[:, :, :1], t[:, :, :-1]], 2), t
        )
        t = shift_i(G1p)
        G1_base = jnp.where(
            dk_m, jnp.concatenate([gap * t[:, :, :1], t[:, :, :-1]], 2), t
        )
        # K0(i, j-1): l-anchor a(j-1) -> a(j): conditional wl-shift
        K0_base = jnp.where(
            dj_m, jnp.concatenate([K0p[..., 1:], K0p[..., -1:]], -1), K0p
        )
        G0_base = jnp.where(
            dj_m, jnp.concatenate([G0p[..., 1:], gap * G0p[..., -1:]], -1), G0p
        )
        # G0(i+1, j-1) read at (k+1, l-1): slot shifts (1 - delta_k) in wk
        # and (dj - 1) in wl; clamp fills (boundary approximation, only
        # active when lx != ly)
        t = shift_i(G0pp)
        base = jnp.where(
            dk_m, t, jnp.concatenate([t[:, :, 1:], t[:, :, -1:]], 2)
        )
        base = jnp.where(
            dj_m, base, jnp.concatenate([base[..., :1], base[..., :-1]], -1)
        )

        # ---- injection ----
        both_eq = (eq1_win[:, :, :, None] & e2[:, :, None, :]).astype(dt)
        wfac = bpx_d[:, :, None, None] * BW
        inj_k3 = base * stack * wfac * jnp.where(both_eq > 0, 1.0, subst)
        inj_g3 = base * both_eq * jnp.where(wfac > 0, 1.0, 0.0)
        # absolute k <= l  <=>  wk <= off + wl
        tri_w = (
            w_idx[None, None, :, None] <= off[:, :, None, None] + w_idx[None, None, None, :]
        ).astype(dt)
        inj_k3 = inj_k3 * tri_w
        inj_g3 = inj_g3 * tri_w

        # ---- within-window recursions (matmul contractions) ----
        K3 = jnp.einsum("ab,xnbl->xnal", up_ones, inj_k3, precision=prec)
        G3 = jnp.einsum("ab,xnbl->xnal", up_gap, inj_g3, precision=prec)
        K2 = jnp.einsum("xnka,al->xnkl", K3, up_ones, precision=prec)
        G2 = jnp.einsum("xnka,al->xnkl", G3, up_gap, precision=prec)
        K1 = K1_base + K2
        G1 = G1_base * gap + G2
        K0 = K0_base + K1
        G0 = G0_base * gap + G1

        # ---- boundary overrides: absolute diagonal k == l at wk - wl == off
        # (diagonal seeds live at the CURRENT scale: value 1 -> exp(-logS))
        diag_w = (
            w_idx[None, None, :, None] - w_idx[None, None, None, :]
            == off[:, :, None, None]
        )
        s_inv = jnp.exp(-logS)[:, None, None, None]
        K0 = K0 * tri_w
        K0 = jnp.where(diag_w, s_inv, K0)
        G0 = G0 * tri_w
        G0 = jnp.where(diag_w, gap ** jnp.asarray(d, dt) * s_inv, G0)
        ndiag = 1.0 - diag_w.astype(dt)
        K1 = K1 * tri_w * ndiag
        G1 = G1 * tri_w * ndiag

        out = K0[:, 0, band, band]  # block (0, d) at k=0, l=a(d)
        out_log = jnp.where(out > 0, jnp.log(jnp.maximum(out, 1e-38)), -jnp.inf) + logS

        # ---- per-level rescale (pf_scale trick): keep states near 1
        m = jnp.maximum(
            jnp.max(jnp.abs(K0), axis=(1, 2, 3)), 1e-30
        )[:, None, None, None]
        K0, G0, K1, G1 = K0 / m, G0 / m, K1 / m, G1 / m
        G0p = G0p / m
        logS = logS + jnp.log(m[:, 0, 0, 0])
        return (K0, G0, K1, G1, G0p, BW, logS), out_log

    init = (K0_0, G0_0, zeros, zeros, zeros, BW0, jnp.zeros((bsz,), dt))
    _, outs = jax.lax.scan(
        level_step, init,
        (jnp.arange(1, n + 1), jnp.moveaxis(EG, 1, 0)),
    )
    # outs[d-1, b] = log K(0, d, 0, a(d)); the kernel value is level d = lx
    # (a(lx) = ly by construction — any length combination is in-window)
    vals = outs[jnp.clip(lx - 1, 0, n - 1), jnp.arange(bsz)]
    return jnp.where(lx == 0, 0.0, vals)
