"""Gap-weighted all-substrings string kernels, batched over pairs.

Reimplements (a redesign, not a translation) the recursions of:

- the profile string kernel
  (/root/reference/stem_kernel_lite/string_kernel.cpp:66-132):
      v       = G0[i-1][j-1] * w_x[i-1] * w_y[j-1] * subst(x[i-1], y[j-1])
      K1[j]   = v + K1[j-1]
      G1[j]   = v + G1[j-1]*gap
      K0[i][j] = K1[j] + K0[i-1][j]
      G0[i][j] = G1[j] + G0[i-1][j]*gap
  with K0[*][0] = K0[0][*] = 1 and G0 boundary gap^i / gap^j; result
  K0[|x|][|y|].

- the plain exact-match string kernel
  (/root/reference/string_kernel/string_kernel.cpp:11-51), which is the same
  recursion with v = G0[i-1][j-1] * gap^2 * [x_i == y_j].

Design: the per-cell substitution score becomes a precomputed (B, Lx, Ly)
score tensor (a matmul over column profiles), and the row recursion
becomes a `lax.scan` over rows whose inner column dependencies (K1 cumulative
sum, G1 first-order recurrence) are parallel associative scans — O(Lx) scan
steps of O(B*Ly) vector work rather than O(Lx*Ly) sequential cells.

Padding contract: if the score tensor is zero outside the valid (len_x, len_y)
region, the DP value at the padded corner equals the value at the true corner,
because zero-score cells contribute v = 0 and K0 rows/columns then carry
constant values forward.  Callers therefore just mask the score tensor.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.alphabet import N_RNA
from ..ops.recurrence import linear_recurrence
from .ribosum_data import RIBOSUM_S


def ribosum_subst_table(alpha: float) -> np.ndarray:
    """exp(RIBOSUM_S * alpha) — StringKernel ctor, string_kernel.cpp:11-21."""
    return np.exp(RIBOSUM_S * alpha).astype(np.float32)


def match_mismatch_table(match: float, mismatch: float) -> np.ndarray:
    """match on the diagonal, mismatch elsewhere (string_kernel.cpp:23-34)."""
    t = np.full((N_RNA, N_RNA), mismatch, dtype=np.float32)
    np.fill_diagonal(t, match)
    return t


def profile_subst_scores(
    px: jax.Array,
    py: jax.Array,
    subst: jax.Array,
) -> jax.Array:
    """Expected substitution score between profile columns, all pairs at once.

    ``px``: (B, Lx, N_RNA) raw fractional base counts per column (gap slot
    excluded); ``py``: (B, Ly, N_RNA); ``subst``: (N_RNA, N_RNA).

    Returns (B, Lx, Ly) with entry [b, i, j] equal to
    sum_ab subst[a,b]*px[i,a]*py[j,b] / sum_ab px[i,a]*py[j,b], and 1.0 where
    the normalizer is zero (all-gap column), matching subst_score at
    /root/reference/stem_kernel_lite/string_kernel.cpp:44-64.

    The numerator is a batched matmul; the denominator an outer product
    of column sums.
    """
    num = jnp.einsum(
        "nia,ab,njb->nij", px, subst, py,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )
    den = jnp.einsum(
        "nia,njb->nij", px, py,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.where(den == 0, 1.0, num / jnp.where(den == 0, 1.0, den))


@jax.jit
def gap_weighted_string_kernel(scores: jax.Array, gap: jax.Array) -> jax.Array:
    """Batched gap-weighted all-substrings kernel over a score tensor.

    ``scores``: (B, Lx, Ly) per-cell match contributions v(i, j) *excluding*
    the G0[i-1][j-1] factor — i.e. the product of substitution score and any
    position weights, already zero-masked outside each pair's valid region.
    ``gap``: scalar gap weight.

    Returns (B,) kernel values K0[Lx][Ly].
    """
    bsz, lx, ly = scores.shape
    dt = scores.dtype
    gap = jnp.asarray(gap, dtype=dt)

    # Boundary row 0: K0 = 1, G0[0][j] = gap^j for j = 0..Ly.  Inits derive
    # from the input so scan carries inherit shard_map varying annotations.
    zero_state = jnp.concatenate([scores[:, 0, :] * 0, jnp.zeros((bsz, 1), dt)], axis=-1)
    ones_col = zero_state[:, :1] + 1.0
    k0 = zero_state + 1.0
    g0 = zero_state + gap ** jnp.arange(ly + 1, dtype=dt)[None, :]

    def row_step(carry, s_row):
        k0_prev, g0_prev = carry  # (B, Ly+1)
        v = g0_prev[:, :-1] * s_row  # v[j] uses G0[i-1][j-1]
        k1 = jnp.cumsum(v, axis=-1)
        g1 = linear_recurrence(gap, v)
        k0_row = jnp.concatenate([ones_col, k1 + k0_prev[:, 1:]], axis=-1)
        g0_row = jnp.concatenate([g0_prev[:, :1] * gap, g1 + gap * g0_prev[:, 1:]], axis=-1)
        return (k0_row, g0_row), None

    (k0, _), _ = jax.lax.scan(row_step, (k0, g0), jnp.swapaxes(scores, 0, 1))
    return k0[:, -1]


class StringKernel:
    """Profile string kernel with RIBOSUM or match/mismatch substitution.

    Evaluates batches of alignment pairs given padded profile tensors.  The
    per-position weights (unpaired-loop profiles, used when convolved with the
    stem kernel — string_kernel.cpp:93-110) multiply the score tensor.
    """

    def __init__(
        self,
        gap: float,
        *,
        alpha: float | None = None,
        match: float | None = None,
        mismatch: float | None = None,
    ) -> None:
        if alpha is not None:
            self.subst = jnp.asarray(ribosum_subst_table(alpha))
        elif match is not None and mismatch is not None:
            self.subst = jnp.asarray(match_mismatch_table(match, mismatch))
        else:
            raise ValueError("need alpha or (match, mismatch)")
        self.gap = float(gap)

    @partial(jax.jit, static_argnums=0)
    def _eval(self, px, lx, wx, py, ly, wy):
        scores = profile_subst_scores(px, py, self.subst)
        scores = scores * (wx[:, :, None] * wy[:, None, :])
        mask_x = jnp.arange(px.shape[1])[None, :] < lx[:, None]
        mask_y = jnp.arange(py.shape[1])[None, :] < ly[:, None]
        scores = scores * (mask_x[:, :, None] & mask_y[:, None, :])
        return gap_weighted_string_kernel(scores, self.gap)

    def __call__(self, px, lx, py, ly, wx=None, wy=None):
        """Kernel values for a batch of pairs.

        px, py: (B, L, N_RNA) profiles; lx, ly: (B,) true lengths;
        wx, wy: (B, L) position weights or None (treated as 1).
        """
        if wx is None:
            wx = jnp.ones(px.shape[:2], dtype=px.dtype)
        if wy is None:
            wy = jnp.ones(py.shape[:2], dtype=py.dtype)
        return self._eval(px, jnp.asarray(lx), wx, py, jnp.asarray(ly), wy)


@jax.jit
def exact_match_scores(x: jax.Array, lx: jax.Array, y: jax.Array, ly: jax.Array, gap: jax.Array) -> jax.Array:
    """Score tensor for the plain string kernel: gap^2 where codes match.

    x, y: (B, L) uint8 code arrays (ungapped sequences, padded); the gap^2
    factor folds the two matched-character gap weights of
    string_kernel/string_kernel.cpp:42-44 into the score tensor.
    """
    eq = (x[:, :, None] == y[:, None, :]).astype(jnp.float32)
    mask_x = jnp.arange(x.shape[1])[None, :] < lx[:, None]
    mask_y = jnp.arange(y.shape[1])[None, :] < ly[:, None]
    valid = (mask_x[:, :, None] & mask_y[:, None, :]).astype(jnp.float32)
    return eq * valid * (jnp.asarray(gap, jnp.float32) ** 2)


def plain_string_kernel(x, lx, y, ly, gap):
    """The string_kernel/ binary's kernel on encoded sequences (B,) -> values."""
    scores = exact_match_scores(x, jnp.asarray(lx), y, jnp.asarray(ly), jnp.asarray(gap, jnp.float32))
    return gap_weighted_string_kernel(scores, gap)
