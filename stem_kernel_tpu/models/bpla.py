"""BPLA — base-pair local-alignment kernels, batched over sequence pairs.

Reimplements the kernels of /root/reference/bpla_kernel/:

- match score (BPLAScore, bpla_kernel.cpp:47-62):
      s(i,j) = alpha * (p_right_x[i]*p_right_y[j] + p_left_x[i]*p_left_y[j])
             + p_unpair_x[i]*p_unpair_y[j] * la_score(i,j)
  where la_score is the profile-expected substitution score with a 0.0
  empty-column fallback (LAScore, bpla_kernel.cpp:17-45), and the structural
  profiles are sqrt of summed base-pairing probabilities
  (bpla_kernel/data.cpp:19-45).

- the sum-over-local-alignments kernel (local_alignment_exp,
  bpla_kernel.cpp:64-115): 5 states M/X/Y/X2/Y2.  The returned value
  1 + X2[n][m] + Y2[n][m] + M[n][m] telescopes to 1 + sum_{i,j} M[i][j], so
  the implementation accumulates sum(M) directly and needs only the
  M/X/Y carries.

- the Smith-Waterman max variant (local_alignment_max,
  bpla_kernel.cpp:117-157).

- analytic gradients dK/d(alpha, beta, gap, ext): the reference hand-writes a
  7-state forward/backward pair (bpla_kernel.cpp:177-401); here the forward
  scan is differentiable and `jax.grad` performs the backward sweep, which is
  the idiomatic-JAX equivalent (validated against the reference recursion's
  oracle in tests).

Row-parallel structure (per scan step over i):
    M[i][j] = e[i][j] * (1 + M[i-1][j-1] + X[i-1][j-1] + Y[i-1][j-1])
    X[i][j] = bg*M[i-1][j] + be*X[i-1][j]                (parallel over j)
    Y[i][j] = bg*(M[i][j-1] + X[i][j-1]) + be*Y[i][j-1]  (1st-order recurrence)
with e = exp(beta*s) zero-masked outside each pair's valid region so the
padded corner equals the true-corner value (M vanishes on padded cells).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.recurrence import linear_recurrence, maxplus_recurrence

NEG_LARGE = -1e30


def la_score_matrix(px: jax.Array, py: jax.Array, score_table: jax.Array) -> jax.Array:
    """Profile-expected substitution scores, 0.0 where a column is empty.

    px: (B, Lx, N_RNA) fractional base counts; py: (B, Ly, N_RNA);
    score_table: (N_RNA, N_RNA).  Equivalent of LAScore
    (/root/reference/bpla_kernel/bpla_kernel.cpp:17-45).
    """
    num = jnp.einsum(
        "nia,ab,njb->nij", px, score_table, py,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )
    den = jnp.einsum(
        "nia,njb->nij", px, py,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.where(den == 0, 0.0, num / jnp.where(den == 0, 1.0, den))


def bpla_score_parts(
    px: jax.Array, plx: jax.Array, prx: jax.Array, pux: jax.Array,
    py: jax.Array, ply: jax.Array, pry: jax.Array, puy: jax.Array,
    score_table: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """(w_pair, w_unpair) so that s = alpha*w_pair + w_unpair.

    w_pair[i,j]   = p_right_x[i]*p_right_y[j] + p_left_x[i]*p_left_y[j]
    w_unpair[i,j] = p_unpair_x[i]*p_unpair_y[j] * la_score(i,j)
    (BPLAScore, bpla_kernel.cpp:47-62; the split matches the gradient
    decomposition at bpla_kernel.cpp:305-324.)
    """
    w_pair = prx[:, :, None] * pry[:, None, :] + plx[:, :, None] * ply[:, None, :]
    w_unpair = pux[:, :, None] * puy[:, None, :] * la_score_matrix(px, py, score_table)
    return w_pair, w_unpair


def bpla_factors(
    prof: jax.Array, pl: jax.Array, pr: jax.Array, pu: jax.Array,
    score_table: jax.Array, *, side: str,
) -> jax.Array:
    """Low-rank score factors f (B, L, 2 + N_RNA).

    The BPLA score tensor is separable: with u = p_unpair / sum(prof)
    (0 where the column is empty — the LAScore fallback),

        s[i,j] = alpha*(f_x[i,0]f_y[j,0] + f_x[i,1]f_y[j,1])
                 + sum_k f_x[i,2+k] f_y[j,2+k]

    where f = [p_right, p_left, u*prof (@ score_table on the x side)].
    Feeding factors to ops.la_triton.la_factored_triton avoids materializing
    the (B, Lx, Ly) score tensor in device memory.
    """
    tot = prof.sum(-1)
    u = jnp.where(tot > 0, pu / jnp.where(tot > 0, tot, 1.0), 0.0)
    unp = prof * u[..., None]
    if side == "x":
        unp = jnp.einsum("blk,km->blm", unp, score_table,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
    return jnp.concatenate([pr[..., None], pl[..., None], unp], axis=-1)


def pair_mask(lx: jax.Array, max_lx: int, ly: jax.Array, max_ly: int) -> jax.Array:
    """(B, Lx, Ly) validity mask from true lengths."""
    mx = jnp.arange(max_lx)[None, :] < lx[:, None]
    my = jnp.arange(max_ly)[None, :] < ly[:, None]
    return mx[:, :, None] & my[:, None, :]


@jax.jit
def local_alignment_exp(
    scores: jax.Array, mask: jax.Array,
    beta: jax.Array, gap: jax.Array, ext: jax.Array,
) -> jax.Array:
    """Sum-over-alignments kernel values (B,) from score tensor (B, Lx, Ly).

    Differentiable in (scores, beta, gap, ext); beta/gap/ext may be scalars or
    per-pair (B,) vectors (the latter makes batched dK/dparams a single
    backward pass).
    """
    bsz, lx, ly = scores.shape
    dt = scores.dtype
    beta = jnp.reshape(jnp.asarray(beta, dt), (-1, 1))  # (1,1) or (B,1)
    bg = jnp.exp(beta * jnp.reshape(jnp.asarray(gap, dt), (-1, 1)))
    be = jnp.exp(beta * jnp.reshape(jnp.asarray(ext, dt), (-1, 1)))

    e = jnp.exp(beta[..., None] * scores) * mask.astype(dt)  # (B, Lx, Ly)
    # derive zero inits from the input so scan carries inherit any manual-axis
    # (shard_map) varying annotations of the sharded batch
    zero_state = jnp.concatenate([e[:, 0, :] * 0, jnp.zeros((bsz, 1), dt)], axis=-1)
    zero_col = zero_state[:, :1]

    def row_step(carry, e_row):
        m_prev, x_prev, y_prev, acc = carry  # (B, Ly+1) states incl. j=0 col
        diag = 1.0 + m_prev[:, :-1] + x_prev[:, :-1] + y_prev[:, :-1]
        m_row = jnp.concatenate([zero_col, e_row * diag], axis=-1)
        x_row = bg * m_prev + be * x_prev  # column j=0 stays 0 (m/x prev are 0 there)
        q = bg * (m_row[:, :-1] + x_row[:, :-1])
        y_row = jnp.concatenate([zero_col, linear_recurrence(be, q)], axis=-1)
        return (m_row, x_row, y_row, acc + jnp.sum(m_row, axis=-1)), None

    init = (zero_state, zero_state, zero_state, zero_state[:, 0])
    (_, _, _, acc), _ = jax.lax.scan(row_step, init, jnp.swapaxes(e, 0, 1))
    return 1.0 + acc


@jax.jit
def local_alignment_log(
    scores: jax.Array, mask: jax.Array,
    beta: jax.Array, gap: jax.Array, ext: jax.Array,
) -> jax.Array:
    """log of :func:`local_alignment_exp` — overflow-safe for long sequences.

    The exp-space kernel grows like exp(beta * s * L) and saturates float32
    around L ~ 40 well-matched positions (the reference's doubles also
    overflow, just later).  This log-domain evaluation runs the identical
    recursion with (logaddexp, +) in place of (+, *); combined with
    log-space cosine normalization exp(logK(x,y) - (logK(x,x)+logK(y,y))/2)
    the pipeline never leaves a bounded range.
    """
    bsz, lx, ly = scores.shape
    dt = scores.dtype
    beta = jnp.reshape(jnp.asarray(beta, dt), (-1, 1))
    lbg = beta * jnp.reshape(jnp.asarray(gap, dt), (-1, 1))
    lbe = beta * jnp.reshape(jnp.asarray(ext, dt), (-1, 1))

    ls = beta[..., None] * scores
    ls = jnp.where(mask, ls, NEG_LARGE)  # (B, Lx, Ly) log emission
    neg_state = jnp.concatenate(
        [ls[:, 0, :] * 0 + NEG_LARGE, jnp.full((bsz, 1), NEG_LARGE, dt)], axis=-1
    )
    neg_col = neg_state[:, :1]

    from ..ops.recurrence import logsumexp_recurrence

    def row_step(carry, ls_row):
        m_prev, x_prev, y_prev, acc = carry  # (B, Ly+1) log states
        diag = jnp.logaddexp(
            0.0,
            jnp.logaddexp(
                m_prev[:, :-1], jnp.logaddexp(x_prev[:, :-1], y_prev[:, :-1])
            ),
        )
        m_row = jnp.concatenate([neg_col, ls_row + diag], axis=-1)
        x_row = jnp.logaddexp(lbg + m_prev, lbe + x_prev)
        q = lbg + jnp.logaddexp(m_row[:, :-1], x_row[:, :-1])
        y_row = jnp.concatenate(
            [neg_col, logsumexp_recurrence(jnp.broadcast_to(lbe, q.shape), q)],
            axis=-1,
        )
        acc = jnp.logaddexp(acc, jax.nn.logsumexp(m_row, axis=-1))
        return (m_row, x_row, y_row, acc), None

    init = (neg_state, neg_state, neg_state, neg_state[:, 0])
    (_, _, _, acc), _ = jax.lax.scan(row_step, init, jnp.swapaxes(ls, 0, 1))
    return jnp.logaddexp(0.0, acc)  # log(1 + sum M)


@jax.jit
def local_alignment_exp_flank(
    scores: jax.Array, mask: jax.Array,
    beta: jax.Array, gap: jax.Array, ext: jax.Array,
) -> jax.Array:
    """The optimizer's 7-state LA kernel (M/IX/IY/LX/LY/RX/RY), batched.

    NOTE: this is deliberately a *different* kernel from
    :func:`local_alignment_exp`.  The reference's BPLA_Forward
    (/root/reference/bpla_kernel/bpla_kernel.cpp:179-244) enters M from
    explicit flanking states whose counts are position-dependent
    (LX[i][j] = 1, LY[i][j] = j for i >= 1; row 0 is LX = [1,0,...],
    LY = 1), so its value differs from the 5-state CLI kernel; the
    bpla_optimizer fits hyperparameters against THIS value.  Verified
    identity: value = 1 + sum_{i,j} M[i][j], since RX/RY telescope the sum
    of M exactly as X2/Y2 do in the 5-state form.

    Differentiable in all parameters — `jax.grad` through this scan replaces
    the reference's hand-written BPLA_Backward/ForwardBackword sweeps
    (bpla_kernel.cpp:244-401).
    """
    bsz, lx, ly = scores.shape
    dt = scores.dtype
    beta = jnp.reshape(jnp.asarray(beta, dt), (-1, 1))
    bg = jnp.exp(beta * jnp.reshape(jnp.asarray(gap, dt), (-1, 1)))
    be = jnp.exp(beta * jnp.reshape(jnp.asarray(ext, dt), (-1, 1)))

    e = jnp.exp(beta[..., None] * scores) * mask.astype(dt)
    zero_state = jnp.concatenate([e[:, 0, :] * 0, jnp.zeros((bsz, 1), dt)], axis=-1)
    zero_col = zero_state[:, :1]

    # Flank counts LX[i-1][j-1] + LY[i-1][j-1] feeding M at row i, column j.
    # Row 0 has LX = [1,0,0,...], LY = 1 everywhere; rows i >= 1 have LX = 1
    # everywhere and LY[i][j] = [0,1,2,...,j-? ] with LY[i][0] = 0, so:
    # from row 0 (i = 1):  [2, 1, 1, ...] over j = 1..Ly
    # from rows >= 1:      [1, 2, 3, ...] i.e. max(j-1, 1) + [j > 1]
    j_idx = jnp.arange(1, ly + 1, dtype=dt)
    flank_row0 = jnp.where(j_idx == 1, 2.0, 1.0)
    flank_rest = jnp.where(j_idx == 1, 1.0, j_idx)

    def row_step(carry, xs):
        m_prev, ix_prev, iy_prev, acc = carry
        e_row, flank = xs
        diag = m_prev[:, :-1] + ix_prev[:, :-1] + iy_prev[:, :-1] + flank[None, :]
        m_row = jnp.concatenate([zero_col, e_row * diag], axis=-1)
        # IX column 0 is never filled in the reference (it would read the
        # M[0][0] start unit), so pin it to 0.
        ix_row = (bg * m_prev + be * ix_prev).at[:, 0].set(0.0)
        q = bg * (m_row[:, :-1] + ix_row[:, :-1])
        iy_row = jnp.concatenate([zero_col, linear_recurrence(be, q)], axis=-1)
        return (m_row, ix_row, iy_row, acc + jnp.sum(m_row, axis=-1)), None

    flanks = jnp.concatenate(
        [flank_row0[None, :], jnp.broadcast_to(flank_rest, (max(lx - 1, 0), ly))], axis=0
    )
    # M[0][0] = 1 (the "start here" unit) enters row 1's diagonal via m_prev.
    m0 = zero_state.at[:, 0].set(1.0)
    init = (m0, zero_state, zero_state, zero_state[:, 0])
    (_, _, _, acc), _ = jax.lax.scan(row_step, init, (jnp.swapaxes(e, 0, 1), flanks))
    return 1.0 + acc


@jax.jit
def local_alignment_max(
    scores: jax.Array, mask: jax.Array, gap: jax.Array, ext: jax.Array
) -> jax.Array:
    """Smith-Waterman maximum local-alignment score (B,)."""
    bsz, lx, ly = scores.shape
    dt = scores.dtype
    gap = jnp.asarray(gap, dt)
    ext = jnp.asarray(ext, dt)
    zero_state = jnp.concatenate([scores[:, 0, :] * 0, jnp.zeros((bsz, 1), dt)], axis=-1)
    zero_col = zero_state[:, :1]
    maskf = mask.astype(dt)

    def row_step(carry, xs):
        m_prev, x_prev, y_prev, best = carry
        s_row, mask_row = xs
        diag = jnp.maximum(0.0, jnp.maximum(m_prev[:, :-1], jnp.maximum(x_prev[:, :-1], y_prev[:, :-1])))
        m_row = jnp.concatenate([zero_col, diag + s_row], axis=-1)
        x_row = jnp.maximum(m_prev + gap, x_prev + ext)
        q = jnp.maximum(m_row[:, :-1], x_row[:, :-1]) + gap
        y_row = jnp.concatenate([zero_col, maxplus_recurrence(ext, q)], axis=-1)
        best = jnp.maximum(best, jnp.max(m_row[:, 1:] * mask_row + NEG_LARGE * (1 - mask_row), axis=-1))
        return (m_row, x_row, y_row, best), None

    init = (zero_state, zero_state, zero_state, zero_state[:, 0])
    (_, _, _, best), _ = jax.lax.scan(
        row_step, init, (jnp.swapaxes(scores, 0, 1), jnp.swapaxes(maskf, 0, 1))
    )
    return jnp.maximum(best, 0.0)


@partial(jax.jit, static_argnames=("with_grads", "flank"))
def bpla_kernel_batch(
    w_pair: jax.Array,
    w_unpair: jax.Array,
    mask: jax.Array,
    params: jax.Array,
    *,
    with_grads: bool = False,
    flank: bool = True,
):
    """BPLA kernel values (and optionally gradients) for a batch of pairs.

    params = (alpha, beta, gap, ext) as in the optimizer parameterization
    (/root/reference/bpla_kernel/bpla_optimizer.cpp:419-426).  When
    ``with_grads`` is True also returns dK/dparams with shape (B, 4), the
    AD equivalent of BPLA_ForwardBackword (bpla_kernel.cpp:326-401).

    Per-pair gradients cost ONE extra backward pass for the whole batch:
    params are tiled to (B, 4) so each pair's value depends only on its own
    row, making grad(sum of values) the per-pair Jacobian.
    """
    bsz = w_pair.shape[0]
    la = local_alignment_exp_flank if flank else local_alignment_exp

    def values_fn(p_tiled):  # p_tiled: (B, 4)
        scores = p_tiled[:, 0][:, None, None] * w_pair + w_unpair
        return la(scores, mask, p_tiled[:, 1], p_tiled[:, 2], p_tiled[:, 3])

    p_tiled = jnp.broadcast_to(jnp.asarray(params, w_pair.dtype), (bsz, 4))
    if not with_grads:
        return values_fn(p_tiled)
    (_, vals), grads = jax.value_and_grad(
        lambda p: (lambda v: (v.sum(), v))(values_fn(p)), has_aux=True
    )(p_tiled)
    return vals, grads


def bpla_profiles(bpp: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p_left, p_right, p_unpair) from a base-pair probability matrix.

    bpp is upper-triangular with bpp[i, j] = P(i pairs j), i < j, 0-based.
    p_left[i] = sqrt(sum_{j>i} bpp[i,j]); p_right[i] = sqrt(sum_{j<i} bpp[j,i]);
    p_unpair[i] = sqrt(max(0, 1 - p_left^2 - p_right^2))
    (fill_weight, /root/reference/bpla_kernel/data.cpp:19-45).
    """
    left = np.triu(bpp, 1).sum(axis=1)
    right = np.triu(bpp, 1).sum(axis=0)
    unpair = np.clip(1.0 - left - right, 0.0, None)
    return (
        np.sqrt(left).astype(np.float32),
        np.sqrt(right).astype(np.float32),
        np.sqrt(unpair).astype(np.float32),
    )


# Default tuned score table of the bpla_kernel CLI
# (/root/reference/bpla_kernel/main.cpp:20-26).
DEFAULT_BPLA_SCORE_TABLE = np.array(
    [
        [5.846613, -1.860000, -1.460000, -1.390000],
        [-1.860000, 4.786613, -2.480000, -1.050000],
        [-1.460000, -2.480000, 4.656613, -1.740000],
        [-1.390000, -1.050000, -1.740000, 5.276613],
    ],
    dtype=np.float32,
)


def la_impl(platform: str, max_ly: int) -> str:
    """Which implementation evaluates the sum-over-alignments kernel.

    The one platform decision of the package: on a GPU the Triton kernel
    (ops/la_triton.py), which builds emissions from the score factors and
    keeps the DP in registers; elsewhere the plain scans above.  One shape
    rule sends a GPU call to the scan: a y length past ``MAX_LY`` (512),
    whose state rows the kernel cannot hold.
    """
    from ..ops.la_triton import MAX_LY

    if platform == "gpu" and max_ly <= MAX_LY:
        return "triton"
    return "scan"


class BPLAKernel:
    """Configured BPLA kernel mirroring the reference CLI surface.

    Flags: noBP (plain LA kernel), SW (max variant); defaults gap=-8.0,
    ext=-0.75, alpha=4.5, beta=0.11 (bpla_kernel/main.cpp:68-75).
    """

    def __init__(
        self,
        score_table: np.ndarray | None = None,
        *,
        no_bp: bool = False,
        sw: bool = False,
        gap: float = -8.0,
        ext: float = -0.75,
        alpha: float = 4.5,
        beta: float = 0.11,
    ) -> None:
        self.score_table = jnp.asarray(
            DEFAULT_BPLA_SCORE_TABLE if score_table is None else score_table
        )
        self.no_bp = no_bp
        self.sw = sw
        self.gap = gap
        self.ext = ext
        self.alpha = alpha
        self.beta = beta

    def score_parts(self, x, y) -> tuple[jax.Array, jax.Array]:
        """(w_pair, w_unpair) so scores = alpha*w_pair + w_unpair."""
        if self.no_bp:
            zero = jnp.zeros((x["profile"].shape[0], x["profile"].shape[1],
                              y["profile"].shape[1]), jnp.float32)
            return zero, la_score_matrix(x["profile"], y["profile"], self.score_table)
        return bpla_score_parts(
            x["profile"], x["p_left"], x["p_right"], x["p_unpair"],
            y["profile"], y["p_left"], y["p_right"], y["p_unpair"],
            self.score_table,
        )

    def scores(self, x, y) -> jax.Array:
        """Score tensor for batches of BPLA data (dicts of padded arrays)."""
        w_pair, w_unpair = self.score_parts(x, y)
        return self.alpha * w_pair + w_unpair

    def factors(self, d, side: str) -> jax.Array:
        """(B, L, 2+N_RNA) low-rank score factors for one side."""
        prof = d["profile"]
        if self.no_bp:
            zero = jnp.zeros_like(prof[..., 0])
            return bpla_factors(prof, zero, zero, jnp.ones_like(zero),
                                self.score_table, side=side)
        return bpla_factors(prof, d["p_left"], d["p_right"], d["p_unpair"],
                            self.score_table, side=side)

    def __call__(self, x, y, *, interpret: bool = False) -> jax.Array:
        if self.sw:
            s = self.scores(x, y)
            mask = pair_mask(x["length"], s.shape[1], y["length"], s.shape[2])
            return local_alignment_max(s, mask, self.gap, self.ext)
        return self._local_alignment(x, y, log=False, interpret=interpret)

    def log_value(self, x, y, *, interpret: bool = False) -> jax.Array:
        """log K(x, y) — overflow-safe path for long sequences."""
        if self.sw:
            s = self.scores(x, y)
            mask = pair_mask(x["length"], s.shape[1], y["length"], s.shape[2])
            return jnp.log(jnp.maximum(local_alignment_max(s, mask, self.gap, self.ext), 1e-300))
        return self._local_alignment(x, y, log=True, interpret=interpret)

    def _local_alignment(self, x, y, *, log: bool, interpret: bool):
        """The sum-over-alignments value through the implementation that
        :func:`la_impl` picks; ``interpret`` forces the Triton kernel under
        the Pallas interpreter (tests on a machine without a GPU)."""
        impl = la_impl(jax.default_backend(), y["profile"].shape[1])
        if interpret or impl == "triton":
            from ..ops.la_triton import la_factored_triton

            return la_factored_triton(
                self.factors(x, "x"), self.factors(y, "y"),
                x["length"], y["length"], self.alpha, self.beta, self.gap,
                self.ext, log=log, interpret=interpret)
        s = self.scores(x, y)
        mask = pair_mask(x["length"], s.shape[1], y["length"], s.shape[2])
        la = local_alignment_log if log else local_alignment_exp
        return la(s, mask, self.beta, self.gap, self.ext)
