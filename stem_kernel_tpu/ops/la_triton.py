"""The BPLA/LA sum-over-alignments DP as one Pallas kernel through Triton.

This is the fused GPU version of
:func:`stem_kernel_tpu.models.bpla.local_alignment_exp` and
:func:`~stem_kernel_tpu.models.bpla.local_alignment_log` — the hottest loop
of the reference (/root/reference/bpla_kernel/bpla_kernel.cpp:64-115 inside
the pair loop of /root/reference/common/kernel_matrix.cpp:44-56).

**Closure form.**  Eliminating X and Y from the 5-state recursion

    M[i,j] = e[i,j] * (1 + M[i-1,j-1] + X[i-1,j-1] + Y[i-1,j-1])
    X[i,j] = bg * M[i-1,j] + be * X[i-1,j]
    Y[i,j] = bg * (M[i,j-1] + X[i,j-1]) + be * Y[i,j-1]

leaves an M-only recursion with a separable dependency weight

    M[i,j] = e[i,j] * (1 + sum_{i'<i, j'<j} u(i-i') u(j-j') M[i',j'])
    u(1) = 1,  u(d) = bg * be^(d-2)  for d >= 2

(u(1) is the diagonal step, u(d>=2) opens one gap and extends it).  With the
within-row closure A[i,:] = M[i,:] @ Tu, Tu[k,j] = u(j-k) (zero on and below
the diagonal), and the across-row carry G[i] = be*G[i-1] + A[i-1], each row
costs

    m = e * (1 + a + bg*g);   a' = m @ Tu;   g' = be*g + a

and the kernel value telescopes to K = 1 + sum_{i,j} M[i,j].

**Factored emissions.**  The BPLA score is low rank,
s[i,j] = alpha*(fx[i,0]fy[j,0] + fx[i,1]fy[j,1]) + sum_{k>=2} fx[i,k]fy[j,k]
(models/bpla.py:bpla_factors), so each emission row is built in registers
from K factor rows and the (B, Lx, Ly) score tensor never reaches device
memory.

**Layout on the GPU.**  One program owns ``BB`` pairs and loops over their
rows; nothing is carried between programs.  A row is held as ``C``-wide
column chunks.  Within a chunk the closure is one (BB, C) @ (C, C) product
with the chunk's Toeplitz block of Tu; across chunks it is carried by three
(BB,) vectors, because every off-diagonal block of Tu is the geometric
tail bg * be^(d-2) apart from one element (see :func:`_closure`).  The
product runs in IEEE float32: exp-space values reach ~1e38, where TF32's
10-bit mantissa would cost three digits.

The log-space mode keeps log A and log G and evaluates the closure on
exp(m - rowmax(m)), so it never overflows; terms more than ~87 log units
below their row's maximum underflow to zero there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BB = 16  # pairs per program: the smallest M of a Triton dot
C = 32  # column chunk width
# Widest padded y row the kernel takes.  A program keeps the a/g state rows
# and the row of m in registers, about 4 * BB * Ly_pad float32 values; 512
# columns is what the register file of one 8-warp program is sized for.
# Longer rows go to the scan (models/bpla.py:la_impl).
MAX_LY = 512
NEG = -1e30
_HIGHEST = jax.lax.Precision.HIGHEST


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _lae(x, y):
    """logaddexp from primitives the Triton lowering has."""
    mx = jnp.maximum(x, y)
    return mx + jnp.log1p(jnp.exp(-jnp.abs(x - y)))


def _closure(ms, tcc, w1, w2, cw, col, bg, be_c, be_c1):
    """a[:, j] = sum_{k<j} u(j-k) m[:, k] for a row held as C-wide chunks.

    Inside chunk c the sum is ``m_c @ tcc``.  From the chunks before it,
    with P[j] = sum_{k<=j} be^(j-k) m[k] (geometric prefix), column
    j' of chunk c receives

        j' = 0:  m[cC-1] + bg * P[cC-2]
        j' > 0:  bg * be^(j'-1) * P[cC-1]

    so the carry is three (BB,) vectors: ``last`` = m[cC-1], ``ppen`` =
    P[cC-2] and ``pend`` = P[cC-1].  ``w1[k] = be^(C-1-k)``, ``w2[k] =
    be^(C-2-k)`` (0 at k = C-1) and ``cw[j] = be^(j-1)`` (0 at j = 0).
    """
    out = []
    for c, m in enumerate(ms):
        t = jnp.dot(m, tcc, precision=_HIGHEST,
                    preferred_element_type=jnp.float32)
        if c:
            t = t + jnp.where(col == 0, (bg * ppen + last)[:, None],
                              bg * cw * pend[:, None])
            ppen = be_c1 * pend + jnp.sum(m * w2, axis=1)
            pend = be_c * pend + jnp.sum(m * w1, axis=1)
        else:
            ppen = jnp.sum(m * w2, axis=1)
            pend = jnp.sum(m * w1, axis=1)
        last = jnp.sum(jnp.where(col == C - 1, m, 0.0), axis=1)
        out.append(t)
    return out


def _la_kernel(par_ref, fx_ref, fy_ref, lx_ref, ly_ref, tcc_ref, w_ref,
               out_ref, *, rank: int, n_chunks: int, log: bool):
    bg, be, lbg, lbe = par_ref[0], par_ref[1], par_ref[2], par_ref[3]
    be_c, be_c1 = par_ref[4], par_ref[5]
    tcc = tcc_ref[...]
    w1, w2, cw = w_ref[0][None, :], w_ref[1][None, :], w_ref[2][None, :]
    col = jnp.arange(C, dtype=jnp.int32)[None, :]
    lx = lx_ref[...]
    ly = ly_ref[...][:, None]

    def emission(i, c, xs):
        s = xs[0][:, None] * fy_ref[0, :, pl.ds(c * C, C)]
        for k in range(1, rank):
            s = s + xs[k][:, None] * fy_ref[k, :, pl.ds(c * C, C)]
        valid = (i < lx)[:, None] & (col + c * C < ly)
        return s, valid

    def row(i, carry):
        a, g, acc = carry
        xs = [fx_ref[k, i] for k in range(rank)]
        ms = []
        for c in range(n_chunks):
            s, valid = emission(i, c, xs)
            if log:
                ms.append(jnp.where(valid, s, NEG)
                          + _lae(0.0, _lae(a[c], lbg + g[c])))
            else:
                ms.append(jnp.where(valid, jnp.exp(s), 0.0)
                          * (1.0 + a[c] + bg * g[c]))
        if log:
            r = jnp.max(ms[0], axis=1)
            for m in ms[1:]:
                r = jnp.maximum(r, jnp.max(m, axis=1))
            ems = [jnp.exp(m - r[:, None]) for m in ms]
            av = _closure(ems, tcc, w1, w2, cw, col, bg, be_c, be_c1)
            g = tuple(_lae(lbe + g[c], a[c]) for c in range(n_chunks))
            a = tuple(jnp.where(v > 0, r[:, None] + jnp.log(v), NEG)
                      for v in av)
            tot = jnp.sum(ems[0], axis=1)
            for em in ems[1:]:
                tot = tot + jnp.sum(em, axis=1)
            acc = _lae(acc, r + jnp.log(tot))
        else:
            g = tuple(be * g[c] + a[c] for c in range(n_chunks))
            a = tuple(_closure(ms, tcc, w1, w2, cw, col, bg, be_c, be_c1))
            for m in ms:
                acc = acc + jnp.sum(m, axis=1)
        return a, g, acc

    init = NEG if log else 0.0
    state = tuple(jnp.full((BB, C), init, jnp.float32)
                  for _ in range(n_chunks))
    acc0 = jnp.full((BB,), init, jnp.float32)
    _, _, acc = jax.lax.fori_loop(0, jnp.max(lx), row, (state, state, acc0))
    out_ref[...] = _lae(0.0, acc) if log else 1.0 + acc


@functools.partial(jax.jit, static_argnames=("log", "interpret"))
def la_factored_triton(fx, fy, lx, ly, alpha, beta, gap, ext, *,
                       log: bool, interpret: bool = False) -> jax.Array:
    """LA kernel values (B,) on factored scores; log K when ``log``.

    fx: (B, Lx, K), fy: (B, Ly, K) with K >= 2 and s[i,j] =
    alpha*(fx[i,0]fy[j,0] + fx[i,1]fy[j,1]) + sum_{k>=2} fx[i,k]fy[j,k];
    lx, ly: (B,) true lengths (0 allowed).  Equal to
    ``local_alignment_exp`` / ``local_alignment_log`` on the materialized
    scores with ``pair_mask(lx, Lx, ly, Ly)``.  Masking is exact (cells
    outside a pair are set to 0 / -inf, not offset).  ``interpret`` runs
    the Pallas interpreter, for tests without a GPU.
    """
    bsz, max_lx, rank = fx.shape
    max_ly = fy.shape[1]
    if rank < 2:
        raise ValueError(f"need at least the 2 base-pair factors, got K={rank}")
    dt = jnp.float32
    beta = jnp.asarray(beta, dt)
    lbg = beta * jnp.asarray(gap, dt)
    lbe = beta * jnp.asarray(ext, dt)
    bg, be = jnp.exp(lbg), jnp.exp(lbe)

    b_pad = _round_up(max(bsz, 1), BB)
    lx_pad = max(max_lx, 1)
    ly_pad = _round_up(max(max_ly, 1), C)
    n_chunks = ly_pad // C

    scale = jnp.concatenate([jnp.full((2,), jnp.asarray(alpha, dt) * beta),
                             jnp.full((rank - 2,), beta)])
    fx_t = jnp.pad(fx.astype(dt) * scale,
                   ((0, b_pad - bsz), (0, lx_pad - max_lx), (0, 0)))
    fx_t = fx_t.transpose(2, 1, 0)  # (K, Lx, B): a row of BB pairs is contiguous
    fy_t = jnp.pad(fy.astype(dt), ((0, b_pad - bsz), (0, ly_pad - max_ly), (0, 0)))
    fy_t = fy_t.transpose(2, 0, 1)  # (K, B, Ly)
    lx_p = jnp.pad(jnp.asarray(lx, jnp.int32), (0, b_pad - bsz))
    ly_p = jnp.pad(jnp.asarray(ly, jnp.int32), (0, b_pad - bsz))

    k = jnp.arange(C)
    d = (k[None, :] - k[:, None]).astype(dt)
    tcc = jnp.where(d == 1, 1.0,
                    jnp.where(d >= 2, bg * jnp.exp(lbe * jnp.maximum(d - 2, 0)),
                              0.0))
    w1 = jnp.exp(lbe * (C - 1 - k))
    w2 = jnp.where(k < C - 1, jnp.exp(lbe * jnp.maximum(C - 2 - k, 0)), 0.0)
    cw = jnp.where(k > 0, jnp.exp(lbe * jnp.maximum(k - 1, 0)), 0.0)
    # both tables are zero-padded to power-of-two lengths for Triton
    w = jnp.stack([w1, w2, cw, jnp.zeros_like(w1)]).astype(dt)
    par = jnp.stack([bg, be, lbg, lbe, jnp.exp(lbe * C), jnp.exp(lbe * (C - 1)),
                     jnp.zeros(()), jnp.zeros(())]).astype(dt)

    kern = functools.partial(_la_kernel, rank=rank, n_chunks=n_chunks, log=log)
    out = pl.pallas_call(
        kern,
        grid=(b_pad // BB,),
        in_specs=[
            pl.BlockSpec((8,), lambda b: (0,)),
            pl.BlockSpec((rank, lx_pad, BB), lambda b: (0, 0, b)),
            pl.BlockSpec((rank, BB, ly_pad), lambda b: (0, b, 0)),
            pl.BlockSpec((BB,), lambda b: (b,)),
            pl.BlockSpec((BB,), lambda b: (b,)),
            pl.BlockSpec((C, C), lambda b: (0, 0)),
            pl.BlockSpec((4, C), lambda b: (0, 0)),
        ],
        out_specs=pl.BlockSpec((BB,), lambda b: (b,)),
        out_shape=jax.ShapeDtypeStruct((b_pad,), dt),
        compiler_params=plgpu.CompilerParams(
            num_warps=4 if ly_pad <= 128 else 8, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="la_log_factored" if log else "la_exp_factored",
    )(par, fx_t, fy_t, lx_p, ly_p, tcc.astype(dt), w)
    return out[:bsz]
