"""Stem kernel over structure DAGs as batched matmuls.

Redesign of the reference's DAG convolution kernel
(/root/reference/stem_kernel_lite/stem_kernel.cpp:14-95).  The reference
iterates ragged per-node edge lists cell by cell:

    MATCH: K1/G1 += node_score(i,j) * edge_score(ex,ey) * G0[ex.to][ey.to]
    IY:    K1 += K1[ey.to];  G1 += gapscore(j) * edgescore(ey) * G1[ey.to]
    IX:    K0 = K1 + sum K0[ex.to];  G0 = G1 + gapscore(i)*edgescore(ex)*G0[ex.to]
    result = sum over root pairs of K0

Because the IX/IY recursions are *linear and nilpotent* over the acyclic
DAGs, they admit closed-form closures: with per-example dense operators

    A[i,c]  = gap^gaps * edge_w          (match-path edge coefficients)
    B[i,c]  = gap^2 * w_i * A[i,c]       (gap-path coefficients)
    V       = (I - B)^{-1}               (gap closure)
    u       = (I - T^T)^{-1} r           (root-reach path counts, T = 0/1)
    L[i,j]  = leaf_x[i] * leaf_y[j]      (base case K0 = G0 = 1)

the whole DP collapses to a fixed-point of two batched matmuls per
match-nesting level:

    G0 = Vx @ (M @ Vy^T + L)
    M  = NS * (Ax @ G0 @ Ay^T)

iterated `depth` times (the maximum nested-match depth, precomputed at DAG
build time; extra iterations are no-ops), and the kernel value is the
bilinear form  u_x^T (M + L) u_y.  Everything is (B, N, N) matmuls, which
XLA hands to cuBLAS; no gather/scatter, no ragged loops.

Node scores (score_table.cpp:14-53, 118-201) are one 16x16 contraction of
flattened base-pair frequency profiles plus rank-1 gap corrections:

    NS = Fx @ CS @ Fy^T + nbp_x ⊗ g2w_y + g2w_x ⊗ nbp_y
    CS_subst[ab, cd]  = exp(beta * RIBOSUM_P[a,b,c,d])
    CS_simple[ab, cd] = match if (a,b)==(c,d) else mismatch
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .ribosum_data import RIBOSUM_P


def subst_co_table(beta: float) -> np.ndarray:
    """exp(RIBOSUM_P * beta) flattened to (16, 16) (SubstNodeScore ctor)."""
    return np.exp(RIBOSUM_P * beta).reshape(16, 16).astype(np.float32)


def simple_co_table(match: float, mismatch: float) -> np.ndarray:
    """match/mismatch over base-pair identities (SimpleNodeScore)."""
    t = np.full((16, 16), mismatch, dtype=np.float32)
    np.fill_diagonal(t, match)
    return t


# --precision of the closure matmuls -> XLA's float32 matmul precision
PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


@partial(jax.jit, static_argnames=("iters", "len_band", "precision"))
def stem_kernel_pairs(
    x: dict, y: dict, co_table: jax.Array, *, iters: int, len_band: int = 0,
    precision: str = "highest",
) -> jax.Array:
    """Batched stem-kernel values for pairs of DAG feature dicts.

    Feature dicts (from dag.dag_matrices, stacked with leading batch axis):
    A (B,N,N), V (B,N,N), u (B,N), leaf (B,N), bp_freq (B,N,16),
    gap2w (B,N), nbp_frac (B,N), length (B,N), valid (B,N).

    ``precision`` sets the float32 matmuls of the closure fixed point
    (:data:`PRECISIONS`): "highest" is full float32, the validation mode.
    On an NVIDIA GPU, XLA runs both "high" (the CLI default) and "default"
    in TF32 (10-bit mantissa, ~3e-4 relative per product); on a 500-RNA
    corpus the cosine-normalized Gram stays within 1e-3 of "highest"
    (3.4e-4 measured on an H100).  On the CPU all three are float32.  The
    final bilinear form always runs at full float32.
    """
    hp = PRECISIONS[precision]
    full = jax.lax.Precision.HIGHEST
    ns = jnp.einsum(
        "bik,kl,bjl->bij", x["bp_freq"], co_table, y["bp_freq"],
        preferred_element_type=jnp.float32, precision=hp,
    )
    ns = ns + x["nbp_frac"][:, :, None] * y["gap2w"][:, None, :]
    ns = ns + x["gap2w"][:, :, None] * y["nbp_frac"][:, None, :]
    match_ok = (
        (1.0 - x["leaf"])[:, :, None]
        * (1.0 - y["leaf"])[:, None, :]
        * x["valid"][:, :, None]
        * y["valid"][:, None, :]
    )
    if len_band > 0:
        band = (
            jnp.abs(x["length"][:, :, None] - y["length"][:, None, :]) <= len_band
        ).astype(ns.dtype)
        match_ok = match_ok * band
    ns = ns * match_ok

    L = x["leaf"][:, :, None] * y["leaf"][:, None, :]

    VyT = jnp.swapaxes(y["V"], 1, 2)
    AyT = jnp.swapaxes(y["A"], 1, 2)

    def mm(a, b):
        return jnp.einsum("bij,bjk->bik", a, b,
                          preferred_element_type=jnp.float32, precision=hp)

    def body(_, m):
        g0 = mm(x["V"], mm(m, VyT) + L)
        return ns * mm(x["A"], mm(g0, AyT))

    m = jax.lax.fori_loop(0, iters, body, jnp.zeros_like(ns))
    value = jnp.einsum("bi,bij,bj->b", x["u"], m, y["u"],
                       preferred_element_type=jnp.float32, precision=full)
    # The leaf-leaf base (K0 = 1) propagates only along the x-side K chain in
    # the reference recursion (K1's IY accumulation never reads it), so its
    # contribution pairs u_x with the RAW root indicator r_y:
    # value += (u_x . leaf_x) * (r_y . leaf_y).  Nonzero only when a root is
    # itself a leaf (degenerate unstructured input).
    value = value + jnp.sum(x["u"] * x["leaf"], -1) * jnp.sum(y["r"] * y["leaf"], -1)
    return value


class StemKernel:
    """Configured stem kernel (SuStemKernel / SiStemKernel equivalents).

    Defaults mirror the reference CLI (stem_kernel_lite/main.cpp:115-149):
    loop_gap=0.2, beta=0.3 (RIBOSUM) or stack=1.3/covar=0.8 (simple),
    len_band=10 (0 disables).
    """

    def __init__(
        self,
        *,
        loop_gap: float = 0.2,
        beta: float | None = 0.3,
        stack: float | None = None,
        covar: float | None = None,
        len_band: int = 0,
        precision: str = "highest",
    ) -> None:
        if beta is not None:
            self.co_table = jnp.asarray(subst_co_table(beta))
        elif stack is not None and covar is not None:
            self.co_table = jnp.asarray(simple_co_table(stack, covar))
        else:
            raise ValueError("need beta (RIBOSUM) or stack/covar (simple)")
        self.loop_gap = loop_gap
        self.len_band = len_band
        self.precision = precision

    def __call__(self, x: dict, y: dict, *, iters: int) -> jax.Array:
        return stem_kernel_pairs(
            x, y, self.co_table, iters=iters, len_band=self.len_band,
            precision=self.precision,
        )
