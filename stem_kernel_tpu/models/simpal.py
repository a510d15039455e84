"""Simple palindrome (simpal) kernel.

Reimplements /root/reference/simpal/simpal.cpp: the feature map of an RNA
sequence is a weighted multiset of (seed k-mer, loop distance) palindromic
stem candidates — every co-occurrence of a k-mer in the sequence and in its
reverse complement with loop distance d in [min_loop, max_dist], weighted by
the product of base-pair probabilities over the seed stem
(Pals::find_pals, simpal.cpp:122-214).  The kernel counts pairs of candidates
with at most ``tolerance`` seed mismatches, damped by exp(-|d_a - d_b|)
(KernelFunc, simpal.cpp:225-282).

Formulation: the feature map is a dense (4^seed, max_dist+1)
array F, and the kernel factorizes over the two axes:

    K(a, b) = vec(F_a)^T (H ⊗ D) vec(F_b),   H[k1,k2] = [hamming <= tol],
                                             D[d1,d2] = exp(-|d1-d2|)

so each example is transformed ONCE (T = H @ F @ D) and the entire Gram
matrix is a single matmul  G = vec(T) @ vec(F)^T.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..io.alphabet import N_RNA, encode

_COMP = {0: 3, 1: 2, 2: 1, 3: 0}  # A-U, C-G


def _hamming_matrix(seed: int, tolerance: int) -> np.ndarray:
    """(4^s, 4^s) binary matrix: 1 where k-mer hamming distance <= tolerance."""
    n = N_RNA**seed
    digits = np.zeros((n, seed), dtype=np.int64)
    v = np.arange(n)
    for p in range(seed):
        digits[:, seed - 1 - p] = (v // (N_RNA**p)) % N_RNA
    ham = (digits[:, None, :] != digits[None, :, :]).sum(-1)
    if tolerance < 0:
        return np.ones((n, n), dtype=np.float32)
    return (ham <= tolerance).astype(np.float32)


def _dist_matrix(max_dist: int) -> np.ndarray:
    d = np.arange(max_dist + 1)
    return np.exp(-np.abs(d[:, None] - d[None, :])).astype(np.float32)


def pal_features(
    seq: str,
    bpp: np.ndarray,
    *,
    seed_length: int = 3,
    min_loop: int = 3,
    max_dist: int = 300,
) -> np.ndarray:
    """(4^seed, max_dist+1) weighted palindrome-candidate counts.

    Mirrors Pals::make_pal_map/find_pals: forward k-mer at 1-based p and the
    same k-mer in the reverse complement at 1-based q give loop distance
    d = L - (p + q + 2*seed - 2); the weight is the product of BPP values of
    the seed stem pairs (m, n) = (p + i, L - q - i + 1).
    """
    L = len(seq)
    codes = encode(seq)
    F = np.zeros((N_RNA**seed_length, max_dist + 1), dtype=np.float32)
    if L <= seed_length:
        return F
    rev = np.array([_COMP[int(c)] if c < 4 else c for c in codes[::-1]], dtype=np.int64)

    def kmer_id(arr, i):
        v = 0
        for t in range(seed_length):
            c = int(arr[i + t])
            if c >= N_RNA:
                return -1
            v = v * N_RNA + c
        return v

    fwd: dict[int, list[int]] = {}
    for i in range(L - seed_length):
        k = kmer_id(codes, i)
        if k >= 0:
            fwd.setdefault(k, []).append(i + 1)  # 1-based
    for i in range(L - seed_length):
        k = kmer_id(rev, i)
        if k < 0 or k not in fwd:
            continue
        q = i + 1
        for p in fwd[k]:
            d = L - (p + q + 2 * seed_length - 2)
            if d < min_loop or d > max_dist:
                continue
            w = 1.0
            for t in range(seed_length):
                m = p + t
                nn = L - q - t + 1
                lo, hi = min(m, nn) - 1, max(m, nn) - 1
                w *= float(bpp[lo, hi]) if lo != hi else 0.0
            F[k, d] += w
    return F


def simpal_gram(
    feats: np.ndarray, *, seed_length: int = 3, tolerance: int = 1, max_dist: int = 300
) -> np.ndarray:
    """Full Gram matrix from stacked (N, 4^s, D) features — two matmuls."""
    H = jnp.asarray(_hamming_matrix(seed_length, tolerance))
    D = jnp.asarray(_dist_matrix(max_dist))
    F = jnp.asarray(feats)
    T = jnp.einsum("kl,nld,de->nke", H, F, D,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    G = jnp.einsum("nkd,mkd->nm", T, F,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return np.asarray(G)


def simpal_kernel_fn(seed_length: int = 3, tolerance: int = 1, max_dist: int = 300):
    """Batched pair kernel_fn over feature dicts (for the Gram engine)."""
    H = jnp.asarray(_hamming_matrix(seed_length, tolerance))
    D = jnp.asarray(_dist_matrix(max_dist))

    def kernel_fn(x, y):
        T = jnp.einsum("kl,bld,de->bke", H, x["pal"], D,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.einsum("bkd,bkd->b", T, y["pal"],
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)

    return kernel_fn
