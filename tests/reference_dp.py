"""Brute-force NumPy oracles for the DP kernels.

Direct cell-by-cell evaluations of the published recursions (cited per
function), used to validate the batched/associative-scan implementations.
These are intentionally naive O(n*m) Python loops.
"""

from __future__ import annotations

import numpy as np


def string_kernel_ref(S: np.ndarray, gap: float) -> float:
    """Gap-weighted all-substrings kernel; S[i,j] = weighted subst score.

    Recursion of /root/reference/stem_kernel_lite/string_kernel.cpp:66-132
    with the G0[i-1][j-1] factor applied here.
    """
    n, m = S.shape
    K0 = np.ones((n + 1, m + 1))
    G0 = np.zeros((n + 1, m + 1))
    G0[0, :] = gap ** np.arange(m + 1)
    G0[:, 0] = gap ** np.arange(n + 1)
    G0[0, 0] = 1.0
    for i in range(1, n + 1):
        K1 = np.zeros(m + 1)
        G1 = np.zeros(m + 1)
        for j in range(1, m + 1):
            v = G0[i - 1, j - 1] * S[i - 1, j - 1]
            K1[j] = v + K1[j - 1]
            G1[j] = v + G1[j - 1] * gap
            K0[i, j] = K1[j] + K0[i - 1, j]
            G0[i, j] = G1[j] + G0[i - 1, j] * gap
    return float(K0[n, m])


def bpla_exp_ref(S: np.ndarray, beta: float, gap: float, ext: float) -> float:
    """Sum-over-local-alignments kernel, 5-state DP.

    Recursion of /root/reference/bpla_kernel/bpla_kernel.cpp:64-115
    (local_alignment_exp); S[i,j] is the BPLA/LA match score.
    """
    n, m = S.shape
    bg, be = np.exp(beta * gap), np.exp(beta * ext)
    M = np.zeros((n + 1, m + 1))
    X = np.zeros((n + 1, m + 1))
    Y = np.zeros((n + 1, m + 1))
    X2 = np.zeros((n + 1, m + 1))
    Y2 = np.zeros((n + 1, m + 1))
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            M[i, j] = np.exp(beta * S[i - 1, j - 1]) * (
                1 + X[i - 1, j - 1] + Y[i - 1, j - 1] + M[i - 1, j - 1]
            )
            X[i, j] = bg * M[i - 1, j] + be * X[i - 1, j]
            Y[i, j] = bg * (M[i, j - 1] + X[i, j - 1]) + be * Y[i, j - 1]
            X2[i, j] = M[i - 1, j] + X2[i - 1, j]
            Y2[i, j] = M[i, j - 1] + X2[i, j - 1] + Y2[i, j - 1]
    return float(1 + X2[n, m] + Y2[n, m] + M[n, m])


def bpla_max_ref(S: np.ndarray, gap: float, ext: float) -> float:
    """Smith-Waterman variant (local_alignment_max, bpla_kernel.cpp:117-157)."""
    n, m = S.shape
    M = np.zeros((n + 1, m + 1))
    X = np.zeros((n + 1, m + 1))
    Y = np.zeros((n + 1, m + 1))
    best = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            M[i, j] = max(0.0, M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1]) + S[i - 1, j - 1]
            best = max(best, M[i, j])
            X[i, j] = max(M[i - 1, j] + gap, X[i - 1, j] + ext)
            Y[i, j] = max(M[i, j - 1] + gap, X[i, j - 1] + gap, Y[i, j - 1] + ext)
    return float(best)


def bpla_forward_ref(S: np.ndarray, beta: float, gap: float, ext: float) -> tuple[float, np.ndarray]:
    """7-state forward DP with explicit flanking states.

    Recursion of BPLA_Forward (/root/reference/bpla_kernel/bpla_kernel.cpp:179-244).
    Returns (kernel value, T) with T[state, i, j]; states M,IX,IY,LX,LY,RX,RY.
    """
    n, m = S.shape
    M, IX, IY, LX, LY, RX, RY = range(7)
    bg, be = np.exp(beta * gap), np.exp(beta * ext)
    T = np.zeros((7, n + 1, m + 1))
    T[M, 0, 0] = 1
    T[LX, 0, 0] = 1
    T[LY, 0, 0] = 1
    for i in range(1, n + 1):
        T[LX, i, 0] += T[LX, i - 1, 0]
    for j in range(1, m + 1):
        T[LY, 0, j] += T[LY, 0, j - 1]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            bs = np.exp(beta * S[i - 1, j - 1])
            T[M, i, j] = bs * (
                T[M, i - 1, j - 1] + T[IX, i - 1, j - 1] + T[IY, i - 1, j - 1]
                + T[LX, i - 1, j - 1] + T[LY, i - 1, j - 1]
            )
            T[IX, i, j] = bg * T[M, i - 1, j] + be * T[IX, i - 1, j]
            T[IY, i, j] = bg * T[M, i, j - 1] + bg * T[IX, i, j - 1] + be * T[IY, i, j - 1]
            T[LX, i, j] = T[LX, i - 1, 0]
            T[LY, i, j] = T[LX, i, j - 1] + T[LY, i, j - 1]
            T[RX, i, j] = T[M, i - 1, j] + T[RX, i - 1, j]
            T[RY, i, j] = T[M, i, j - 1] + T[RX, i, j - 1] + T[RY, i, j - 1]
    value = 1 + T[M, n, m] + T[RX, n, m] + T[RY, n, m]
    return float(value), T
