"""SMO solver for the C-SVC dual on precomputed kernels.

Solves
    min_a  0.5 a^T Q a + p^T a
    s.t.   y^T a = 0,  0 <= a_i <= C_i
with Q = (y y^T) * K, using maximal-violating-pair working-set selection with
second-order (WSS-3) tie-breaking — the algorithm of the reference's modified
LIBSVM solver (/root/reference/libsvm/solver.cpp:82-475: Solve,
select_working_set, calculate_rho).  The convex QP's decision values are
unique, so this NumPy-vectorized implementation reproduces the reference's
decision values within solver tolerance without per-element C++ loops.

Shrinking is unnecessary here — a measured claim, on the host CPU: native
solves on dense precomputed K cost 0.01 s at N=2k, 0.2-0.5 s at N=10k and 1.2-1.4 s at
N=30k (5.9k iterations, ~200 us/iter).  The dominant cost at large N was
an accidental O(N^2) float64 conversion in the ctypes wrapper (55 s at
N=30k — 40x the solve), fixed by f32-native entry points; shrinking's
theoretical per-iteration saving applies to a ~1-second stage of a
pipeline whose Gram build at the same N takes minutes on the fastest
kernel, so the active-set bookkeeping cannot pay for itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TAU = 1e-12


@dataclass
class SolverResult:
    alpha: np.ndarray
    rho: float
    obj: float
    n_iter: int
    upper_bound_p: float
    upper_bound_n: float


def smo_solve(
    K: np.ndarray,
    y: np.ndarray,
    p: np.ndarray,
    C_p: float,
    C_n: float,
    *,
    eps: float = 1e-3,
    max_iter: int | None = None,
    alpha0: np.ndarray | None = None,
) -> SolverResult:
    """Run SMO to convergence.  K: (n, n) kernel; y: (n,) in {+1,-1}.

    ``alpha0``: optional feasible warm start (the one-class machine starts at
    sum(alpha) = nu*l; SMO preserves y^T alpha, so the start defines the
    equality constraint's value).

    Uses the native C++ solver (stem_kernel_tpu.native) when built; the
    NumPy path below is the reference fallback.
    """
    n = len(y)
    if max_iter is None:
        max_iter = max(10_000_000, 100 * n)
    if alpha0 is None:
        from ..native import smo_solve_native

        native = smo_solve_native(K, y, p, C_p, C_n, eps, max_iter)
        if native is not None:
            alpha, rho, obj, it = native
            return SolverResult(alpha=alpha, rho=rho, obj=obj, n_iter=it,
                                upper_bound_p=C_p, upper_bound_n=C_n)
    y = np.asarray(y, dtype=np.float64)
    if alpha0 is None:
        alpha = np.zeros(n)
        G = np.asarray(p, dtype=np.float64).copy()  # gradient = Qa + p
    else:
        alpha = np.asarray(alpha0, dtype=np.float64).copy()
        G = y * (K @ (y * alpha)) + np.asarray(p, dtype=np.float64)
    C = np.where(y > 0, C_p, C_n)
    Kd = np.ascontiguousarray(np.diag(K)).astype(np.float64)

    yG = y * G
    it = 0
    while it < max_iter:
        up = ((y > 0) & (alpha < C)) | ((y < 0) & (alpha > 0))
        low = ((y > 0) & (alpha > 0)) | ((y < 0) & (alpha < C))
        if not up.any() or not low.any():
            break
        neg_yG = -yG
        i = int(np.flatnonzero(up)[np.argmax(neg_yG[up])])
        G_max = neg_yG[i]
        G_min = np.min(neg_yG[low])
        if G_max - G_min < eps:
            break

        # second-order selection of j among the low set with -y_j G_j < G_max.
        # The curvature of the 2-variable subproblem is K_ii + K_jj - 2 K_ij
        # in kernel terms (the y factors in Q = yy^T*K cancel).
        Qi = y[i] * y * K[i]  # row i of Q
        b = G_max + yG  # b_j = G_max - (-y_j G_j)
        a = Kd[i] + Kd - 2.0 * K[i]
        a = np.where(a <= 0, TAU, a)
        cand = low & (b > 0)
        if not cand.any():
            break
        obj_diff = -(b * b) / a
        obj_diff = np.where(cand, obj_diff, np.inf)
        j = int(np.argmin(obj_diff))

        Qj = y[j] * y * K[j]

        # analytic 2-variable update (libsvm solver.cpp:141-268 semantics)
        quad = Kd[i] + Kd[j] - 2.0 * K[i, j]
        if quad <= 0:
            quad = TAU
        if y[i] != y[j]:
            delta = (-G[i] - G[j]) / quad
            diff = alpha[i] - alpha[j]
            ai, aj = alpha[i] + delta, alpha[j] + delta
            if diff > 0:
                if aj < 0:
                    aj, ai = 0.0, diff
            else:
                if ai < 0:
                    ai, aj = 0.0, -diff
            if diff > C[i] - C[j]:
                if ai > C[i]:
                    ai, aj = C[i], C[i] - diff
            else:
                if aj > C[j]:
                    aj, ai = C[j], C[j] + diff
        else:
            delta = (G[i] - G[j]) / quad
            s = alpha[i] + alpha[j]
            ai, aj = alpha[i] - delta, alpha[j] + delta
            if s > C[i]:
                if ai > C[i]:
                    ai, aj = C[i], s - C[i]
            else:
                if aj < 0:
                    aj, ai = 0.0, s
            if s > C[j]:
                if aj > C[j]:
                    aj, ai = C[j], s - C[j]
            else:
                if ai < 0:
                    ai, aj = 0.0, s

        d_i, d_j = ai - alpha[i], aj - alpha[j]
        alpha[i], alpha[j] = ai, aj
        G += Qi * d_i + Qj * d_j
        yG = y * G
        it += 1

    # rho (calculate_rho, solver.cpp:520-556): for free SVs y_i*G_i == rho
    free = (alpha > 0) & (alpha < C)
    yG = y * G
    if free.any():
        rho = np.mean(yG[free])
    else:
        ub = ((y > 0) & (alpha == 0)) | ((y < 0) & (alpha == C))
        lb = ((y > 0) & (alpha == C)) | ((y < 0) & (alpha == 0))
        hi = np.min(yG[ub]) if ub.any() else np.inf
        lo = np.max(yG[lb]) if lb.any() else -np.inf
        rho = (hi + lo) / 2.0
    obj = float(0.5 * np.dot(alpha, G + p))
    return SolverResult(alpha=alpha, rho=float(rho), obj=obj, n_iter=it,
                        upper_bound_p=C_p, upper_bound_n=C_n)


def smo_solve_nu(
    K: np.ndarray,
    y: np.ndarray,
    p: np.ndarray,
    C_p: float,
    C_n: float,
    alpha0: np.ndarray,
    *,
    eps: float = 1e-3,
    max_iter: int | None = None,
) -> tuple[SolverResult, float]:
    """SMO for the nu-formulation dual (libsvm Solver_NU, solver.cpp:559-718).

    The nu dual carries TWO equality constraints (y^T a = const and
    e^T a = const, both fixed by the feasible start ``alpha0``), so working
    pairs must share a class: selection runs the maximal-violating-pair /
    second-order criterion independently inside y=+1 and y=-1 and takes the
    better of the two (select_working_set, solver.cpp:580-658).

    Returns (result, r) where result.rho = (r1 - r2)/2 and r = (r1 + r2)/2
    (calculate_rho, solver.cpp:676-718); for nu-SVC 1/r is the equivalent
    C-SVC cost, for nu-SVR -r is the attained epsilon.
    """
    n = len(y)
    if max_iter is None:
        max_iter = max(10_000_000, 100 * n)
    from ..native import smo_solve_nu_native

    native = smo_solve_nu_native(K, y, p, C_p, C_n, alpha0, eps, max_iter)
    if native is not None:
        alpha_n, rho_n, r_n, obj_n, it_n = native
        return (
            SolverResult(alpha=alpha_n, rho=rho_n, obj=obj_n, n_iter=it_n,
                         upper_bound_p=C_p, upper_bound_n=C_n),
            r_n,
        )
    y = np.asarray(y, dtype=np.float64)
    C = np.where(y > 0, C_p, C_n)
    alpha = np.asarray(alpha0, dtype=np.float64).copy()
    G = y * (K @ (y * alpha)) + np.asarray(p, dtype=np.float64)
    Kd = np.ascontiguousarray(np.diag(K)).astype(np.float64)
    pos = y > 0

    it = 0
    while it < max_iter:
        upp = pos & (alpha < C)  # up candidates in class +1: -G maximal
        upn = ~pos & (alpha > 0)  # up candidates in class -1: +G maximal
        lowp = pos & (alpha > 0)
        lown = ~pos & (alpha < C)
        Gmaxp = np.max(-G[upp]) if upp.any() else -np.inf
        Gmaxn = np.max(G[upn]) if upn.any() else -np.inf
        Gmaxp2 = np.max(G[lowp]) if lowp.any() else -np.inf
        Gmaxn2 = np.max(-G[lown]) if lown.any() else -np.inf
        if max(Gmaxp + Gmaxp2, Gmaxn + Gmaxn2) < eps:
            break

        best_obj, bi, bj = np.inf, -1, -1
        if np.isfinite(Gmaxp) and lowp.any():
            ip = int(np.flatnonzero(upp)[np.argmax(-G[upp])])
            b = Gmaxp + G
            a = Kd[ip] + Kd - 2.0 * K[ip]
            a = np.where(a <= 0, TAU, a)
            od = np.where(lowp & (b > 0), -(b * b) / a, np.inf)
            j = int(np.argmin(od))
            if od[j] < best_obj:
                best_obj, bi, bj = od[j], ip, j
        if np.isfinite(Gmaxn) and lown.any():
            in_ = int(np.flatnonzero(upn)[np.argmax(G[upn])])
            b = Gmaxn - G
            a = Kd[in_] + Kd - 2.0 * K[in_]
            a = np.where(a <= 0, TAU, a)
            od = np.where(lown & (b > 0), -(b * b) / a, np.inf)
            j = int(np.argmin(od))
            if od[j] < best_obj:
                best_obj, bi, bj = od[j], in_, j
        if bi < 0:
            break
        i, j = bi, bj

        # same-class 2-variable update (y_i == y_j branch of the standard step)
        quad = Kd[i] + Kd[j] - 2.0 * K[i, j]
        if quad <= 0:
            quad = TAU
        delta = (G[i] - G[j]) / quad
        s = alpha[i] + alpha[j]
        ai, aj = alpha[i] - delta, alpha[j] + delta
        if s > C[i]:
            if ai > C[i]:
                ai, aj = C[i], s - C[i]
        else:
            if aj < 0:
                aj, ai = 0.0, s
        if s > C[j]:
            if aj > C[j]:
                aj, ai = C[j], s - C[j]
        else:
            if ai < 0:
                ai, aj = 0.0, s

        Qi = y[i] * y * K[i]
        Qj = y[j] * y * K[j]
        G += Qi * (ai - alpha[i]) + Qj * (aj - alpha[j])
        alpha[i], alpha[j] = ai, aj
        it += 1

    def _class_r(mask: np.ndarray) -> float:
        free = mask & (alpha > 0) & (alpha < C)
        if free.any():
            return float(np.mean(G[free]))
        at_c = mask & (alpha >= C)
        at_0 = mask & (alpha <= 0)
        lb = np.max(G[at_c]) if at_c.any() else -np.inf
        ub = np.min(G[at_0]) if at_0.any() else np.inf
        return float((ub + lb) / 2.0)

    r1 = _class_r(pos)
    r2 = _class_r(~pos)
    rho = (r1 - r2) / 2.0
    r = (r1 + r2) / 2.0
    obj = float(0.5 * np.dot(alpha, G + p))
    res = SolverResult(alpha=alpha, rho=rho, obj=obj, n_iter=it,
                       upper_bound_p=C_p, upper_bound_n=C_n)
    return res, r
