"""Bound-constrained limited-memory quasi-Newton with reverse communication.

Replacement for the reference's f2c-translated L-BFGS-B 2.4
(/root/reference/optimizer/lbfgsb.c) and its wrapper
(/root/reference/optimizer/lbfgsb.h:19-100): the caller evaluates (f, g) at
the current x and calls :meth:`LBFGSB.update`, which either moves x to the
next trial point (return 1) or signals convergence (return 0).

Algorithm: projected L-BFGS — two-loop-recursion search directions restricted
to the free variables of the current projected-gradient active set, with an
Armijo backtracking line search along the bound-projected path.  This is the
standard gradient-projection variant of L-BFGS-B (same minimizers, simpler
subspace step than the Byrd-Lu-Nocedal-Zhu Cauchy-point machinery); it is
validated against scipy's wrapped Fortran L-BFGS-B in the test suite.
"""

from __future__ import annotations

import numpy as np

UNBOUND = 0
LOWER_BOUND = 1
BOTH_BOUNDS = 2
UPPER_BOUND = 3


class LBFGSB:
    def __init__(self, factr: float = 1e7, pgtol: float = 1e-5, max_iter: int = 200):
        self.factr = factr
        self.pgtol = pgtol
        self.max_iter = max_iter
        self._eps = np.finfo(float).eps

    def initialize(self, n: int, m: int, lower, upper, bound_types) -> None:
        self.n = n
        self.m = m
        lb = np.full(n, -np.inf)
        ub = np.full(n, np.inf)
        for i in range(n):
            t = bound_types[i]
            if t in (LOWER_BOUND, BOTH_BOUNDS):
                lb[i] = lower[i]
            if t in (UPPER_BOUND, BOTH_BOUNDS):
                ub[i] = upper[i]
        self.lb, self.ub = lb, ub
        self._S: list[np.ndarray] = []
        self._Y: list[np.ndarray] = []
        self._state = "start"
        self._it = 0
        self._f_prev = None
        self._x_base = None
        self._g_base = None
        self._d = None
        self._step = 1.0

    def _project(self, x: np.ndarray) -> np.ndarray:
        return np.clip(x, self.lb, self.ub)

    def _proj_grad(self, x, g):
        """Projected gradient: zero where pushing into an active bound."""
        pg = g.copy()
        at_lb = (x <= self.lb + 1e-12) & (g > 0)
        at_ub = (x >= self.ub - 1e-12) & (g < 0)
        pg[at_lb] = 0.0
        pg[at_ub] = 0.0
        return pg, at_lb | at_ub

    def _direction(self, x, g):
        pg, active = self._proj_grad(x, g)
        q = pg.copy()
        alphas = []
        for s, y in zip(reversed(self._S), reversed(self._Y)):
            rho = 1.0 / max(float(y @ s), 1e-300)
            a = rho * float(s @ q)
            alphas.append(a)
            q = q - a * y
        if self._S:
            s, y = self._S[-1], self._Y[-1]
            gamma = float(s @ y) / max(float(y @ y), 1e-300)
            q = gamma * q
        for (s, y), a in zip(zip(self._S, self._Y), reversed(alphas)):
            rho = 1.0 / max(float(y @ s), 1e-300)
            b = rho * float(y @ q)
            q = q + (a - b) * s
        d = -q
        d[active] = 0.0
        if float(d @ g) > -1e-16:  # not a descent direction: steepest descent
            d = -pg
        return d

    def update(self, x: np.ndarray, f: float, g: np.ndarray) -> int:
        """Advance the optimization; mutates x in place.  Returns 1 to request
        another (f, g) evaluation at the new x, 0 on convergence.

        Looped (not recursive): a step acceptance that immediately starts
        the next iteration re-enters the state machine in place, so a
        pathological zero-progress line search cannot grow the Python
        stack."""
        while True:
            rc = self._update_once(x, f, g)
            if rc is not None:
                return rc

    def _update_once(self, x: np.ndarray, f: float, g: np.ndarray) -> int | None:
        x_arr = np.asarray(x, dtype=float)
        g_arr = np.asarray(g, dtype=float)

        if self._state == "start":
            pg, _ = self._proj_grad(x_arr, g_arr)
            if np.max(np.abs(pg)) < self.pgtol or self._it >= self.max_iter:
                return 0
            self._x_base = x_arr.copy()
            self._g_base = g_arr.copy()
            self._f_base = f
            self._d = self._direction(x_arr, g_arr)
            if np.max(np.abs(self._d)) == 0:
                return 0
            self._step = 1.0 if self._S else min(1.0, 1.0 / max(np.max(np.abs(self._d)), 1e-300))
            trial = self._project(self._x_base + self._step * self._d)
            x[:] = trial
            self._state = "linesearch"
            self._ls_count = 0
            return 1

        # line search state: f, g evaluated at the trial point
        sufficient = f <= self._f_base + 1e-4 * float(
            self._g_base @ (x_arr - self._x_base)
        )
        if not sufficient and self._ls_count < 20:
            self._step *= 0.5
            self._ls_count += 1
            x[:] = self._project(self._x_base + self._step * self._d)
            if np.max(np.abs(x_arr - self._x_base)) > 0:
                return 1
        # accept the step (or give up shrinking): update memory
        s = x_arr - self._x_base
        y = g_arr - self._g_base
        if float(s @ y) > 1e-10 * float(np.linalg.norm(s) * np.linalg.norm(y)):
            self._S.append(s)
            self._Y.append(y)
            if len(self._S) > self.m:
                self._S.pop(0)
                self._Y.pop(0)
        # convergence tests (factr on relative f decrease, pgtol on gradient)
        self._it += 1
        rel = abs(self._f_base - f) / max(abs(f), abs(self._f_base), 1.0)
        pg, _ = self._proj_grad(x_arr, g_arr)
        self._state = "start"
        if rel < self.factr * self._eps or np.max(np.abs(pg)) < self.pgtol:
            return 0
        if self._it >= self.max_iter:
            return 0
        # start the next iteration from here (update() loops)
        return None
