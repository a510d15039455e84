"""Direct cell-by-cell stem-kernel recursion on StemDAGs.

A naive Python evaluation of the reference recursion
(/root/reference/stem_kernel_lite/stem_kernel.cpp:14-95) used to validate the
closure-matmul formulation.  Nodes are in topological order (children
before parents), matching the reference's DFS emission order.
"""

from __future__ import annotations

import numpy as np

from stem_kernel_tpu.models.dag import StemDAG


def node_score_match(xd: StemDAG, yd: StemDAG, i: int, j: int, co: np.ndarray, gap: float) -> float:
    fx = xd.bp_freq[i].astype(np.float64)
    fy = yd.bp_freq[j].astype(np.float64)
    v = fx @ co.astype(np.float64).reshape(16, 16) @ fy
    v += (gap**2) * yd.weight[j] * xd.nbp_frac[i]
    v += (gap**2) * xd.weight[i] * yd.nbp_frac[j]
    return float(v)


def stem_kernel_ref(xd: StemDAG, yd: StemDAG, co: np.ndarray, gap: float, len_band: int = 0) -> float:
    nx, ny = xd.n_nodes, yd.n_nodes
    K0 = np.zeros((nx, ny))
    G0 = np.zeros((nx, ny))

    def edges(d: StemDAG, k: int):
        lo, hi = d.edge_ptr[k], d.edge_ptr[k + 1]
        return [(int(d.edge_to[e]), int(d.edge_gaps[e]), float(d.edge_weight[e])) for e in range(lo, hi)]

    for i in range(nx):
        K1 = np.zeros(ny)
        G1 = np.zeros(ny)
        ex_list = edges(xd, i)
        for j in range(ny):
            ey_list = edges(yd, j)
            if not ex_list and not ey_list:
                K0[i, j] = G0[i, j] = 1.0
                continue
            K1[j] = G1[j] = 0.0
            li = xd.last[i] - xd.first[i]
            lj = yd.last[j] - yd.first[j]
            if ex_list and ey_list and (len_band == 0 or abs(int(li) - int(lj)) <= len_band):
                v_s = node_score_match(xd, yd, i, j, co, gap)
                for (tx, gx, wx) in ex_list:
                    for (ty, gy, wy) in ey_list:
                        e_s = (gap**gx) * (gap**gy) * wx * wy
                        v = G0[tx, ty] * v_s * e_s
                        K1[j] += v
                        G1[j] += v
            for (ty, gy, wy) in ey_list:
                v_s = (gap**2) * yd.weight[j]
                e_s = (gap**gy) * wy
                K1[j] += K1[ty]
                G1[j] += G1[ty] * v_s * e_s
            K0[i, j] = K1[j]
            G0[i, j] = G1[j]
            for (tx, gx, wx) in ex_list:
                v_s = (gap**2) * xd.weight[i]
                e_s = (gap**gx) * wx
                K0[i, j] += K0[tx, j]
                G0[i, j] += G0[tx, j] * v_s * e_s

    return float(sum(K0[rx, ry] for rx in xd.root for ry in yd.root))
