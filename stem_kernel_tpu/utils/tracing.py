"""Structured per-stage timing and device profiling.

Upgrades the reference's observability (SURVEY.md §5): boost::timer
accumulation around kernel evaluations + "elapsed time" prints
(/root/reference/common/kernel_matrix.cpp:49-52, common/framework.h:139)
become a stage-timer registry with pairs/sec throughput, and
`device_profile` wraps `jax.profiler` trace collection for device runs.
The memory probe mirrors estimate_memory_size
(/root/reference/stem_kernel_lite/main.cpp:19-75).
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Accumulates wall time and item counts per named stage."""

    totals: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += items

    def report(self, out=sys.stderr) -> None:
        for name, total in sorted(self.totals.items()):
            line = f"{name}: {total:.2f}s"
            if self.counts[name]:
                line += f" ({self.counts[name] / max(total, 1e-9):.1f} items/s)"
            print(line, file=out)


@contextlib.contextmanager
def device_profile(log_dir: str | None):
    """Collect a jax.profiler trace (TensorBoard format) around a block."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def dag_memory_probe(dags) -> dict[str, float]:
    """Per-DAG memory estimate + max live node count.

    The array-encoding analogue of Data::used_memory_size / max_node_size
    (/root/reference/stem_kernel_lite/data.cpp:362-393): bytes for the dense
    node/edge/closure tensors and the max_pa-based live-row bound.
    """
    import numpy as np

    total_bytes = 0
    max_live = 0
    for d in dags:
        n = d.n_nodes
        total_bytes += (
            d.bp_freq.nbytes + d.weight.nbytes + d.first.nbytes + d.last.nbytes
            + d.edge_to.nbytes + d.edge_gaps.nbytes + d.edge_ptr.nbytes
            + 2 * n * n * 4  # A and V closures
        )
        # live rows under max_pa recycling (max_node_size semantics)
        c = np.zeros(n, dtype=np.int64)
        for i in range(n):
            hi = d.max_pa[i] if d.max_pa[i] >= 0 else i + 1
            c[i : max(int(hi), i + 1)] += 1
        max_live = max(max_live, int(c.max()) if n else 0)
    return {
        "total_bytes": float(total_bytes),
        "mean_bytes": float(total_bytes / max(len(dags), 1)),
        "max_live_nodes": float(max_live),
    }
