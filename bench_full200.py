"""Full stem kernel on 200 mixed ncRNA-like seqs.

Runs the real stem_kernel CLI with the banded windowed-memory engine
(-b 16) end to end on one GPU, and names the device; exits without a GPU.

Usage: python bench_full200.py [n_seqs] [band]
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import numpy as np


def make_mixed(n: int, seed: int = 0) -> list[str]:
    """Mixed-length structured ncRNA-like set (~80-300 nt)."""
    rng = np.random.default_rng(seed)
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    out = []
    for i in range(n):
        ln = int(rng.integers(80, 301))
        stem_len = ln // 3
        stem = "".join(rng.choice(list("acgu"), size=stem_len))
        rc = "".join(comp[c] for c in reversed(stem))
        mid = "".join(rng.choice(list("acgu"), size=ln - 2 * stem_len))
        out.append(stem + mid + rc)
    return out


def main() -> None:
    from stem_kernel_tpu.utils.device import require_gpu

    device = require_gpu()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    band = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    seqs = make_mixed(n)
    with tempfile.TemporaryDirectory() as td:
        pos, neg = f"{td}/pos.fa", f"{td}/neg.fa"
        half = n // 2
        with open(pos, "w") as f:
            for i, s in enumerate(seqs[:half]):
                f.write(f">p{i}\n{s}\n")
        with open(neg, "w") as f:
            for i, s in enumerate(seqs[half:]):
                f.write(f">n{i}\n{s}\n")
        from stem_kernel_tpu.cli.stem_kernel import main as cli_main

        t0 = time.time()
        rc = cli_main(["-n", "--devices", "1", "-b", str(band), f"{td}/km.dat",
                       "+1", pos, "-1", neg])
        wall = time.time() - t0
        assert rc == 0
    print(json.dumps({
        "metric": "full_stem_200_wall_s",
        "value": round(wall, 1),
        "unit": f"s ({n} mixed 80-300nt seqs, banded full stem kernel "
                f"band={band}, {n*(n+1)//2} pairs, CLI end-to-end, 1 device)",
        "device": device,
    }))


if __name__ == "__main__":
    main()
