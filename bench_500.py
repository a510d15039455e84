"""North-star benchmark: 500-seq ncRNA stem_kernel_lite Gram wall time.

The headline configuration — end-to-end (fold -> DAG -> bucketed Gram
-> LIBSVM output) through the real CLI on one GPU.  Prints cold (includes
XLA compiles not yet in the on-disk cache) and warm wall times, with the
device and the card's power limit; exits without a GPU.

Usage: python bench_500.py [n_seqs]
"""

from __future__ import annotations

import sys
import tempfile
import time

import numpy as np

FAMILY_SEEDS = [
    # structured cores mutated into families (hairpins/cloverleaf-like)
    "gggcuauuagcucaguggtagagcgcgugcuuagcaugcacgaggcccuggguucgauccccaggagucccacca",
    "gcggauuuagcucaguugggagagcgccagacugaagaucuggagguccugugwucgauccacagaauucgcacca",
    "gggcgacccugaugaggccgaaaggccgaaacguucccgguaucccggguucgccgccgggccc",
    "ggguggggcuucagccggaggugaaagccccgggcucauuccgaaccucggaagccaagcccc",
]


def make_dataset(n: int, seed: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    comp = {"a": "u", "c": "g", "g": "c", "u": "a"}
    out = []
    for i in range(n):
        base = FAMILY_SEEDS[i % len(FAMILY_SEEDS)].replace("t", "u").replace("w", "u")
        s = "".join(
            rng.choice(list("acgu")) if rng.random() < 0.15 else c for c in base
        )
        if rng.random() < 0.5:  # half the corpus: fresh hairpins, mixed length
            stem_len = int(rng.integers(15, 30))
            stem = "".join(rng.choice(list("acgu"), size=stem_len))
            rc = "".join(comp[c] for c in reversed(stem))
            mid = "".join(rng.choice(list("acgu"), size=int(rng.integers(4, 12))))
            s = stem + mid + rc
        out.append(s)
    return out


def main() -> None:
    from stem_kernel_tpu.utils.device import require_gpu

    device = require_gpu()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    print(f"device: {device}")
    seqs = make_dataset(n)
    print(f"{n} seqs, lengths {min(map(len, seqs))}-{max(map(len, seqs))}")
    with tempfile.TemporaryDirectory() as td:
        pos = f"{td}/pos.fa"
        neg = f"{td}/neg.fa"
        half = n // 2
        with open(pos, "w") as f:
            for i, s in enumerate(seqs[:half]):
                f.write(f">p{i}\n{s}\n")
        with open(neg, "w") as f:
            for i, s in enumerate(seqs[half:]):
                f.write(f">n{i}\n{s}\n")

        from stem_kernel_tpu.cli.stem_kernel_lite import main as cli_main

        for tag in ("cold", "warm"):
            t0 = time.time()
            rc = cli_main(["-n", "--devices", "1", f"{td}/km_{tag}.dat",
                           "+1", pos, "-1", neg])
            dt = time.time() - t0
            assert rc == 0
            print(f"{tag}: {dt:.1f}s  ({n} seqs, "
                  f"{n * (n + 1) // 2} pairs end-to-end)")


if __name__ == "__main__":
    main()
