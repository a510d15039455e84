"""The device a measurement runs on.

Measurement scripts (bench*.py, chip_smoke.py) run on an NVIDIA GPU only:
a number taken on the CPU backend says nothing about the card, so they
stop instead of falling back.
"""

from __future__ import annotations

import subprocess
import sys


def require_gpu(count: int = 1) -> dict:
    """Describe the visible GPUs; exit with a message when JAX has none.

    Returns {"platform", "kind", "count", "gpu"}, where "gpu" is the first
    card's ``nvidia-smi --query-gpu=name,power.limit`` line (a card set
    below its maximum power runs slower under load).
    """
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"needs an NVIDIA GPU; JAX found platform {devs[0].platform!r}")
    if len(devs) < count:
        sys.exit(f"needs {count} GPUs; JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "gpu": smi.stdout.strip().splitlines()[0]}
