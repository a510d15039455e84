"""Where the program runs: compile-cache location, the GPU gate of
chip_smoke.py, and the Triton kernel on a GPU (skipped elsewhere)."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **extra)
    return env


@pytest.mark.parametrize("env_dir", [None, "custom"], ids=["unset", "set"])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set and the package sets no
    other path; unset, the cache sits at the checkout's .jax_cache/."""
    extra = {}
    if env_dir is not None:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax, stem_kernel_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=_child_env(**extra),
                         capture_output=True, text=True, timeout=120,
                         check=True, cwd=tmp_path)
    want = (str(tmp_path / env_dir) if env_dir is not None
            else os.path.join(ROOT, ".jax_cache"))
    assert out.stdout.strip().splitlines()[-1] == want


def test_chip_smoke_refuses_cpu(tmp_path):
    """Without a GPU the smoke script exits non-zero, says why, and prints
    no result line."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=_child_env(), capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_triton_kernel_matches_scan_on_gpu(gpu):
    """The compiled Triton kernel (no interpreter) against the scans."""
    import jax
    import jax.numpy as jnp

    from stem_kernel_tpu.models.bpla import (
        local_alignment_exp, local_alignment_log, pair_mask,
    )
    from stem_kernel_tpu.ops.la_triton import la_factored_triton

    r = np.random.default_rng(0)
    fx = jnp.asarray(r.normal(size=(40, 50, 6)).astype(np.float32) * 0.4)
    fy = jnp.asarray(r.normal(size=(40, 70, 6)).astype(np.float32) * 0.4)
    lx = jnp.asarray(r.integers(0, 51, 40).astype(np.int32))
    ly = jnp.asarray(r.integers(0, 71, 40).astype(np.int32))
    with jax.default_matmul_precision("highest"):
        s = 4.5 * jnp.einsum("bik,bjk->bij", fx[..., :2], fy[..., :2]) \
            + jnp.einsum("bik,bjk->bij", fx[..., 2:], fy[..., 2:])
    mask = pair_mask(lx, 50, ly, 70)
    for log, scan in [(False, local_alignment_exp), (True, local_alignment_log)]:
        got = la_factored_triton(fx, fy, lx, ly, 4.5, 0.11, -8.0, -0.75, log=log)
        want = scan(s, mask, 0.11, -8.0, -0.75)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4 if log else 0)
