"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device shardings are validated on host CPU devices
(xla_force_host_platform_device_count), per the test strategy in SURVEY.md §4.
The platform comes from ``JAX_PLATFORMS`` and defaults to ``cpu``; the
tests marked ``gpu`` run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_x64", True)  # f64 validation paths in fold tests

# The compile cache follows the package rule: JAX_COMPILATION_CACHE_DIR when
# set, else the fixed .jax_cache/ directory of the checkout.
import stem_kernel_tpu  # noqa: E402,F401

# Build the native C++ library once per test session so test_native.py (and
# the SMO/DAG fast paths throughout the suite) run against the real thing
# instead of skipping.  Mirrors the reference's assumption that its C++ core
# is always compiled (/root/reference/configure.ac builds everything).
import shutil as _shutil


def _ensure_native_lib() -> None:
    if _shutil.which("g++") is None:
        return
    try:
        # mtime-aware: a no-op when the .so is newer than every source, and
        # a rebuild when sources changed (a stale .so would silently drop
        # newer entry points to the Python fallback)
        from stem_kernel_tpu.native.build import build as _build

        _build(verbose=False)
    except Exception as exc:  # pragma: no cover - toolchain-dependent
        import warnings

        warnings.warn(f"native lib build failed, tests fall back to Python: {exc}")


_ensure_native_lib()


import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {devs[0].platform!r})")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    With ~190 tests compiling hundreds of large CPU programs in one
    process, XLA segfaulted deterministically partway through the suite
    (in backend_compile / cache-write, same index both runs); dropping
    dead executables at module boundaries keeps the process healthy at
    the cost of some cross-module recompiles.
    """
    yield
    jax.clear_caches()
