"""Test configuration: CPU by default, with a virtual 8-device mesh so tests are
fast and multi-device sharding paths are exercised without accelerators
(SURVEY.md §4).  JAX_PLATFORMS picks another backend: the tests that need a GPU
carry the ``gpu`` marker and run with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# This VM advertises AVX512/AMX features it cannot reliably execute (XLA logs a
# compile/execute machine-feature mismatch); full-suite runs intermittently
# SEGFAULT inside XLA:CPU compile-and-load until codegen is capped to AVX2.
if "xla_cpu_max_isa" not in flags:
    flags += " --xla_cpu_max_isa=AVX2"
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# Persistent compilation cache: suite wall time is compile-bound, so the
# package's cache (rgbd_slam/__init__.py: JAX_COMPILATION_CACHE_DIR, else
# <checkout>/.jax_cache) serves the tests too; cache keys include the backend,
# so CPU and GPU entries never collide.  Cache round-trips intermittently
# segfaulted inside XLA:CPU executable (de)serialization BEFORE codegen was
# capped to AVX2 above — with the cap the round trip is stable.

import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(items):
    """Tier markers: every non-slow test is also `smoke`, so `-m smoke` is the
    documented <=5-min pre-commit tier (fast tests + the slow tests explicitly
    opted in with @pytest.mark.smoke); `-m "not slow"` stays the pure fast
    tier and a plain `pytest tests/` runs everything."""
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.smoke)

# Build the native PNG loader up front so its tests run instead of skipping
# (VERDICT r1 weak #6): the dataset hot path must be proven in this environment.
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
try:
    subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True, timeout=120)
except Exception as exc:  # noqa: BLE001 — missing toolchain falls back to skips
    print(f"conftest: native loader build failed ({exc}); its tests will skip")


@pytest.fixture
def rng():
    return np.random.default_rng(1000)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest tests "
                    "-m gpu")
