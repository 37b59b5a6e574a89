"""Test harness config: force an 8-device virtual CPU platform.

This is JAX's standard fake multi-device harness (SURVEY §4.4): sharded
code paths (ring ppermute, all_gather, psum) execute for real across 8
host devices, and the Pallas kernel runs in interpreter mode
(``backend="pallas_interpret"``).  XLA_FLAGS must be set before JAX is
imported (for the host device count); the platform is pinned through
jax.config right after.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    One pytest process compiles several hundred XLA:CPU programs; the
    accumulated LLVM JIT state once crossed a threshold where a LATER
    (arbitrary, even trivial) compile segfaulted inside backend_compile —
    observed deterministically at ~85% of the suite, while every module
    passed in isolation.  Freeing
    executables module-by-module keeps the process under that ceiling;
    cross-module jit reuse is rare, so the recompile cost is small.
    """
    yield
    import jax

    jax.clear_caches()
