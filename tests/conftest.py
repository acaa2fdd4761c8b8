"""Test env setup: force CPU backend with 8 virtual devices.

SURVEY.md §4 item 4: the real pjit/mesh code paths (sharded replay,
psum, broadcast) run in CI on a virtual 8-device CPU mesh. The platform
is pinned through jax.config.update (not only JAX_PLATFORMS), so the
tests stay on the CPU even on a machine with a GPU; no backend has been
initialized yet at conftest time. The persistent compile cache is off:
tests that call the CLIs must not write into the checkout's cache.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8").strip()
# Exact-numerics bar: no matmul downcasts in tests.
os.environ.setdefault("JAX_DEFAULT_MATMUL_PRECISION", "highest")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402

assert jax.default_backend() == "cpu", "tests must run on CPU backend"


@pytest.fixture
def key():
    return jax.random.key(0)
