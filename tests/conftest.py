"""Test harness configuration: virtual 8-device CPU mesh.

Multi-device behavior is tested without accelerator hardware by forcing the
host platform and splitting it into 8 virtual devices (SURVEY.md §4):
sharding, collectives, and pjit paths compile and execute exactly as they
would across real devices, just on CPU.  These env vars must be set before jax imports.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_mesh():
    from globalign_jax.parallel.mesh import make_pair_mesh

    return make_pair_mesh()


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """Drop compiled executables after every test module.

    The full suite compiles hundreds of XLA:CPU programs in one process;
    past a cumulative LLVM-JIT code budget the NEXT compile segfaults
    deterministically (observed in whichever module happens to cross the
    line — bisected: any large-enough subset passes in isolation).
    Releasing executables between modules keeps the resident jitted-code
    footprint bounded; modules re-compile what they share, which is
    seconds on CPU.
    """
    yield
    jax.clear_caches()
