"""Test environment: JAX on CPU with 8 virtual devices and x64 enabled.

The reference runs its suite on PoCL (a CPU OpenCL implementation) so the
same tests run with or without a GPU (reference Dockerfile `cpu` stage);
here the CPU JAX backend plays that role, and 8 virtual host devices let the
multi-device sharding paths compile and execute without GPUs. x64 is
enabled so the float64/uint64 dtype matrix from the reference tests carries
over (the GPU paths users time run f32/u32).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

# Authoritative even when JAX_PLATFORMS names another platform.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound the XLA CPU compiler's in-process accumulation.

    A single-process full-suite run segfaults inside XLA's CPU
    backend_compile after ~180 tests' worth of compiles (observed twice
    on the 1-core box, both times while compiling the fill pipeline;
    every sub-suite passes in a fresh process). Dropping the executable
    caches between modules keeps the accumulated compiler state small;
    modules rarely share jit signatures, so the lost cache hits are
    negligible.
    """
    yield
    jax.clear_caches()
