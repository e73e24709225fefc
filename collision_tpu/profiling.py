"""Profiling / timing utilities.

The reference's only instruments are OpenCL events and pytest-benchmark
wall clocks (SURVEY.md §5); the equivalents here are XLA profiler traces
and step timing that ends in ``jax.block_until_ready`` (JAX returns before
the device finishes, so a timing without it measures the enqueue).
"""

import contextlib
import time

import numpy as np


def sync(tree):
    """Wait until every array in a pytree is computed; returns the tree."""
    import jax

    return jax.block_until_ready(tree)


@contextlib.contextmanager
def step_timer(name="step", printer=print):
    """Context manager timing a block with completion forced by the caller
    via :func:`sync`; prints milliseconds."""
    t = time.perf_counter()
    yield
    printer("{}: {:.3f} ms".format(name, (time.perf_counter() - t) * 1e3))


@contextlib.contextmanager
def trace(log_dir):
    """XLA profiler trace around a block (view with TensorBoard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, rounds=10, warmup=3):
    """Median wall-clock ms of ``fn(*args)``, each call synchronized."""
    for _ in range(warmup):
        sync(fn(*args))
    times = []
    for _ in range(rounds):
        t = time.perf_counter()
        sync(fn(*args))
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))
