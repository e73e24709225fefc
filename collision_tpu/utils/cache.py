"""Compilation persistence.

The reference's only persistent state is its compiled OpenCL programs,
shared across instances via constructor injection (SURVEY.md §5: the
rebuild equivalent is the jit cache). This helper turns on JAX's on-disk
compilation cache so the first compile of the jitted collide step (seconds
for the 1M-sphere program) is paid once per cache rather than once per
process.
"""

import os

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not set: a
#: fixed path inside the checkout (the path is part of the cache key, so a
#: directory that moves between runs never hits).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache():
    """Enable JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used and
    no other is set. Otherwise the cache lives at :data:`DEFAULT_CACHE_DIR`.
    Safe to call multiple times; call before the first jitted execution.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
