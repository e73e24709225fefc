"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR where set, else a
fixed directory inside the checkout."""

import os

import jax
import pytest

from collision_tpu.utils import cache


@pytest.fixture
def restore_cache_dir():
    yield
    # Leaving the persistent cache on makes every later >=1s compile in
    # the worker write its executable there.
    jax.config.update("jax_compilation_cache_dir", None)


def test_env_dir_wins(tmp_path, monkeypatch, restore_cache_dir):
    want = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert cache.enable_compilation_cache() == want
    assert os.path.isdir(want)
    assert jax.config.jax_compilation_cache_dir == want


def test_default_dir_is_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache") == cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    # Fixed: a second call, from another working directory, agrees.
    monkeypatch.chdir(os.path.dirname(root))
    assert cache.enable_compilation_cache() == path


def test_empty_env_falls_back_to_default(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert cache.enable_compilation_cache() == cache.DEFAULT_CACHE_DIR
