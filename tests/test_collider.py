"""End-to-end Collider parity tests ported from reference
tests/test_collision_py.py: exact pair-set equality vs the O(N²) numpy
oracle, count-only mode, overflow ValueError, padded_size goldens, resize."""

import jax.numpy as jnp
import numpy as np
import pytest

from collision_tpu import Collider, collide, collide_exact
from collision_tpu.testing import brute_force_collisions, pair_array_to_set


def _random_scene(size, coord_dtype):
    np.random.seed(4)
    coords = np.random.random((size, 3)).astype(coord_dtype)
    radius = 1 / (size ** 0.5)  # Keep number of collisions under control
    radii = np.random.uniform(0, radius, size).astype(coord_dtype)
    return coords, radii


@pytest.mark.parametrize("size,ngroups,group_size,expected", [
    (48, 3, 8, 48), (47, 3, 8, 48), (49, 3, 8, 64),
])
def test_padded_size(size, ngroups, group_size, expected):
    # Goldens from reference tests/test_collision_py.py:40-46.
    collider = Collider(size, ngroups, group_size, "float32")
    assert collider.padded_size == expected


@pytest.mark.parametrize("coord_dtype", ["float32", "float64"])
def test_collision(coord_dtype):
    coords = np.array([
        [0.0, 1.0, 3.0],
        [0.0, 1.0, 3.0],
        [4.0, 1.0, 8.0],
        [-4.0, -6.0, 3.0],
        [-5.0, 0.0, -1.0],
        [-5.0, 0.5, -0.5],
    ], dtype=coord_dtype)
    radii = np.ones(len(coords), dtype=coord_dtype)
    expected = {(0, 1), (4, 5)}

    collider = Collider(len(coords), 3, 8, coord_dtype)
    count, pairs = collider.get_collisions(coords, radii, len(expected))
    assert int(count) == len(expected)
    assert pair_array_to_set(pairs, count) == expected


@pytest.mark.parametrize("coord_dtype", ["float32", "float64"])
@pytest.mark.parametrize("size,ngroups,group_size", [
    (120, 5, 8), (256, 4, 32), (317, 4, 16), (341, 4, 64),
])
def test_random_collision(coord_dtype, size, ngroups, group_size):
    collider = Collider(size, ngroups, group_size, coord_dtype)
    coords, radii = _random_scene(size, coord_dtype)
    expected = brute_force_collisions(coords, radii)

    count, pairs = collider.get_collisions(coords, radii, len(expected))
    assert int(count) == len(expected)
    assert pair_array_to_set(pairs, count) == expected


@pytest.mark.parametrize("old_shape,new_shape", [
    ((350, 8, 64), (351, 8, 64)),
    ((350, 8, 64), (351, None, None)),
])
def test_random_collision_resized(old_shape, new_shape):
    collider = Collider(*old_shape, "float32")
    collider.resize(*new_shape)

    size = new_shape[0] or old_shape[0]
    coords, radii = _random_scene(size, "float32")
    expected = brute_force_collisions(coords, radii)

    count, pairs = collider.get_collisions(coords, radii, len(expected))
    assert int(count) == len(expected)
    assert pair_array_to_set(pairs, count) == expected


@pytest.mark.parametrize("size,ngroups,group_size", [(100, 10, 8)])
def test_count_only(size, ngroups, group_size):
    # Count-only mode (reference tests/test_collision_py.py:261-296).
    collider = Collider(size, ngroups, group_size, "float32")
    coords, radii = _random_scene(size, "float32")
    expected = brute_force_collisions(coords, radii)
    count = collider.get_collisions(coords, radii, 0, collisions=None)
    assert int(count) == len(expected)


@pytest.mark.parametrize("size,ngroups,group_size", [(100, 5, 8)])
def test_count_err(size, ngroups, group_size):
    # None pair request with capacity > 0 raises
    # (reference collision.py:134-135).
    collider = Collider(size, ngroups, group_size, "float32")
    coords, radii = _random_scene(size, "float32")
    with pytest.raises(ValueError):
        collider.get_collisions(coords, radii, 10, collisions=None)


@pytest.mark.parametrize("dt", ["float32", np.dtype("float32"),
                                "float64", np.dtype("float64")])
def test_collider_dtype(dt):
    collider = Collider(100, 5, 8, coord_dtype=dt)
    assert collider.coord_dtype == np.dtype(dt)


def test_collider_invalid_dtype():
    with pytest.raises(ValueError):
        Collider(100, 5, 8, coord_dtype="uint32")


def test_collider_shape_validation():
    collider = Collider(10, 1, 8, "float32")
    with pytest.raises(ValueError):
        collider.get_collisions(np.zeros((11, 3), "float32"),
                                np.zeros(11, "float32"), 0, collisions=None)


def test_overflow_count_exceeds_capacity():
    # Contract #3 (SURVEY.md §3.1): counter reports the true total even
    # when it exceeds capacity.
    size = 100
    collider = Collider(size, 5, 8, "float32")
    coords, radii = _random_scene(size, "float32")
    expected = brute_force_collisions(coords, radii)
    assert len(expected) > 2
    count, pairs = collider.get_collisions(coords, radii, 2)
    assert int(count) == len(expected)
    assert pairs.shape == (2, 2)
    assert pair_array_to_set(pairs, 2) <= expected


def test_functional_collide_result():
    coords, radii = _random_scene(64, "float32")
    expected = brute_force_collisions(coords, radii)
    res = collide(jnp.asarray(coords), jnp.asarray(radii), len(expected) + 8)
    assert int(res.count) == len(expected)
    assert pair_array_to_set(res.pairs, res.count) == expected
    assert not bool(res.overflowed)
    np.testing.assert_equal(np.asarray(res.scene_min), coords.min(axis=0))
    np.testing.assert_equal(np.asarray(res.scene_max), coords.max(axis=0))


def test_collide_count_only_mode():
    coords, radii = _random_scene(64, "float32")
    res = collide(jnp.asarray(coords), jnp.asarray(radii), 0)
    assert res.pairs is None
    assert int(res.count) == len(brute_force_collisions(coords, radii))


def test_single_sphere():
    res = collide(jnp.zeros((1, 3), jnp.float32), jnp.ones((1,), jnp.float32), 4)
    assert int(res.count) == 0


def test_two_identical_spheres():
    coords = np.zeros((2, 3), "float32")
    radii = np.ones(2, "float32")
    res = collide(jnp.asarray(coords), jnp.asarray(radii), 4)
    assert int(res.count) == 1
    assert pair_array_to_set(res.pairs, res.count) == {(0, 1)}


def test_default_grid_config():
    from collision_tpu.collider import default_grid_config, default_grid_dim
    gd, mc = default_grid_config(1_000_000)
    assert gd == 24 and 96 <= mc <= 136
    assert default_grid_dim(100) >= 4
    assert default_grid_dim(10**9) == 64
    gd2, mc2 = default_grid_config(100)
    assert mc2 >= 16


def test_enable_compilation_cache(tmp_path, monkeypatch):
    # JAX_COMPILATION_CACHE_DIR, where set, is the cache and no other
    # directory is set in code.
    import os

    import jax

    from collision_tpu.utils import enable_compilation_cache
    want = str(tmp_path / "xla")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        p = enable_compilation_cache()
        assert p == want and os.path.isdir(p)
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        # Leaving the persistent cache pointed at a pytest tmp dir makes
        # every later >=1s compile in the worker write its executable
        # there.
        jax.config.update("jax_compilation_cache_dir", None)


def test_overflowed_false_in_count_only_mode():
    # pairs=None means no buffer was requested: nothing can overflow even
    # when collisions exist (the count is always the exact total).
    coords, radii = _random_scene(64, "float32")
    res = collide(jnp.asarray(coords), jnp.asarray(radii), 0)
    assert int(res.count) > 0
    assert res.pairs is None
    assert res.overflowed is False


@pytest.mark.parametrize("bad", [
    {"size": 0}, {"size": -3}, {"size": 2.5},
    {"ngroups": 0}, {"ngroups": -1},
    {"group_size": 0}, {"group_size": 3}, {"group_size": 48},
    {"radix_bits": 5}, {"radix_bits": 0}, {"radix_bits": 64},
])
def test_resize_rejects_invalid_and_rolls_back(bad):
    # The reference revalidates on resize and restores prior state on
    # failure (collision.py:84-119, radix.py:93-97).
    collider = Collider(100, 5, 8, "float32")
    with pytest.raises(ValueError):
        collider.resize(**bad)
    assert (collider.size, collider.ngroups, collider.group_size) == (100, 5, 8)


@pytest.mark.parametrize("bad", [
    {"size": 0}, {"ngroups": 0}, {"group_size": 12},
])
def test_constructor_rejects_invalid_params(bad):
    kwargs = {"size": 100, "ngroups": 5, "group_size": 8}
    kwargs.update(bad)
    with pytest.raises(ValueError):
        Collider(**kwargs)


def _wide_window_scene(n=2000, seed=11):
    # One column (gxy=1 at this n) and r_max = 0.05: ~150 conservative
    # candidates per sphere, past the default bound of max(2^17, 32n) —
    # so the first shot reports ok=False and the retry ladder runs.
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype(np.float32)
    radii = rng.uniform(0, 0.05, n).astype(np.float32)
    return coords, radii


def test_retry_exact_plan_stats_interpret_count():
    # Collider._retry_exact's candidate rung: the first collide reports
    # ok=False, one candidate_count sizes the bound, and the re-run is
    # exact.
    coords, radii = _wide_window_scene()
    expected = brute_force_collisions(coords, radii)
    first = collide(jnp.asarray(coords), jnp.asarray(radii), 0)
    assert not bool(first.ok)

    collider = Collider(len(coords), method="column")
    count = collider.get_collisions(coords, radii, 0, collisions=None)
    assert collider.last_rung == "candidates"
    assert int(count) == len(expected)


def test_retry_exact_plan_stats_interpret_fill():
    # Same forced-retry scenario, fill mode: the candidate rung must
    # return the exact pair set.
    coords, radii = _wide_window_scene(n=1500, seed=12)
    expected = brute_force_collisions(coords, radii)
    assert expected  # scene must actually collide

    collider = Collider(len(coords), method="column")
    count, pairs = collider.get_collisions(
        coords, radii, len(expected) + 16)
    assert collider.last_rung == "candidates"
    assert int(count) == len(expected)
    assert pair_array_to_set(pairs, count) == expected


@pytest.mark.parametrize("capacity", [0, 1, 4096])
def test_retry_exact_bvh_rung(monkeypatch, capacity):
    # A candidate bound past CAND_MAX falls back to the LBVH, which is
    # exact at any radius spread; count-past-capacity holds there too.
    monkeypatch.setattr(Collider, "CAND_MAX", 1 << 10)
    coords, radii = _wide_window_scene(seed=13)
    expected = brute_force_collisions(coords, radii)
    collider = Collider(len(coords))
    if capacity == 0:
        count = collider.get_collisions(coords, radii, 0, collisions=None)
    else:
        count, pairs = collider.get_collisions(coords, radii, capacity)
        k = min(capacity, len(expected))
        got = pair_array_to_set(pairs, k)
        assert len(got) == k and got <= expected
    assert collider.last_rung == "bvh"
    assert int(count) == len(expected)


def test_collide_exact_matches_collider_rungs():
    coords, radii = _wide_window_scene(n=1000, seed=14)
    expected = brute_force_collisions(coords, radii)
    res = collide_exact(coords, radii, len(expected) + 8)
    assert bool(res.ok)
    assert int(res.count) == len(expected)
    assert pair_array_to_set(res.pairs, res.count) == expected


def test_first_shot_rung_on_uniform_scene():
    coords, radii = _random_scene(500, "float32")
    collider = Collider(500)
    count = collider.get_collisions(coords, radii, 0, collisions=None)
    assert collider.last_rung == "first"
    assert int(count) == len(brute_force_collisions(coords, radii))


@pytest.mark.parametrize("method", ["slab", "hetero", "sweep"])
def test_removed_methods_raise(method):
    with pytest.raises(ValueError, match="auto, column, grid, bvh"):
        collide(jnp.zeros((4, 3), jnp.float32), jnp.ones(4, jnp.float32),
                0, method=method)
    with pytest.raises(ValueError, match="auto, column, grid, bvh"):
        Collider(4, method=method)


def test_auto_routes_to_column():
    # "auto" runs the column pipeline: same compiled program, same
    # deterministic pair buffer, at every n.
    coords, radii = _random_scene(300, "float32")
    c, r = jnp.asarray(coords), jnp.asarray(radii)
    auto = collide(c, r, 512)
    col = collide(c, r, 512, method="column")
    assert bool(auto.ok)
    np.testing.assert_array_equal(np.asarray(auto.pairs),
                                  np.asarray(col.pairs))
    assert int(auto.count) == int(col.count)


def test_retry_terminates_on_unsplittable_cluster():
    # Every sphere at one point: ~n^2/2 conservative candidates, past
    # CAND_MAX and past the int32 guard, so the ladder must go straight
    # to the exact BVH engine instead of looping.
    n = 65536
    coords = np.full((n, 3), 0.5, "float32")
    radii = np.zeros(n, "float32")  # point AABBs: strict overlap = none
    collider = Collider(n)
    count = collider.get_collisions(coords, radii, 0, collisions=None)
    assert collider.last_rung == "bvh"
    assert int(count) == 0
