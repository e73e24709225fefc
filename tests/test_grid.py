"""Dense uniform-grid engine: exact-count parity with the oracle and the
BVH path, overflow flagging, degenerate scenes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from collision_tpu import collide
from collision_tpu.grid import build_grid, grid_count
from collision_tpu.testing import brute_force_collisions, pair_array_to_set


@pytest.mark.parametrize("n,grid_dim,cell_capacity,rscale", [
    (100, 8, 16, 1.0),
    (341, 8, 32, 1.0),
    (1000, 16, 32, 1.0),
    (1000, 4, 128, 4.0),   # big radii: few effective cells
    (50, 2, 64, 8.0),      # nearly one cell = brute force, still exact
])
def test_grid_count_parity(n, grid_dim, cell_capacity, rscale):
    rng = np.random.RandomState(n)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, rscale / np.sqrt(n), n).astype("float32")
    expected = len(brute_force_collisions(coords, radii))
    out = grid_count(
        jnp.asarray(coords), jnp.asarray(radii),
        grid_dim=grid_dim, cell_capacity=cell_capacity,
    )
    assert bool(out.ok)
    assert int(out.total) == expected


@pytest.mark.parametrize("coord_dtype", ["float32", "float64"])
def test_grid_dtypes(coord_dtype):
    rng = np.random.RandomState(2)
    n = 500
    coords = rng.random((n, 3)).astype(coord_dtype)
    radii = rng.uniform(0, 0.05, n).astype(coord_dtype)
    out = grid_count(jnp.asarray(coords), jnp.asarray(radii),
                     grid_dim=8, cell_capacity=64)
    assert bool(out.ok)
    assert int(out.total) == len(brute_force_collisions(coords, radii))


def test_grid_identical_spheres():
    coords = np.ones((20, 3), "float32")
    radii = np.ones(20, "float32")
    out = grid_count(jnp.asarray(coords), jnp.asarray(radii),
                     grid_dim=4, cell_capacity=32)
    assert bool(out.ok)
    assert int(out.total) == 20 * 19 // 2


def test_grid_strict_overlap():
    # Zero radii -> zero-size AABBs -> strictly no overlap, even coincident.
    coords = np.ones((20, 3), "float32")
    radii = np.zeros(20, "float32")
    out = grid_count(jnp.asarray(coords), jnp.asarray(radii),
                     grid_dim=4, cell_capacity=32)
    assert int(out.total) == 0


def test_grid_overflow_flag():
    # 20 spheres forced into one cell with capacity 8: must flag, not lie.
    coords = np.ones((20, 3), "float32")
    radii = np.ones(20, "float32")
    out = grid_count(jnp.asarray(coords), jnp.asarray(radii),
                     grid_dim=4, cell_capacity=8)
    assert not bool(out.ok)


def test_grid_halo_never_matches():
    # Spheres hugging the scene boundary: halo padding must not create
    # phantom pairs nor lose real ones.
    coords = np.array([
        [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.01, 0.0, 0.0],
        [1.0, 0.99, 1.0],
    ], dtype="float32")
    radii = np.full(4, 0.02, "float32")
    expected = len(brute_force_collisions(coords, radii))
    out = grid_count(jnp.asarray(coords), jnp.asarray(radii),
                     grid_dim=8, cell_capacity=8)
    assert int(out.total) == expected == 2


def test_collide_method_grid():
    rng = np.random.RandomState(11)
    n = 256
    coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
    radii = jnp.asarray(rng.uniform(0, 0.05, n).astype("float32"))
    res = collide(coords, radii, 0, method="grid")
    assert res.pairs is None
    assert bool(res.ok)
    ref = collide(coords, radii, 0, method="bvh")
    assert int(res.count) == int(ref.count)


def test_collide_grid_fill():
    # Grid fills take the column engine's run-expansion emission.
    rng = np.random.RandomState(13)
    n = 200
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 1.5 / np.sqrt(n), n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    res = collide(jnp.asarray(coords), jnp.asarray(radii),
                  len(expected) + 8, method="grid",
                  grid_dim=8, cell_capacity=16)
    assert bool(res.ok)
    assert int(res.count) == len(expected)
    got = set(map(tuple, np.sort(np.asarray(res.pairs)[:int(res.count)], axis=1)))
    assert got == expected


def test_collide_grid_fill_overflow():
    rng = np.random.RandomState(13)
    n = 100
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 3 / np.sqrt(n), n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    assert len(expected) > 4
    res = collide(jnp.asarray(coords), jnp.asarray(radii), 4,
                  method="grid", grid_dim=8, cell_capacity=32)
    assert int(res.count) == len(expected)
    got = set(map(tuple, np.sort(np.asarray(res.pairs)[:4], axis=1)))
    assert got <= expected


def test_collide_unknown_method():
    with pytest.raises(ValueError):
        collide(jnp.zeros((4, 3), jnp.float32), jnp.ones(4, jnp.float32),
                0, method="sweep")


def test_build_grid_ids_roundtrip():
    # The id lane must bitcast back to the original sphere ids.
    rng = np.random.RandomState(5)
    n = 64
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0.001, 0.01, n).astype("float32")
    bins, ok, ids_s = build_grid(jnp.asarray(coords), jnp.asarray(radii), 4, 32)
    assert bool(ok)
    rows = np.asarray(bins[1:-1, 1:-1, 1:-1]).reshape(-1, 8)
    filled = np.isfinite(rows[:, 0])
    got_ids = np.sort(
        np.asarray(
            jax.lax.bitcast_convert_type(
                jnp.asarray(rows[filled, 3]), jnp.uint32
            )
        )
    )
    np.testing.assert_equal(got_ids, np.arange(n, dtype="uint32"))


def test_collide_grid_fill_float64():
    # An explicit method="grid" fill request with f64 coords returns the
    # exact pair set at input precision (the run-expansion emission).
    rng = np.random.RandomState(7)
    n = 256
    coords = rng.random((n, 3)).astype("float64")
    radii = rng.uniform(0, 1 / np.sqrt(n), n).astype("float64")
    expected = brute_force_collisions(coords, radii)
    res = collide(jnp.asarray(coords), jnp.asarray(radii), 4096,
                  method="grid")
    assert int(res.count) == len(expected)
    assert pair_array_to_set(res.pairs, res.count) == expected
