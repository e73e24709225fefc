"""Adversarial scenes: cross-engine exactness under hostile distributions.

The grid, BVH and column engines must each produce the exact oracle pair
set for scenes chosen to stress their weak points: duplicate positions and Morton ties (the BVH
tie-break), clustered blobs (grid cell overflow / deep trees), power-law
radii (grid cell sizing), lattice alignment (boundary/strict-overlap
ties), huge magnitudes and tiny extents (float precision), and degenerate
axes (NaN-safe Morton normalization)."""

import jax.numpy as jnp
import numpy as np
import pytest

from collision_tpu import collide
from collision_tpu.testing import brute_force_collisions, pair_array_to_set


def _check_both_engines(coords, radii, grid_dim=8, cell_capacity=None):
    from collision_tpu import candidate_count

    n = len(coords)
    expected = brute_force_collisions(coords, radii)
    cap = len(expected) + 8
    if cell_capacity is None:
        cell_capacity = n  # never overflow: exactness is the subject here
    rg = collide(jnp.asarray(coords), jnp.asarray(radii), cap,
                 method="grid", grid_dim=grid_dim,
                 cell_capacity=cell_capacity)
    rb = collide(jnp.asarray(coords), jnp.asarray(radii), cap, method="bvh")
    gxy = max(grid_dim // 2, 1)
    cand = int(candidate_count(
        jnp.asarray(coords), jnp.asarray(radii), gxy)) + 64
    rc = collide(jnp.asarray(coords), jnp.asarray(radii), cap,
                 method="column", gxy=gxy, cand_capacity=cand)
    assert bool(rg.ok)
    assert bool(rc.ok)
    assert int(rg.count) == len(expected) == int(rb.count) == int(rc.count)
    assert pair_array_to_set(rg.pairs, rg.count) == expected
    assert pair_array_to_set(rb.pairs, rb.count) == expected
    assert pair_array_to_set(rc.pairs, rc.count) == expected


def test_clustered_blobs():
    rng = np.random.RandomState(1)
    centers = rng.random((5, 3))
    coords = np.concatenate(
        [c + rng.normal(0, 0.01, (40, 3)) for c in centers]
    ).astype("float32")
    radii = rng.uniform(0, 0.02, len(coords)).astype("float32")
    _check_both_engines(coords, radii)


def test_power_law_radii():
    rng = np.random.RandomState(2)
    n = 150
    coords = rng.random((n, 3)).astype("float32")
    radii = (0.002 / rng.power(0.5, n)).clip(0, 0.5).astype("float32")
    _check_both_engines(coords, radii, grid_dim=4)


def test_lattice_alignment():
    # Spheres exactly on a lattice with radii exactly half the spacing:
    # AABBs touch exactly -> strict overlap says NO pair.
    g = np.arange(4, dtype="float32")
    coords = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)
    radii = np.full(len(coords), 0.5, "float32")
    expected = brute_force_collisions(coords, radii)
    assert len(expected) == 0
    _check_both_engines(coords, radii)
    # Nudge radii up an ulp-ish amount: every lattice neighbor now overlaps.
    radii2 = np.full(len(coords), 0.5001, "float32")
    _check_both_engines(coords, radii2)


def test_huge_magnitudes():
    rng = np.random.RandomState(3)
    n = 120
    coords = (rng.random((n, 3)) * 1e6 + 1e8).astype("float32")
    radii = rng.uniform(1e3, 1e4, n).astype("float32")
    _check_both_engines(coords, radii)


def test_planar_scene():
    # All spheres in the z=0 plane: one degenerate Morton/grid axis.
    rng = np.random.RandomState(5)
    n = 130
    coords = rng.random((n, 3)).astype("float32")
    coords[:, 2] = 0.0
    radii = rng.uniform(0, 0.08, n).astype("float32")
    _check_both_engines(coords, radii)


def test_collinear_scene():
    rng = np.random.RandomState(6)
    n = 100
    coords = np.zeros((n, 3), "float32")
    coords[:, 0] = np.sort(rng.random(n)).astype("float32")
    radii = rng.uniform(0, 0.02, n).astype("float32")
    _check_both_engines(coords, radii)


def test_many_duplicates():
    rng = np.random.RandomState(7)
    base = rng.random((10, 3)).astype("float32")
    coords = base[rng.randint(0, 10, 120)]
    radii = rng.uniform(0, 0.1, 120).astype("float32")
    _check_both_engines(coords, radii)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_cross_engine(seed):
    rng = np.random.RandomState(100 + seed)
    n = int(rng.randint(2, 400))
    scale = 10.0 ** rng.uniform(-3, 3)
    coords = (rng.random((n, 3)) * scale).astype("float32")
    radii = (rng.random(n) * scale * rng.uniform(0.001, 0.2)).astype(
        "float32"
    )
    gd = int(rng.choice([2, 4, 8, 16]))
    _check_both_engines(coords, radii, grid_dim=gd)
