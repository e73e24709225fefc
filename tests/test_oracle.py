"""The blocked jnp oracle against the numpy O(N^2) oracle, at tile sizes
that do and do not divide n."""

import numpy as np
import pytest

from collision_tpu.testing import (
    blocked_collisions, brute_force_collisions, brute_force_count)


def _scene(n, seed, rmax):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, rmax, n).astype("float32")
    return coords, radii


@pytest.mark.parametrize("n,block", [
    (1000, 128),   # does not divide n
    (1000, 333),
    (1000, 1000),  # one tile
    (1000, 4096),  # tile larger than n
    (999, 250),
    (2, 1),
])
def test_blocked_matches_brute_force(n, block):
    coords, radii = _scene(n, n + block, 2.0 / np.sqrt(n))
    expected = brute_force_collisions(coords, radii)
    total, pairs = blocked_collisions(coords, radii, block=block)
    assert total == len(expected)
    assert set(map(tuple, pairs.tolist())) == expected
    assert (pairs[:, 0] < pairs[:, 1]).all()


def test_blocked_count_only_and_row_blocked_count():
    coords, radii = _scene(1500, 7, 0.05)
    total = blocked_collisions(coords, radii, block=700, with_pairs=False)
    assert total == brute_force_count(coords, radii, block=97)
    assert total == len(brute_force_collisions(coords, radii))


def test_blocked_strict_overlap_and_no_pairs():
    # Touching faces are not overlaps; an empty result has shape [0, 2].
    coords = np.array([[0.0, 0, 0], [1.0, 0, 0], [2.5, 0, 0]], "float32")
    radii = np.array([0.5, 0.5, 0.6], "float32")
    total, pairs = blocked_collisions(coords, radii, block=2)
    assert total == 0 and pairs.shape == (0, 2)


def test_blocked_float64():
    coords, radii = _scene(400, 3, 0.1)
    coords, radii = coords.astype("float64"), radii.astype("float64")
    total, pairs = blocked_collisions(coords, radii, block=64)
    assert set(map(tuple, pairs.tolist())) == brute_force_collisions(
        coords, radii)
