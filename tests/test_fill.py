"""Run-expansion fill engine (fill.py): scatter-free pair enumeration.

Pure-XLA pipeline, so these tests run natively on CPU. Parity contract
pinned: exact unordered unique pairs
under strict AABB overlap (reference collision.cl:164-166, 198-215),
true-total-past-capacity, deterministic order, float64 support.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from collision_tpu.fill import candidate_count, run_fill
from collision_tpu.ops.offset import sorted_bucket_starts
from collision_tpu.testing import brute_force_collisions, pair_array_to_set


def _fill(coords, radii, capacity, gxy, cand=1 << 20):
    return run_fill(jnp.asarray(coords), jnp.asarray(radii), capacity,
                    gxy, cand)


@pytest.mark.parametrize("n,rscale,seed,gxy", [
    (64, 1.0, 0, 2),
    (317, 1.5, 1, 3),     # non-power-of-2
    (1000, 0.5, 2, 4),
    (1000, 0.5, 2, 1),    # single column
    (2048, 2.0, 3, 5),
    (5000, 1.2, 10, 6),
])
def test_run_fill_random_parity(n, rscale, seed, gxy):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, rscale / np.sqrt(n), n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    cap = max(len(expected) + 7, 16)
    pairs, total, ok = _fill(coords, radii, cap, gxy)
    assert bool(ok)
    assert int(total) == len(expected)
    assert pair_array_to_set(pairs, total) == expected


def test_run_fill_float64():
    rng = np.random.RandomState(7)
    n = 500
    coords = rng.random((n, 3)).astype("float64")
    radii = rng.uniform(0, 1 / np.sqrt(n), n).astype("float64")
    expected = brute_force_collisions(coords, radii)
    pairs, total, ok = _fill(coords, radii, len(expected) + 4, 4)
    assert bool(ok)
    assert int(total) == len(expected)
    assert pair_array_to_set(pairs, total) == expected


def test_run_fill_identical_positions():
    n = 96
    coords = np.full((n, 3), 0.25, "float32")
    radii = np.full(n, 0.1, "float32")
    pairs, total, ok = _fill(coords, radii, 8192, 4)
    assert bool(ok)
    assert int(total) == n * (n - 1) // 2


def test_run_fill_overflow_contract():
    # True total past capacity; only the first `capacity` pairs are
    # materialized, all of them real (collision.cl:203-215 semantics).
    rng = np.random.RandomState(3)
    n = 200
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 0.2, n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    assert len(expected) > 5
    pairs, total, ok = _fill(coords, radii, 5, 2)
    assert bool(ok)
    assert int(total) == len(expected)
    got = set(map(tuple, np.sort(np.asarray(pairs)[:5], axis=1)))
    assert got <= expected and len(got) == 5


def test_run_fill_candidate_overflow_detected():
    # An insufficient candidate bound is flagged, never silently wrong.
    rng = np.random.RandomState(3)
    n = 200
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 0.2, n).astype("float32")
    pairs, total, ok = _fill(coords, radii, 5, 2, cand=64)
    assert not bool(ok)
    needed = float(candidate_count(
        jnp.asarray(coords), jnp.asarray(radii), 2))
    pairs, total, ok = _fill(coords, radii, 5, 2, cand=int(needed) + 8)
    assert bool(ok)


def test_run_fill_count_only():
    rng = np.random.RandomState(11)
    n = 400
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 0.1, n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    pairs, total, ok = _fill(coords, radii, 0, 3)
    assert pairs is None
    assert bool(ok)
    assert int(total) == len(expected)


def test_run_fill_degenerate_axis():
    rng = np.random.RandomState(8)
    n = 150
    coords = rng.random((n, 3)).astype("float32")
    coords[:, 2] = 0.5
    radii = rng.uniform(0, 0.1, n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    pairs, total, ok = _fill(coords, radii, len(expected) + 4, 3, 1 << 18)
    assert bool(ok)
    assert int(total) == len(expected)
    assert pair_array_to_set(pairs, total) == expected


def test_run_fill_unfilled_slots_are_no_pair():
    rng = np.random.RandomState(5)
    n = 100
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 0.05, n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    cap = len(expected) + 9
    pairs, total, ok = _fill(coords, radii, cap, 2)
    tail = np.asarray(pairs)[int(total):]
    assert (tail == 0xFFFFFFFF).all()


def test_sorted_bucket_starts_multilevel():
    # The n-level pyramid must agree with numpy searchsorted at depth.
    rng = np.random.RandomState(0)
    vals = np.sort(rng.randint(0, 1 << 30, 300000).astype("uint32"))
    bks = rng.randint(0, 1 << 30, 4096).astype("uint32")
    for strides in [(64, 128), (16, 16, 16), (8, 8, 8, 8)]:
        got = np.asarray(sorted_bucket_starts(
            jnp.asarray(vals), jnp.asarray(bks), strides=strides))
        np.testing.assert_equal(got, np.searchsorted(vals, bks, "left"))
