"""Traversal tests ported from reference tests/test_collision.py:302-423,
plus the count-then-fill overflow contract (collision.cl:203-207)."""

import jax.numpy as jnp
import numpy as np
import pytest

from collision_tpu import (
    aabb_overlap,
    build,
    find_pairs,
    leaf_bounds,
    morton_encode,
    refit,
    traverse_count,
)
from collision_tpu.lbvh.traverse import NO_PAIR
from collision_tpu.testing import brute_force_collisions, pair_array_to_set


def _pipeline(coords, radii):
    coords = np.asarray(coords)
    lo_s, hi_s = coords.min(axis=0), coords.max(axis=0)
    codes = np.asarray(morton_encode(coords, lo_s, hi_s))
    order = np.argsort(codes, kind="mergesort").astype("uint32")
    tree = build(jnp.asarray(codes[order]), jnp.asarray(order))
    llo, lhi = leaf_bounds(coords, radii, tree.leaf_id)
    lo, hi = refit(tree, llo, lhi)
    return tree, lo, hi


def test_traverse():
    # Reference scene (tests/test_collision.py:305-310), expected
    # {(0, 1), (4, 5)}.
    coords = np.array([
        [0.0, 1.0, 3.0],
        [0.0, 1.0, 3.0],
        [4.0, 1.0, 8.0],
        [-4.0, -6.0, 3.0],
        [-5.0, 0.0, -1.0],
        [-5.0, 0.5, -0.5],
    ], dtype="float32")
    radii = np.ones(len(coords), dtype="float32")
    tree, lo, hi = _pipeline(coords, radii)
    pairs, total = find_pairs(tree, lo, hi, capacity=2)
    assert int(total) == 2
    assert pair_array_to_set(pairs, total) == {(0, 1), (4, 5)}


def test_overlap_is_strict():
    # Touching AABBs do NOT collide (collision.cl:164-166).
    a = jnp.array([0.0, 0.0, 0.0]), jnp.array([1.0, 1.0, 1.0])
    b = jnp.array([1.0, 0.0, 0.0]), jnp.array([2.0, 1.0, 1.0])
    assert not bool(aabb_overlap(a[0], a[1], b[0], b[1]))
    c = jnp.array([0.99, 0.0, 0.0]), jnp.array([2.0, 1.0, 1.0])
    assert bool(aabb_overlap(a[0], a[1], c[0], c[1]))


def test_overflow_contract():
    # The returned total is the true count even past capacity; only the
    # first `capacity` slots are written; unwritten slots hold NO_PAIR.
    rng = np.random.RandomState(4)
    n = 120
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 2 / np.sqrt(n), n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    assert len(expected) > 4

    tree, lo, hi = _pipeline(coords, radii)
    capacity = 4
    pairs, total = find_pairs(tree, lo, hi, capacity=capacity)
    assert int(total) == len(expected)
    written = pair_array_to_set(pairs, min(int(total), capacity))
    assert len(written) == capacity
    assert written <= expected
    full_pairs, _ = find_pairs(tree, lo, hi, capacity=len(expected))
    assert pair_array_to_set(full_pairs, total) == expected


def test_count_only():
    rng = np.random.RandomState(11)
    n = 64
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 1 / np.sqrt(n), n).astype("float32")
    tree, lo, hi = _pipeline(coords, radii)
    counts = traverse_count(tree, lo, hi)
    assert int(np.asarray(counts).sum()) == len(
        brute_force_collisions(coords, radii)
    )


def test_no_pair_fill():
    coords = np.array([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]], dtype="float32")
    radii = np.ones(2, dtype="float32")
    tree, lo, hi = _pipeline(coords, radii)
    pairs, total = find_pairs(tree, lo, hi, capacity=3)
    assert int(total) == 0
    assert (np.asarray(pairs) == NO_PAIR).all()


def test_stack_overflow_detected():
    # The reference silently overwrites its stack top
    # at capacity (collision.cl:186-191); here the clipped push must be
    # *detected*. A dense random scene with stack_depth=2 forces clips
    # (ok=False); an ample depth completes clean (ok=True) with the exact
    # pair set — and both totals stay correct contracts-wise only in the
    # ok=True case.
    rng = np.random.RandomState(7)
    n = 512
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 2 / np.sqrt(n), n).astype("float32")
    expected = brute_force_collisions(coords, radii)
    tree, lo, hi = _pipeline(coords, radii)

    _, _, ok_small = find_pairs(
        tree, lo, hi, capacity=8, stack_depth=2, with_ok=True)
    assert not bool(ok_small)

    pairs, total, ok = find_pairs(
        tree, lo, hi, capacity=len(expected), with_ok=True)
    assert bool(ok)
    assert int(total) == len(expected)
    assert pair_array_to_set(pairs, total) == expected

    counts, ok_c = traverse_count(tree, lo, hi, stack_depth=2, with_ok=True)
    assert not bool(ok_c)


def test_duplicate_heavy_stack_bound():
    # Duplicate-code corpus: thousands of identical positions build the
    # deepest clz-tie-break trees; the default 64-deep stack must hold
    # (no clipped pushes) and the count must stay exact.
    n = 4096
    coords = np.zeros((n, 3), dtype="float32")
    coords[: n // 2] = 0.25  # two fat duplicate clusters
    radii = np.full(n, 1e-3, dtype="float32")
    tree, lo, hi = _pipeline(coords, radii)
    counts, ok = traverse_count(tree, lo, hi, with_ok=True)
    assert bool(ok)
    half = n // 2
    assert int(np.asarray(counts).sum()) == 2 * (half * (half - 1) // 2)


def test_identical_spheres():
    # All spheres identical: every pair collides; duplicate Morton codes
    # exercise the tie-break tree end-to-end.
    n = 16
    coords = np.ones((n, 3), dtype="float32")
    radii = np.ones(n, dtype="float32")
    tree, lo, hi = _pipeline(coords, radii)
    expected = n * (n - 1) // 2
    pairs, total = find_pairs(tree, lo, hi, capacity=expected)
    assert int(total) == expected
    assert pair_array_to_set(pairs, total) == brute_force_collisions(
        coords, radii
    )
