"""Multi-device sharded broad-phase: bit-parity with the single-device path
on an 8-virtual-device CPU mesh (the multi-GPU stand-in)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from collision_tpu import collide
from collision_tpu.parallel import collide_sharded, make_sharded_collider
from collision_tpu.testing import brute_force_collisions, pair_array_to_set


def _mesh(n_dev):
    devices = jax.devices()
    if len(devices) < n_dev:
        pytest.skip("Needs {} devices".format(n_dev))
    return Mesh(np.array(devices[:n_dev]), ("sp",))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_parity(n_dev):
    mesh = _mesh(n_dev)
    rng = np.random.RandomState(3)
    n = 256
    coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
    radii = jnp.asarray(rng.uniform(0, 1 / np.sqrt(n), n).astype("float32"))
    expected = brute_force_collisions(np.asarray(coords), np.asarray(radii))

    res = collide_sharded(coords, radii, len(expected) + 8, mesh)
    assert int(res.count) == len(expected)
    assert pair_array_to_set(res.pairs, res.count) == expected

    # Bit-identical buffers vs the single-device pipeline of the engine
    # this path shards (BVH; "auto" now routes small n to the column
    # engine, whose deterministic order differs while the set matches).
    ref = collide(coords, radii, len(expected) + 8, method="bvh")
    assert np.array_equal(np.asarray(res.pairs), np.asarray(ref.pairs))


def test_sharded_count_only():
    mesh = _mesh(4)
    rng = np.random.RandomState(5)
    n = 128
    coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
    radii = jnp.asarray(rng.uniform(0, 0.1, n).astype("float32"))
    res = collide_sharded(coords, radii, 0, mesh)
    assert res.pairs is None
    assert int(res.count) == len(
        brute_force_collisions(np.asarray(coords), np.asarray(radii))
    )


def test_sharded_requires_divisible_size():
    mesh = _mesh(8)
    with pytest.raises(ValueError):
        collide_sharded(
            jnp.zeros((100, 3), jnp.float32), jnp.ones((100,), jnp.float32),
            0, mesh,
        )


def test_sharded_jitted_step():
    mesh = _mesh(8)
    rng = np.random.RandomState(7)
    n = 512
    coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
    radii = jnp.asarray(rng.uniform(0, 1 / np.sqrt(n), n).astype("float32"))
    step = make_sharded_collider(mesh, capacity=4096)
    res = jax.block_until_ready(step(coords, radii))
    expected = brute_force_collisions(np.asarray(coords), np.asarray(radii))
    assert int(res.count) == len(expected)
    assert pair_array_to_set(res.pairs, res.count) == expected


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_fill_bit_parity(n_dev):
    # Candidate-sharded run-expansion fill must be bit-identical to the
    # single-device fill (same deterministic slot order) on any mesh.
    from collision_tpu.fill import run_fill
    from collision_tpu.parallel import make_sharded_fill

    mesh = _mesh(n_dev)
    rng = np.random.RandomState(11)
    n = 1000
    coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
    radii = jnp.asarray(rng.uniform(0, 1.2 / np.sqrt(n), n).astype("float32"))
    expected = brute_force_collisions(np.asarray(coords), np.asarray(radii))
    cap = len(expected) + 8
    gxy, cand = 3, 1 << 17

    step = make_sharded_fill(mesh, cap, gxy, cand)
    res = jax.block_until_ready(step(coords, radii))
    assert bool(res.ok)
    assert int(res.count) == len(expected)
    assert pair_array_to_set(res.pairs, res.count) == expected

    ref_pairs, ref_total, ref_ok = run_fill(coords, radii, cap, gxy, cand)
    assert bool(ref_ok) and int(ref_total) == len(expected)
    assert np.array_equal(np.asarray(res.pairs), np.asarray(ref_pairs))


def test_sharded_fill_count_only_and_overflow():
    from collision_tpu.parallel import make_sharded_fill

    mesh = _mesh(8)
    rng = np.random.RandomState(12)
    n = 600
    coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
    radii = jnp.asarray(rng.uniform(0, 0.1, n).astype("float32"))
    expected = brute_force_collisions(np.asarray(coords), np.asarray(radii))

    res0 = make_sharded_fill(mesh, 0, 3, 1 << 17)(coords, radii)
    assert res0.pairs is None
    assert int(res0.count) == len(expected)

    # Overflow contract: true total past a small capacity; the 3
    # materialized pairs are real.
    res3 = make_sharded_fill(mesh, 3, 3, 1 << 17)(coords, radii)
    assert int(res3.count) == len(expected)
    got = set(map(tuple, np.sort(np.asarray(res3.pairs), axis=1)))
    assert got <= expected and len(got) == 3
