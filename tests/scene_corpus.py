"""Scene corpus for the column pipeline, the engine ``collide`` runs.

Each scene is a hostile or regression case the library has met: exact
strict-overlap ties, a max-z quantization regression, one dense column,
windows spanning many rows, same-z clusters, mixed radii with a few
giants, and seeded fuzz over scale and density. Tests run each through
``collide`` and ``Collider`` in three modes (count, fill with room, fill
past capacity) against the O(N^2) oracle.
"""

import functools

import jax.numpy as jnp
import numpy as np

from collision_tpu import Collider, candidate_count, collide
from collision_tpu.columns import default_column_config
from collision_tpu.testing import brute_force_collisions, pair_array_to_set


def _uniform(n, seed, rmax):
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, rmax, n).astype("float32")
    return coords, radii


def max_z_regression():
    # A sphere exactly at the scene z-max once overflowed its quantized z
    # into the column bits of the sort key, duplicating pairs.
    rng = np.random.RandomState(6)
    coords = rng.random((128, 3)).astype("float32")
    coords[7, 2] = coords[:, 2].max() + 0.5
    coords[49, 2] = coords[:, 2].max()
    return coords, np.full(128, 0.3, "float32")


def one_dense_column():
    # Every sphere in one column: only the z-windows prune.
    return _uniform(200, 5, 0.2)


def touching_is_not_overlap():
    # AABBs sharing a face do not collide (collision.cl:164-166).
    coords = np.array([[0.0, 0, 0], [1.0, 0, 0], [2.5, 0, 0]], "float32")
    return coords, np.array([0.5, 0.5, 0.6], "float32")


def deep_windows():
    return _uniform(900, 21, 0.08)


def slab_boundary():
    # Spheres straddling x-slab boundaries and at the scene extremes.
    coords = np.array([
        [0.0, 0.5, 0.0], [1.0, 0.5, 1.0], [0.5, 0.5, 0.5],
        [0.5001, 0.5, 0.5], [0.25, 0.5, 1.0], [0.2501, 0.5, 1.0],
    ], dtype="float32")
    return coords, np.full(6, 0.01, "float32")


def same_z_cluster():
    # Every sphere at one z: partners sit arbitrarily far in sort order.
    rng = np.random.RandomState(28)
    coords = rng.random((400, 3)).astype("float32")
    coords[:, 2] = 0.5
    return coords, np.full(400, 0.003, "float32")


def wide_windows():
    # Windows of hundreds of spheres: far past the default candidate
    # bound, so the Collider's retry ladder answers.
    return _uniform(1200, 19, 0.25)


def power_law():
    rng = np.random.RandomState(0)
    coords = rng.random((1500, 3)).astype("float32")
    radii = (0.004 * (1 + rng.pareto(1.2, 1500))).clip(0, 0.35)
    return coords, radii.astype("float32")


def one_giant_sphere():
    coords, radii = _uniform(800, 1, 0.02)
    radii[17] = 0.4  # overlaps a large fraction of the scene
    return coords, radii


def big_big_overlaps():
    rng = np.random.RandomState(2)
    coords = rng.random((600, 3)).astype("float32")
    radii = rng.uniform(0, 0.01, 600).astype("float32")
    radii[100:110] = rng.uniform(0.2, 0.3, 10)
    return coords, radii


def uniform():
    return _uniform(1000, 3, 1.5 / np.sqrt(1000))


def multi_group():
    # Many small spheres in few columns (cut from 3,500 spheres to 2,000).
    return _uniform(2000, 21, 0.02)


def fuzz(seed):
    # Random scene scale, density and radius fraction.
    rng = np.random.RandomState(300 + seed)
    n = int(rng.randint(50, 1200))
    scale = 10.0 ** rng.uniform(-2, 2)
    coords = (rng.random((n, 3)) * scale).astype("float32")
    radii = (rng.random(n) * scale * rng.uniform(0.005, 0.15)).astype(
        "float32")
    return coords, radii


SCENES = {
    "max_z_regression": max_z_regression,
    "one_dense_column": one_dense_column,
    "touching_is_not_overlap": touching_is_not_overlap,
    "deep_windows": deep_windows,
    "slab_boundary": slab_boundary,
    "same_z_cluster": same_z_cluster,
    "wide_windows": wide_windows,
    "power_law": power_law,
    "one_giant_sphere": one_giant_sphere,
    "big_big_overlaps": big_big_overlaps,
    "uniform": uniform,
    "multi_group": multi_group,
}
SCENES.update({"fuzz{}".format(s): functools.partial(fuzz, s)
               for s in range(6)})

#: The float64 subset.
F64_SCENES = ("max_z_regression", "touching_is_not_overlap", "deep_windows",
              "same_z_cluster", "power_law")

MODES = ("count", "room", "past")


@functools.lru_cache(maxsize=None)
def scene(name, dtype="float32"):
    """(coords, radii, expected pair set) of a named scene."""
    coords, radii = SCENES[name]()
    coords, radii = coords.astype(dtype), radii.astype(dtype)
    return coords, radii, frozenset(brute_force_collisions(coords, radii))


def _capacity(mode, expected):
    if mode == "room":
        return len(expected) + 7
    return max(1, len(expected) // 2)


def _check(mode, count, pairs, capacity, expected):
    assert int(count) == len(expected)
    if mode == "count":
        assert pairs is None
        return
    k = min(capacity, len(expected))
    got = pair_array_to_set(pairs, k)
    assert len(got) == k
    if mode == "room":
        assert got == expected
        assert (np.asarray(pairs)[k:] == 0xFFFFFFFF).all()
    else:
        assert got <= expected


def check_collide(name, mode, dtype="float32"):
    """``collide`` with the candidate bound the scene needs: ok and exact."""
    coords, radii, expected = scene(name, dtype)
    c, r = jnp.asarray(coords), jnp.asarray(radii)
    gxy = default_column_config(len(coords))
    cand = 1 << int(float(candidate_count(c, r, gxy)) + 64).bit_length()
    cap = 0 if mode == "count" else _capacity(mode, expected)
    res = collide(c, r, cap, cand_capacity=cand)
    assert bool(res.ok)
    _check(mode, res.count, res.pairs, cap, expected)


def check_collider(name, mode, dtype="float32"):
    """``Collider.get_collisions`` at default knobs: the retry ladder
    finds an exact answer."""
    coords, radii, expected = scene(name, dtype)
    coll = Collider(len(coords), coord_dtype=dtype)
    if mode == "count":
        count = coll.get_collisions(coords, radii, 0, collisions=None)
        _check(mode, count, None, 0, expected)
        return
    cap = _capacity(mode, expected)
    count, pairs = coll.get_collisions(coords, radii, cap)
    _check(mode, count, pairs, cap, expected)
