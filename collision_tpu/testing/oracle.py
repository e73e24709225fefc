"""Numpy oracles for parity testing.

``brute_force_collisions`` is the O(N²) pair oracle every end-to-end test
checks against — the same construction as the reference's ``find_collisions``
(/root/reference/tests/test_collision_py.py:30-37): strict componentwise AABB
overlap of center±radius boxes, lower-triangle only (no self-pairs, each
unordered pair once), returned as a set of (i, j) with i > j in the
reference's orientation — order within a pair is normalized by callers.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def brute_force_collisions(coords, radii):
    """Exact set of colliding sphere-AABB pairs, as a set of sorted tuples."""
    coords = np.asarray(coords)
    radii = np.asarray(radii)
    lo = coords - radii.reshape(-1, 1)
    hi = coords + radii.reshape(-1, 1)
    overlap = (hi.reshape(-1, 1, 3) > lo.reshape(1, -1, 3)) & (
        lo.reshape(-1, 1, 3) < hi.reshape(1, -1, 3)
    )
    overlap = overlap.all(axis=-1)
    overlap = np.tril(overlap, -1)
    ii, jj = np.nonzero(overlap)
    return {(int(a), int(b)) for a, b in zip(np.minimum(ii, jj), np.maximum(ii, jj))}


def pair_array_to_set(pairs, count):
    """Normalize a [cap, 2] device pair buffer to a set of sorted tuples."""
    pairs = np.asarray(pairs)[: int(count)]
    pairs = np.sort(pairs, axis=1)
    return {tuple(map(int, p)) for p in pairs}


def brute_force_count(coords, radii, block=512):
    """Exact unordered pair count, row-blocked.

    The set oracle materializes an [n, n, 3] overlap tensor — n in the
    10^5 range needs tens of GB. This walks ``block``-row strips with
    one [block, n] bool live at a time, so 10^5-sphere scenes verify in
    seconds of numpy on the host."""
    coords = np.asarray(coords)
    radii = np.asarray(radii).reshape(-1, 1)
    lo = coords - radii
    hi = coords + radii
    n = len(coords)
    jj = np.arange(n)[None, :]
    total = 0
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        m = (hi[i0:i1, None, 0] > lo[None, :, 0]) \
            & (lo[i0:i1, None, 0] < hi[None, :, 0])
        m &= (hi[i0:i1, None, 1] > lo[None, :, 1]) \
            & (lo[i0:i1, None, 1] < hi[None, :, 1])
        m &= (hi[i0:i1, None, 2] > lo[None, :, 2]) \
            & (lo[i0:i1, None, 2] < hi[None, :, 2])
        m &= jj > np.arange(i0, i1)[:, None]
        total += int(np.count_nonzero(m))
    return total


def _block_overlap(lo, hi, b, block):
    """bool[block, n]: strict AABB overlap of rows ``b*block + k`` against
    every sphere, restricted to j > i (rows past n match nothing)."""
    n = lo.shape[0]
    i = b * block + jnp.arange(block, dtype=jnp.int32)
    ic = jnp.minimum(i, n - 1)
    rlo = jnp.take(lo, ic, axis=0)
    rhi = jnp.take(hi, ic, axis=0)
    m = jnp.arange(n, dtype=jnp.int32)[None, :] > i[:, None]
    for a in range(3):
        m &= (rhi[:, None, a] > lo[None, :, a]) \
            & (rlo[:, None, a] < hi[None, :, a])
    return m


@partial(jax.jit, static_argnames=("block",))
def _block_count(lo, hi, b, block):
    return jnp.sum(_block_overlap(lo, hi, b, block), dtype=jnp.int32)


@partial(jax.jit, static_argnames=("block", "size"))
def _block_pairs(lo, hi, b, block, size):
    ii, jj = jnp.nonzero(_block_overlap(lo, hi, b, block), size=size,
                         fill_value=-1)
    return jnp.where(ii >= 0, ii + b * block, -1), jj


def blocked_collisions(coords, radii, block=4096, with_pairs=True):
    """Exact O(N^2) pair count (and pair array) in plain jnp, row-tiled.

    The device-side oracle for scenes too large for
    :func:`brute_force_collisions`: one [block, n] overlap tile lives at a
    time, so memory is O(block * n) wherever it runs. Semantics are the
    same strict componentwise AABB overlap, each unordered pair once.

    Returns the count (int) and, with ``with_pairs``, an int64 [count, 2]
    array of (i, j), i < j, sorted row-major.
    """
    coords = jnp.asarray(coords)
    radii = jnp.asarray(radii)[:, None]
    lo, hi = coords - radii, coords + radii
    n = coords.shape[0]
    block = int(min(block, n))
    nblk = -(-n // block)
    counts = [int(_block_count(lo, hi, b, block)) for b in range(nblk)]
    total = sum(counts)
    if not with_pairs:
        return total
    size = max(1, 1 << (max(counts) - 1).bit_length()) if total else 1
    out = []
    for b, c in enumerate(counts):
        if c:
            ii, jj = _block_pairs(lo, hi, b, block, size)
            out.append(np.stack([np.asarray(ii)[:c], np.asarray(jj)[:c]],
                                axis=1).astype(np.int64))
    pairs = np.concatenate(out) if out else np.zeros((0, 2), np.int64)
    return total, pairs
