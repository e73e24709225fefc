"""Dense uniform-grid broad phase.

An independent exact engine for counts: the pair *set* is defined purely
geometrically (strict overlap of center±radius AABBs), so this module
computes it with one multi-operand sort, a segment scan, one row-scatter,
and a fixed 14-offset stencil of fully dense tile-vs-tile AABB tests — no
tree and no per-sphere candidate lists.

Structure:
  1. Cell size s = max(2·r_max, extent/grid_dim) per axis — so any
     colliding pair is in the same or an adjacent cell (|dx| < r_i + r_j
     <= 2·r_max <= s). Large radii gracefully degrade toward one big cell
     (which is brute force — still exact).
  2. One ``lax.sort`` with the cell id as key carries all payloads —
     no permutation gathers.
  3. In-cell ranks come from a segment scan (cummax of boundary indices);
     a single row-scatter packs each sphere's (lo, hi, id) into its
     [cell, slot] of a dense [G, cell_capacity, 8] bin tensor. Empty slots
     and the one-cell halo border are +inf rows, which strict overlap can
     never match.
  4. Every unordered cell pair is visited exactly once via the 13
     lexicographically-positive neighbor offsets plus the self-offset
     (upper-triangle within a cell) — the dedup analog of the reference's
     ``right_edge`` rule. Each offset is a dense
     [G, cell_capacity, cell_capacity] test: compares only, no gathers.

Capacity knobs are static (XLA shapes): ``grid_dim`` cells per axis and
``cell_capacity`` slots per cell. A cell overflowing its capacity cannot be
silently wrong — the result carries an ``ok`` flag and the caller retries
with a bigger capacity, mirroring the reference's count-past-capacity
retry contract (collision.cl:203-207).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

#: Neighbor offsets covering each unordered cell pair once: (0,0,0) handled
#: separately with an upper-triangle mask; these 13 are the lexicographically
#: positive half of the 26-neighborhood.
_HALF_OFFSETS = tuple(
    (dx, dy, dz)
    for dx in (0, 1)
    for dy in ((-1, 0, 1) if dx == 1 else (0, 1))
    for dz in ((-1, 0, 1) if (dx == 1 or dy == 1) else (1,))
)
assert len(_HALF_OFFSETS) == 13


class GridCounts(NamedTuple):
    """Count-pass output: total pairs + per-(offset, cell) tile counts."""

    total: jax.Array            # uint32 scalar — exact pair count
    ok: jax.Array               # bool — False if any cell overflowed
    tile_counts: jax.Array      # int32[14, G] — pairs per offset per cell


def _bitcast_to(x_uint, dtype):
    """Store integer payloads inside float rows without value conversion."""
    if dtype == jnp.float32:
        return jax.lax.bitcast_convert_type(x_uint.astype(jnp.uint32), jnp.float32)
    return jax.lax.bitcast_convert_type(x_uint.astype(jnp.uint64), jnp.float64)


def build_grid(coords, radii, grid_dim, cell_capacity):
    """Bin spheres into a dense padded grid.

    Returns (bins, ok, ids_sorted) where bins is
    [grid_dim+2, grid_dim+2, grid_dim+2, cell_capacity, 8] in the coord
    dtype with a +inf halo border: lanes 0-2 = AABB lo, lane 3 = bitcast
    sphere id, lanes 4-6 = AABB hi, lane 7 = padding.
    """
    coords = jnp.asarray(coords)
    radii = jnp.asarray(radii)
    n = coords.shape[0]
    dt = coords.dtype
    G = grid_dim ** 3
    lo_s = jnp.min(coords, axis=0)
    hi_s = jnp.max(coords, axis=0)
    r_max = jnp.max(radii)
    extent = hi_s - lo_s
    s = jnp.maximum(2 * r_max, extent / grid_dim)
    s = jnp.where(s > 0, s, 1)

    cell_xyz = jnp.clip(
        ((coords - lo_s) / s).astype(jnp.int32), 0, grid_dim - 1
    )
    cell = (
        (cell_xyz[:, 0] * grid_dim + cell_xyz[:, 1]) * grid_dim + cell_xyz[:, 2]
    ).astype(jnp.uint32)

    # One sort carries all payloads: no permutation gathers afterwards.
    ids = jnp.arange(n, dtype=jnp.uint32)
    cell_s, ids_s, x_s, y_s, z_s, r_s = jax.lax.sort(
        (cell, ids, coords[:, 0], coords[:, 1], coords[:, 2], radii),
        num_keys=1, is_stable=True,
    )
    newseg = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), cell_s[1:] != cell_s[:-1]]
    )

    row = jnp.stack(
        [
            x_s - r_s, y_s - r_s, z_s - r_s,
            _bitcast_to(ids_s, dt),
            x_s + r_s, y_s + r_s, z_s + r_s,
            jnp.zeros_like(x_s),
        ],
        axis=-1,
    )

    # Rank within cell via a segment scan: the latest segment-start
    # index at or before i, tracked with a cummax — fully dense.
    iota = jnp.arange(n, dtype=jnp.int32)
    seg_start = jax.lax.cummax(jnp.where(newseg, iota, 0), axis=0)
    rank = iota - seg_start
    ok = jnp.all(rank < cell_capacity) if n else jnp.bool_(True)

    target = jnp.where(
        rank < cell_capacity,
        cell_s.astype(jnp.int32) * cell_capacity + rank,
        G * cell_capacity,
    )
    bins = jnp.full((G * cell_capacity, 8), jnp.inf, dt)
    bins = bins.at[target].set(row, mode="drop")

    bins = bins.reshape(grid_dim, grid_dim, grid_dim, cell_capacity, 8)
    # +inf halo so stencil shifts never wrap and never match.
    bins = jnp.pad(bins, ((1, 1), (1, 1), (1, 1), (0, 0), (0, 0)),
                   constant_values=jnp.inf)
    return bins, ok, ids_s


def _tile_overlap(a, b):
    """Dense strict-overlap mask between two [..., M, 8] tiles.

    Returns [..., M, M] bool: entry (i, j) = AABB i of ``a`` strictly
    overlaps AABB j of ``b`` (collision.cl:164-166 semantics). +inf pad
    rows never match (their lo is +inf, never < any hi).
    """
    alo = a[..., :, None, 0:3]
    ahi = a[..., :, None, 4:7]
    blo = b[..., None, :, 0:3]
    bhi = b[..., None, :, 4:7]
    return jnp.all((ahi > blo) & (alo < bhi), axis=-1)


def grid_count(coords, radii, grid_dim=32, cell_capacity=64):
    """Count colliding pairs with the dense stencil. Returns GridCounts."""
    M = cell_capacity
    bins, ok, _ = build_grid(coords, radii, grid_dim, cell_capacity)
    G3 = grid_dim

    center = bins[1:-1, 1:-1, 1:-1]
    tile_counts = []

    # Self offset: upper triangle within each cell.
    self_mask = _tile_overlap(center, center)
    tri = (
        jnp.arange(M)[None, :] > jnp.arange(M)[:, None]
    )
    self_counts = jnp.sum(
        (self_mask & tri).reshape(-1, M * M), axis=-1, dtype=jnp.int32
    )
    tile_counts.append(self_counts)

    for (dx, dy, dz) in _HALF_OFFSETS:
        nb = jax.lax.slice(
            bins,
            (1 + dx, 1 + dy, 1 + dz, 0, 0),
            (1 + dx + G3, 1 + dy + G3, 1 + dz + G3, M, 8),
        )
        mask = _tile_overlap(center, nb)
        tile_counts.append(
            jnp.sum(mask.reshape(-1, M * M), axis=-1, dtype=jnp.int32)
        )

    tile_counts = jnp.stack(tile_counts)  # [14, G]
    total = jnp.sum(tile_counts, dtype=jnp.uint32).astype(jnp.uint32)
    return GridCounts(total=total, ok=ok, tile_counts=tile_counts)
