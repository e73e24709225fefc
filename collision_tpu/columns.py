"""Column sort: spheres keyed by xy-column and quantized z.

The column pipeline (fill.py) bins spheres in x/y only, into columns at
least 2*r_max wide, and keeps z *continuous*: spheres are sorted once by the
composite key ``column_id << zbits | quantize(z)``, so each column is a
z-sorted contiguous run of the sorted stream. Every colliding pair then
lies in the same or an adjacent column, and its partner's z lies inside a
conservative window that one ``searchsorted`` finds. The 5 half-stencil
column offsets (self + (0,1) + (1,-1..1)) visit each unordered column pair
once — the analog of the reference's right_edge dedup rule,
collision.cl:198-200.

Correctness never depends on the grid: quantization is monotone, so
``quantize(z) >= quantize(lo)`` whenever ``z >= lo`` and windows are exact
supersets, and the candidate test itself is exact at input precision.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

#: xy half-stencil: (dx, dy) column offsets covering each unordered column
#: pair exactly once; the self offset pairs with a j > i index constraint.
COLUMN_OFFSETS = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))


def default_column_config(n, target_occupancy=1500):
    """Columns per xy axis (``gxy``) for ~``target_occupancy`` spheres per
    column. Columns clamp at 2*r_max wide, so any gxy is correct; this
    one balances the number of candidate runs against window length."""
    return int(np.clip(round((n / target_occupancy) ** 0.5), 1, 64))


def _zbits(gxy):
    # +1 so (ncols_ext << zbits) + zmax + 1 never wraps uint32 (the upper
    # window threshold of the last column at max z).
    ncols_ext = (gxy + 1) * gxy
    return 32 - max(int(np.ceil(np.log2(ncols_ext + 1))), 1)


def _quantize(z, lo, scale, zmax):
    # Clamp in the integer domain: float(zmax) rounds UP in f32 for
    # zmax = 2^k - 1, which would let a max-z sphere's quantum spill into
    # the column bits of the packed sort key.
    q = jnp.maximum((z - lo) * scale, 0.0)
    return jnp.minimum(q.astype(jnp.uint32), jnp.uint32(zmax))


class ColumnSort(NamedTuple):
    """Spheres sorted by the composite (column, quantized-z) key, plus the
    quantization parameters needed to key further window queries."""

    key_s: jax.Array   # uint32[n] sorted composite keys
    ids_s: jax.Array   # uint32[n] original sphere ids in sorted order
    x_s: jax.Array     # [n] sorted centers / radii
    y_s: jax.Array
    z_s: jax.Array
    r_s: jax.Array
    lo_s: jax.Array    # [3] scene AABB lower corner (of centers)
    zscale: jax.Array  # scalar: quantized units per z length
    r_max: jax.Array   # scalar


def _column_sort(coords, radii, gxy):
    """Sort spheres by ``column_id << zbits | quantize(z)``.

    Dtype-preserving: float64 coords keep float64 geometry (the fill
    engine tests AABBs at input precision); the quantized keys are always
    uint32.
    """
    n = coords.shape[0]
    zbits = _zbits(gxy)
    zmax = (1 << zbits) - 1

    lo_s = jnp.min(coords, axis=0)
    hi_s = jnp.max(coords, axis=0)
    r_max = jnp.max(radii)
    ext = hi_s - lo_s
    one = jnp.asarray(1.0, coords.dtype)
    # Column size >= 2*r_max per axis: colliding pairs always land in the
    # same or an adjacent column (grid.py invariant, restricted to x/y).
    sxy = jnp.maximum(2 * r_max, ext[:2] / gxy)
    sxy = jnp.where(sxy > 0, sxy, one)
    cxy = jnp.clip(
        ((coords[:, :2] - lo_s[:2]) / sxy).astype(jnp.int32), 0, gxy - 1
    )
    col = (cxy[:, 0] * gxy + cxy[:, 1]).astype(jnp.uint32)

    zext = jnp.where(ext[2] > 0, ext[2], one)
    zscale = zmax / zext
    zq = _quantize(coords[:, 2], lo_s[2], zscale, zmax)
    key = (col << zbits) | zq

    ids = jnp.arange(n, dtype=jnp.uint32)
    key_s, ids_s, x_s, y_s, z_s, r_s = jax.lax.sort(
        (key, ids, coords[:, 0], coords[:, 1], coords[:, 2], radii),
        num_keys=1, is_stable=True,
    )
    return ColumnSort(key_s, ids_s, x_s, y_s, z_s, r_s, lo_s, zscale, r_max)
