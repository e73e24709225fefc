"""Sorted-run offsets: CSR-style bucket start indices of a sorted array.

Equivalent of the reference's offset kernel
(/root/reference/collision/offset.cl:3-12 + offset.py). The reference fills
``offsets[:] = n_values`` then has each thread compare adjacent values and
write run starts; the vectorized equivalent is a ``searchsorted``: for every
bucket value ``b`` in [0, n_offsets), ``offsets[b]`` is the index of the first
element >= b — which reproduces all the reference's edge semantics (missing
buckets point at the next run's start; trailing buckets get n_values; leading
buckets below values[0] get 0). Goldens pinned by reference
tests/test_offset_py.py:27-28,48-49.
"""

import jax.numpy as jnp
import numpy as np

_UNSIGNED = {np.dtype(d) for d in ("uint8", "uint16", "uint32", "uint64")}


def _count_less(table, buckets, strides):
    """searchsorted-left of ``buckets`` into sorted ``table`` = the count of
    table entries < bucket, via an n-level subsample pyramid.

    Each level subsamples every ``strides[0]``-th entry, recurses to locate
    the covering window, then resolves with a wide row-gather and a dense
    compare-count — all dense, full-bandwidth ops.
    """
    C = table.shape[0]
    if not strides or C <= 2 * strides[0]:
        # Small table: one dense compare-count is exact.
        return jnp.sum(
            table[None, :] < buckets[:, None], axis=1, dtype=jnp.int32)
    s = strides[0]
    pad = -(-C // s) * s
    big = jnp.asarray(np.iinfo(table.dtype).max, table.dtype)
    rows2d = jnp.full((pad,), big).at[:C].set(table).reshape(pad // s, s)
    b = _count_less(rows2d[:, 0], buckets, strides[1:])
    br = jnp.maximum(b - 1, 0)
    window = jnp.take(rows2d, br, axis=0)
    cnt = jnp.sum(window < buckets[:, None], axis=1, dtype=jnp.int32)
    return jnp.minimum(br * s + cnt, C)


def sorted_bucket_starts(values, buckets, strides=(64, 128)):
    """searchsorted(values, buckets, side='left') built from dense ops.

    XLA's searchsorted lowers to a binary search whose rounds serialize
    scalar gathers. This version never binary-searches: an n-level subsample
    pyramid (every ``strides[k]``-th key at level k) is resolved with
    dense compare-counts and wide row-gathers only. Pick more/smaller
    strides for very large tables so the top level stays dense-friendly.
    """
    values = jnp.asarray(values)
    buckets = jnp.asarray(buckets)
    return jnp.minimum(
        _count_less(values, buckets, tuple(strides)), values.shape[0])


def find_offsets(values, n_offsets, size=None, offset_dtype=jnp.uint32):
    """Bucket start offsets of a sorted integer array.

    Args:
      values: [n] sorted non-negative integers.
      n_offsets: static number of buckets to emit (callers size this as
        max_value + 2, reference tests/test_offset_py.py:34).
      size: optional valid prefix length of ``values`` (defaults to n).
      offset_dtype: dtype of the result.

    Returns:
      [n_offsets] array; offsets[b] = first index i with values[i] >= b,
      and offsets[b] = size for b > values[size-1].
    """
    values = jnp.asarray(values)
    if size is not None and size != values.shape[0]:
        values = values[:size]
    buckets = jnp.arange(n_offsets, dtype=values.dtype)
    return sorted_bucket_starts(values, buckets).astype(offset_dtype)


class OffsetFinder:
    """API-parity wrapper (reference offset.py:26-49)."""

    def __init__(self, value_dtype=np.dtype("uint32"), offset_dtype=np.dtype("uint32")):
        self.value_dtype = np.dtype(value_dtype)
        self.offset_dtype = np.dtype(offset_dtype)
        if self.value_dtype not in _UNSIGNED:
            raise ValueError("Invalid value dtype: {}".format(self.value_dtype))
        if self.offset_dtype not in _UNSIGNED:
            raise ValueError("Invalid offset dtype: {}".format(self.offset_dtype))

    def find_offsets(self, values, n_values, n_offsets):
        return find_offsets(
            values, n_offsets, size=n_values, offset_dtype=self.offset_dtype
        )
