"""Exclusive prefix scan.

Equivalent of the reference's multi-level Blelloch scan
(/root/reference/collision/scan.py + scan.cl + local_scan.cl). The reference
hand-builds a pyramid of per-group block sums because OpenCL offers nothing
above raw kernels; XLA compiles a prefix sum directly, so the functional
core here is a few lines. The ``PrefixScanner`` class keeps the reference's validated
size/group_size parameters, ``block_lengths`` pyramid (golden values pinned by
reference tests/test_scan_py.py:32-43), and resize contract for API parity.
"""

import jax.numpy as jnp

from ..utils import next_power_of_2, round_up


#: Inner block of the two-level 1-D scan (one lane-friendly row).
_SCAN_BLOCK = 4096


def inclusive_scan(values):
    """Inclusive prefix sum of a 1-D array via two blocked passes.

    XLA can lower a long ``cumsum`` to a log-depth reduce-window chain;
    per-block inner cumsums plus a cumsum of block totals keep each pass
    short and are exactly associative for the modular
    unsigned semantics the reference's device scan has.
    """
    n = values.shape[0]
    if n <= _SCAN_BLOCK:
        return jnp.cumsum(values, dtype=values.dtype)
    nb = -(-n // _SCAN_BLOCK)
    padded = jnp.zeros((nb * _SCAN_BLOCK,), values.dtype).at[:n].set(values)
    rows = padded.reshape(nb, _SCAN_BLOCK)
    inner = jnp.cumsum(rows, axis=1, dtype=values.dtype)
    bases = jnp.concatenate(
        [jnp.zeros((1,), values.dtype),
         jnp.cumsum(inner[:, -1], dtype=values.dtype)[:-1]])
    return (inner + bases[:, None]).reshape(-1)[:n]


def exclusive_scan(values, axis=0):
    """Exclusive prefix sum along ``axis``; result[0] == 0.

    Wraps modularly for unsigned dtypes exactly as the device scan does
    (uint32 addition, local_scan.cl:2-25).
    """
    import jax

    values = jnp.asarray(values)
    if values.ndim == 1 and axis == 0:
        inclusive = inclusive_scan(values)
    else:
        inclusive = jnp.cumsum(values, axis=axis, dtype=values.dtype)
    zero = jnp.zeros_like(
        jax.lax.slice_in_dim(inclusive, 0, 1, axis=axis))
    # Contiguous slice, NOT jnp.take(arange): a length-n take lowers to a
    # general gather.
    shifted = jnp.concatenate(
        [zero,
         jax.lax.slice_in_dim(inclusive, 0, values.shape[axis] - 1,
                              axis=axis)],
        axis=axis,
    )
    return shifted


def prefix_sum(values):
    """Alias matching the reference method name (scan.py:75)."""
    return exclusive_scan(values)


def _ceildiv(a, b):
    return -(-a // b)


class PrefixScanner:
    """Exclusive scanner with the reference's size contract (scan.py:15-73).

    Validates that group_size is a power of two and size is a multiple of
    2 * group_size, raising ValueError otherwise (scan.py:34-39); exposes the
    same ``block_lengths`` pyramid the reference derives its scratch buffers
    from (scan.py:62-73) so derived-quantity goldens carry over.
    """

    block_sums_dtype = jnp.uint32

    def __init__(self, size, group_size):
        self.check_size(size, group_size)
        self.size = size
        self.group_size = group_size

    @staticmethod
    def check_size(size, group_size):
        if group_size != next_power_of_2(group_size):
            raise ValueError(
                "Group size ({}) must be a power of two".format(group_size)
            )
        if size % (group_size * 2):
            raise ValueError(
                "Size must be multiple of 2 * group_size ({})".format(group_size)
            )

    def resize(self, size=None, group_size=None):
        if size is None:
            size = self.size
        if group_size is None:
            group_size = self.group_size
        self.check_size(size, group_size)
        self.size = size
        self.group_size = group_size

    @property
    def block_lengths(self):
        """The reference's block-sum pyramid sizes (scan.py:62-73)."""
        block_sizes = []
        size = round_up(
            _ceildiv(self.size, self.group_size * 2), self.group_size * 2
        )
        while size > self.group_size * 2:
            size = round_up(size, self.group_size * 2)
            block_sizes.append(size)
            size = _ceildiv(size, self.group_size * 2)
        block_sizes.append(next_power_of_2(size))
        return tuple(block_sizes)

    def prefix_sum(self, values):
        """Exclusive scan of a [size] array (in the reference this mutates the
        buffer in place, scan.py:75-112; here it returns the scanned array)."""
        values = jnp.asarray(values)
        if values.shape[0] != self.size:
            raise ValueError(
                "Expected {} values, got {}".format(self.size, values.shape[0])
            )
        return exclusive_scan(values)
