"""Key / key-value sort.

Equivalent of the reference's LSD radix sort
(/root/reference/collision/radix.py + radix.cl). The reference hand-rolls a
multi-pass block-sort + histogram-scan + scatter because OpenCL has no sort
primitive; XLA ships a fast stable sort (``lax.sort``), so the functional core
delegates to it.

``RadixSorter`` preserves the reference's full validation surface —
power-of-two group_size, size % (2*group_size) == 0, radix_bits dividing the
key width, 2**radix_bits <= 2*group_size (radix.py:61-74) — and its derived
quantities ``num_passes`` (radix.py:109-111) and ``histogram_len``
(radix.py:113-116), both pinned by reference goldens. Payload values of any
scalar or vector dtype are supported, including 3-vectors stored padded to 4
slots (radix.py:122-126).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import next_power_of_2, round_up

_UNSIGNED = {np.dtype(d) for d in ("uint8", "uint16", "uint32", "uint64")}


def sort_keys(keys, size=None):
    """Stable ascending sort of unsigned keys.

    If ``size`` is given, only the leading ``size`` entries participate and
    trailing entries sort last (the reference pads with the key dtype's max,
    collision.py:138-142).
    """
    keys = jnp.asarray(keys)
    if size is not None and size != keys.shape[0]:
        n = keys.shape[0]
        pad_key = jnp.asarray(np.iinfo(keys.dtype).max, keys.dtype)
        keys = jnp.where(jnp.arange(n) < size, keys, pad_key)
    return jax.lax.sort(keys, is_stable=True)


def sort_key_value(keys, values, size=None):
    """Stable key/value sort; returns (sorted_keys, permuted_values).

    Stability matches the reference contract (verified against
    np.argsort(kind='mergesort'), reference tests/test_radix_py.py:201).
    """
    keys = jnp.asarray(keys)
    values = jnp.asarray(values)
    if size is not None and size != keys.shape[0]:
        n = keys.shape[0]
        pad_key = jnp.asarray(np.iinfo(keys.dtype).max, keys.dtype)
        keys = jnp.where(jnp.arange(n) < size, keys, pad_key)
    if values.ndim == 1:
        return jax.lax.sort_key_val(keys, values, is_stable=True)
    # Vector payloads: sort a permutation, then gather — one stable sort of
    # (key, index) followed by a single gather of the payload rows.
    idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    sorted_keys, order = jax.lax.sort_key_val(keys, idx, is_stable=True)
    return sorted_keys, jnp.take(values, order, axis=0)


def argsort_keys(keys, size=None):
    """Stable (sorted_keys, order) — the pipeline's code/id sort."""
    keys = jnp.asarray(keys)
    idx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
    return sort_key_value(keys, idx, size=size)


class RadixSorter:
    """API-parity sorter with the reference's constraints (radix.py:27-170)."""

    histogram_dtype = np.dtype("uint32")

    def __init__(self, size, group_size, radix_bits=4,
                 key_dtype=np.dtype("uint32"), value_dtype=np.dtype("uint32")):
        key_dtype = np.dtype(key_dtype)
        value_dtype = np.dtype(value_dtype)
        if key_dtype not in _UNSIGNED:
            raise ValueError("Invalid key dtype: {}".format(key_dtype))
        self.check_size(size, group_size, radix_bits, key_dtype)
        self.size = size
        self.group_size = group_size
        self.radix_bits = radix_bits
        self.key_dtype = key_dtype
        self.value_dtype = value_dtype

    @staticmethod
    def check_size(size, group_size, radix_bits, key_dtype):
        key_dtype = np.dtype(key_dtype)
        if group_size != next_power_of_2(group_size):
            raise ValueError(
                "Group size ({}) must be a power of two".format(group_size)
            )
        if size % (group_size * 2):
            raise ValueError(
                "Size ({}) must be multiple of 2 * group_size ({})".format(
                    size, group_size
                )
            )
        if (key_dtype.itemsize * 8) % radix_bits:
            raise ValueError(
                "Radix bits ({}) must evenly divide item-size ({})".format(
                    radix_bits, key_dtype.itemsize * 8
                )
            )
        if (2 ** radix_bits) > group_size * 2:
            raise ValueError(
                "2 ^ radix_bits ({}) must be less than 2 * group_size ({})".format(
                    2 ** radix_bits, group_size * 2
                )
            )

    def resize(self, size=None, group_size=None, radix_bits=None):
        if size is None:
            size = self.size
        if group_size is None:
            group_size = self.group_size
        if radix_bits is None:
            radix_bits = self.radix_bits
        self.check_size(size, group_size, radix_bits, self.key_dtype)
        self.size = size
        self.group_size = group_size
        self.radix_bits = radix_bits

    @property
    def num_passes(self):
        """Passes an LSD radix sort of this key width would need
        (reference radix.py:109-111; goldens tests/test_radix_py.py:68-80)."""
        return (self.key_dtype.itemsize * 8) // self.radix_bits

    @property
    def histogram_len(self):
        """[bucket][group] histogram length, rounded for the scanner
        (reference radix.py:113-116)."""
        length = (2 ** self.radix_bits) * self.size // 2 // self.group_size
        return round_up(length, 2 * self.group_size)

    def sort(self, keys, values=None):
        """Stable sort; returns sorted keys, or (keys, values) if values given."""
        keys = jnp.asarray(keys)
        if keys.shape[0] != self.size:
            raise ValueError(
                "Expected {} keys, got {}".format(self.size, keys.shape[0])
            )
        if values is None:
            return sort_keys(keys)
        return sort_key_value(keys, values)
