"""Gather / scatter by index.

Equivalent of the reference's index kernels
(/root/reference/collision/index.cl:1-13 + index.py): ``gather`` computes
``out[i] = in[idx[i]]`` and ``scatter`` computes ``out[idx[i]] = in[i]``.
These are single XLA gather/scatter HLOs; the class exists for API
parity (applying a sort permutation to payload arrays).
"""

import jax.numpy as jnp
import numpy as np

_UNSIGNED = {np.dtype(d) for d in ("uint8", "uint16", "uint32", "uint64")}


def gather(values, indices):
    """out[i] = values[indices[i]] (reference index.cl:1-6)."""
    return jnp.take(jnp.asarray(values), jnp.asarray(indices), axis=0)


def scatter(values, indices, out=None, size=None):
    """out[indices[i]] = values[i] (reference index.cl:8-13).

    Args:
      values: [n, ...] source values.
      indices: [n] destination indices.
      out: optional existing destination to functionally update; if None, a
        zero-initialized array of shape [size or n, ...] is used.
    """
    values = jnp.asarray(values)
    indices = jnp.asarray(indices)
    if out is None:
        n_out = size if size is not None else values.shape[0]
        out = jnp.zeros((n_out,) + values.shape[1:], values.dtype)
    return out.at[indices].set(values)


class Indexer:
    """API-parity wrapper over gather/scatter (reference index.py:23-55)."""

    def __init__(self, value_dtype=np.dtype("uint32"), index_dtype=np.dtype("uint32")):
        self.value_dtype = np.dtype(value_dtype)
        self.index_dtype = np.dtype(index_dtype)
        if self.index_dtype not in _UNSIGNED:
            raise ValueError("Invalid index dtype: {}".format(self.index_dtype))

    def gather(self, values, indices):
        return gather(values, indices)

    def scatter(self, values, indices, out=None, size=None):
        return scatter(values, indices, out=out, size=size)
