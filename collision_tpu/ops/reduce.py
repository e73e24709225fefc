"""N-ary tree reductions: generic Reducer plus Bounds (min/max) and Summer.

Re-design of the reference's templated reduction
(/root/reference/collision/reduce.py + reduce.cl, bounds.py, summer.py). The
reference renders a Jinja2 accumulator spec into an OpenCL kernel with a
grid-stride stage-1 and a single-group stage-2; in XLA a reduction is a single
fused XLA op, so the accumulator spec becomes a list of (init, combine)
pairs applied with ``jnp`` reductions. ``ngroups``/``group_size`` are kept as
validated constructor parameters purely for API parity — XLA picks its own
tiling.
"""

import jax.numpy as jnp
import numpy as np

_COMBINERS = {
    "min": jnp.minimum,
    "max": jnp.maximum,
    "add": jnp.add,
}

_REDUCERS = {
    "min": jnp.min,
    "max": jnp.max,
    "add": jnp.sum,
}


def reduce_values(values, accumulators, size=None):
    """Reduce ``values`` ([n, ...]) along axis 0 once per accumulator.

    Args:
      values: [n, ...] array.
      accumulators: sequence of (init, combine) pairs; combine is one of
        "min"/"max"/"add" (the reference's accumulator vocabulary,
        reduce.cl:3 + bounds.py:5 + summer.py:5). ``init`` is the identity
        and is what an empty reduction returns.
      size: optional count of leading valid rows; rows past ``size`` are
        masked to the identity (the reference's grid-stride loop reads
        exactly ``size`` values, reduce.cl:13).

    Returns:
      [len(accumulators), ...] stacked results.
    """
    values = jnp.asarray(values)
    outs = []
    for init, combine in accumulators:
        combine = combine.lower()
        if combine not in _REDUCERS:
            raise ValueError("Unknown combine function: {}".format(combine))
        v = values
        if size is not None:
            n = values.shape[0]
            mask = jnp.arange(n) < size
            mask = mask.reshape((n,) + (1,) * (values.ndim - 1))
            v = jnp.where(mask, values, jnp.asarray(init, values.dtype))
        outs.append(_REDUCERS[combine](v, axis=0))
    return jnp.stack(outs, axis=0)


class Reducer:
    """Stateful wrapper matching the reference Reducer API (reduce.py:24-76).

    Subclasses define ``accumulator`` as a list of (init, combine-name) pairs.
    """

    accumulator = None

    def __init__(self, ngroups, group_size, value_dtype=np.dtype("float32")):
        if self.accumulator is None:
            raise TypeError("Reducer subclasses must define an accumulator spec")
        self.value_dtype = np.dtype(value_dtype)
        self.ngroups = ngroups
        self.group_size = group_size

    def resize(self, ngroups=None, group_size=None):
        """Update launch-geometry parameters (no buffers to reallocate).

        Unlike the reference (reduce.py:45-60, which forgets to reallocate when
        only ngroups grows — a latent bug noted in SURVEY.md §4), resize here
        is always safe: there is no partials buffer.
        """
        if ngroups is not None:
            self.ngroups = ngroups
        if group_size is not None:
            self.group_size = group_size

    def reduce(self, values, size=None):
        """Reduce [n, ...] values -> [n_accumulators, ...]."""
        return reduce_values(values, self.accumulator, size=size)


class Bounds(Reducer):
    """Componentwise (min, max) AABB of all values (reference bounds.py:4-15)."""

    accumulator = [(np.inf, "min"), (-np.inf, "max")]

    def __init__(self, ngroups, group_size, coord_dtype=np.dtype(("float32", 3))):
        super().__init__(ngroups, group_size, value_dtype=coord_dtype)


class Summer(Reducer):
    """Vector sum (reference summer.py:4-8)."""

    accumulator = [(0, "add")]


def scene_bounds(coords, size=None):
    """(min, max) over [n, 3] coords — the pipeline's scene-AABB reduction.

    Functional form used inside the jitted collide step; equivalent to
    ``Bounds(...).reduce(coords)`` (reference collision.py:157-159).
    """
    coords = jnp.asarray(coords)
    if size is None:
        return jnp.min(coords, axis=0), jnp.max(coords, axis=0)
    n = coords.shape[0]
    mask = (jnp.arange(n) < size)[:, None]
    lo = jnp.min(jnp.where(mask, coords, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(mask, coords, -jnp.inf), axis=0)
    return lo, hi
