"""Multi-device broad-phase over a JAX mesh.

The reference is strictly single-device (SURVEY.md §2: one OpenCL context,
one queue); this module is the scaling seam it never had. The decomposition
is **replicated build, sharded traversal**: every device computes the same
sort → LBVH build → refit (cheap, O(n log n) on-chip, no communication), and
the query leaves — where the dominant, data-dependent traversal work lives —
are split evenly across the mesh axis. Pair slots stay globally consistent:
each device's exclusive-scan offsets are shifted by a ``psum``-style prefix
of the per-device totals, every device scatters its pairs into its own copy
of the fixed-capacity buffer, and an all-reduce-min merges them (unwritten
slots are 0xFFFFFFFF, so ``min`` is the union). The result is bit-identical
to the single-device pipeline for any device count.

Collectives go through ``shard_map`` over an explicit ``Mesh``; XLA lowers
them to NCCL on GPUs.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..collider import CollisionResult
from ..lbvh.build import build, NO_NODE
from ..lbvh.refit import leaf_bounds, refit
from ..lbvh.traverse import STACK_DEPTH, traverse_count, traverse_fill
from ..ops.morton import morton_encode
from ..ops.reduce import scene_bounds
from ..ops.scan import exclusive_scan
from ..ops.sort import argsort_keys


def collide_sharded(coords, radii, capacity, mesh, axis="sp",
                    stack_depth=STACK_DEPTH):
    """One broad-phase step sharded over ``mesh``'s ``axis``.

    Args:
      coords: [n, 3] centers, n divisible by the axis size.
      radii: [n] radii.
      capacity: static pair-buffer capacity (0 = count-only).
      mesh: a ``jax.sharding.Mesh`` containing ``axis``.
      axis: mesh axis name to shard query leaves over.

    Returns:
      :class:`CollisionResult` (replicated), identical to the
      single-device ``collide``.
    """
    n = coords.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(
            "Size ({}) must be divisible by the '{}' axis size ({})".format(
                n, axis, n_dev
            )
        )
    chunk = n // n_dev

    def device_fn(coords, radii):
        # Replicated phase: identical on every device, no communication.
        lo_s, hi_s = scene_bounds(coords)
        codes = morton_encode(coords, lo_s, hi_s)
        codes_sorted, ids_sorted = argsort_keys(codes)
        tree = build(codes_sorted, ids_sorted)
        llo, lhi = leaf_bounds(coords, radii, tree.leaf_id)
        lo, hi = refit(tree, llo, lhi)

        # Sharded phase: this device traverses its contiguous query slice.
        me = jax.lax.axis_index(axis)
        queries = me.astype(jnp.uint32) * chunk + jnp.arange(
            chunk, dtype=jnp.uint32
        )
        counts = traverse_count(
            tree, lo, hi, stack_depth=stack_depth, queries=queries
        )
        local_total = jnp.sum(counts, dtype=jnp.uint32)

        # Global offsets: prefix of earlier devices' totals + local scan.
        totals = jax.lax.all_gather(local_total, axis)
        dev_base = jnp.sum(
            jnp.where(jnp.arange(n_dev) < me, totals, 0), dtype=jnp.uint32
        )
        offsets = dev_base + exclusive_scan(counts)
        total = jnp.sum(totals, dtype=jnp.uint32)

        if capacity == 0:
            return total, jnp.zeros((0, 2), jnp.uint32)

        local_pairs = traverse_fill(
            tree, lo, hi, offsets, capacity,
            stack_depth=stack_depth, queries=queries,
        )
        # Unwritten slots are uint32-max, so an all-reduce min is a union.
        pairs = jax.lax.pmin(local_pairs, axis)
        return total, pairs

    shard = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    total, pairs = shard(coords, radii)
    lo_s, hi_s = scene_bounds(coords)
    return CollisionResult(
        total, pairs if capacity else None, lo_s, hi_s
    )


def make_sharded_collider(mesh, capacity, axis="sp", stack_depth=STACK_DEPTH):
    """Jitted closure over (mesh, capacity): step(coords, radii) -> result."""

    @jax.jit
    def step(coords, radii):
        return collide_sharded(
            coords, radii, capacity, mesh, axis=axis, stack_depth=stack_depth
        )

    return step
