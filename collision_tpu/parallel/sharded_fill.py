"""Multi-device column engine: candidate-sharded run-expansion fill.

Shards the flagship fill pipeline (fill.py) over a mesh axis. The
decomposition is **replicated plan, sharded expansion**: every device
computes the same column sort + candidate runs (O(n log n), no
communication), and the flat candidate space — where the dominant
O(candidates) test/emission work lives — is split evenly across devices.
Pair slots stay globally consistent the same way the sharded BVH engine's
do (sharded.py): an ``all_gather`` of per-device survivor totals shifts
each device's local output positions, every device materializes its own
slice of the fixed-capacity buffer (0xFFFFFFFF elsewhere), and an
all-reduce-min merges them. Bit-identical to the single-device
``run_fill`` for any device count.

Collectives go through ``shard_map`` over an explicit ``Mesh``. Scaling
note: every device still repeats the sort (O(n log n)); only the
candidate space is split.
"""

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..collider import CollisionResult
from ..columns import _column_sort
from ..fill import (
    NO_PAIR, _S, _auto_strides, _candidate_runs, _run_of_consecutive,
)
from ..ops.offset import sorted_bucket_starts
from ..ops.scan import inclusive_scan
from ..ops.reduce import scene_bounds


def fill_sharded(coords, radii, capacity, gxy, cand_capacity, mesh,
                 axis="sp"):
    """Sharded run-expansion fill; result replicated.

    ``cand_capacity`` is rounded up so every device owns an equal,
    ``_S``-aligned candidate slice.
    """
    n_dev = mesh.shape[axis]
    quantum = _S * n_dev
    cand_capacity = -(-int(cand_capacity) // quantum) * quantum
    my_cand = cand_capacity // n_dev
    n = coords.shape[0]

    def device_fn(coords, radii):
        # Replicated phase (identical on every device).
        cs = _column_sort(coords, radii, gxy)
        run_w0, run_len, run_i = _candidate_runs(cs, gxy)
        nruns = run_len.shape[0]
        keep_ic = inclusive_scan((run_len > 0).astype(jnp.int32))
        n_kept = keep_ic[-1]
        total_cand = jnp.sum(run_len)
        fsum = jnp.sum(run_len.astype(jnp.float32))
        ok = (total_cand <= cand_capacity) \
            & (fsum < float(2 ** 31 - 2 ** 26))
        sel_r = sorted_bucket_starts(
            keep_ic, jnp.arange(nruns, dtype=jnp.int32) + 1,
            strides=_auto_strides(nruns))
        sel_r = jnp.minimum(sel_r, nruns - 1)
        live_r = jnp.arange(nruns, dtype=jnp.int32) < n_kept
        c_len = jnp.where(live_r, jnp.take(run_len, sel_r), 0)
        c_w0 = jnp.where(live_r, jnp.take(run_w0, sel_r), 0)
        c_i = jnp.where(live_r, jnp.take(run_i, sel_r), 0)
        c_ic = inclusive_scan(c_len)
        c_ex = c_ic - c_len

        axlo, axhi = cs.x_s - cs.r_s, cs.x_s + cs.r_s
        aylo, ayhi = cs.y_s - cs.r_s, cs.y_s + cs.r_s
        azlo, azhi = cs.z_s - cs.r_s, cs.z_s + cs.r_s

        # Sharded phase: this device's contiguous candidate slice.
        me = jax.lax.axis_index(axis)
        k0 = me.astype(jnp.int32) * my_cand
        k = k0 + jnp.arange(my_cand, dtype=jnp.int32)
        r = jnp.minimum(_run_of_consecutive(c_ic, k0, my_cand), nruns - 1)
        i = jnp.take(c_i, r)
        j = jnp.take(c_w0, r) + (k - jnp.take(c_ex, r))
        jc = jnp.clip(j, 0, n - 1)
        m = (jnp.take(axhi, i) > jnp.take(axlo, jc)) \
            & (jnp.take(axlo, i) < jnp.take(axhi, jc))
        m &= (jnp.take(ayhi, i) > jnp.take(aylo, jc)) \
            & (jnp.take(aylo, i) < jnp.take(ayhi, jc))
        m &= (jnp.take(azhi, i) > jnp.take(azlo, jc)) \
            & (jnp.take(azlo, i) < jnp.take(azhi, jc))
        m &= k < total_cand

        ic_local = inclusive_scan(m.astype(jnp.int32))
        local_total = ic_local[-1]
        totals = jax.lax.all_gather(local_total, axis)
        dev_base = jnp.sum(
            jnp.where(jnp.arange(n_dev) < me, totals, 0), dtype=jnp.int32)
        total = jnp.sum(totals, dtype=jnp.uint32)

        if capacity == 0:
            return total, jnp.zeros((0, 2), jnp.uint32), ok

        # This device answers output slots [dev_base, dev_base+local).
        q = jnp.arange(capacity, dtype=jnp.int32)
        ql = q - dev_base
        sel = sorted_bucket_starts(
            ic_local, ql + 1, strides=_auto_strides(my_cand))
        sel = jnp.minimum(sel, my_cand - 1)
        sel_k = k0 + sel
        rs = jnp.minimum(sorted_bucket_starts(
            c_ic, sel_k + 1, strides=_auto_strides(nruns)), nruns - 1)
        is_ = jnp.take(c_i, rs)
        js = jnp.clip(
            jnp.take(c_w0, rs) + (sel_k - jnp.take(c_ex, rs)), 0, n - 1)
        mine = (ql >= 0) & (ql < local_total) \
            & (q < jnp.minimum(total.astype(jnp.int32), capacity))
        pairs = jnp.where(
            mine[:, None],
            jnp.stack([jnp.take(cs.ids_s, is_), jnp.take(cs.ids_s, js)],
                      axis=1),
            jnp.uint32(NO_PAIR),
        )
        # Unwritten slots are uint32-max, so an all-reduce min is a union.
        pairs = jax.lax.pmin(pairs, axis)
        return total, pairs, ok

    shard = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    total, pairs, ok = shard(coords, radii)
    lo_s, hi_s = scene_bounds(coords)
    return CollisionResult(
        total, pairs if capacity else None, lo_s, hi_s, ok=ok)


def make_sharded_fill(mesh, capacity, gxy, cand_capacity, axis="sp"):
    """Jitted closure: step(coords, radii) -> replicated CollisionResult."""

    @jax.jit
    def step(coords, radii):
        return fill_sharded(
            coords, radii, capacity, gxy, cand_capacity, mesh, axis=axis)

    return step
