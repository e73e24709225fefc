"""Run-expansion pair enumeration: scatter-free fill at any capacity.

The reference enumerates pairs by writing each hit through a global atomic
cursor into a device buffer bounded only by memory
(/root/reference/collision/collision.cl:202-215). Here pair enumeration is a
**feed-forward dense pipeline** of sorts, cumulative sums and gathers — no
scatter, no atomics — bounded only by device memory, working at input
precision (float32 or float64), and deterministic in its output order.

Pipeline (all inside one jit):
  1. Column sort (columns._column_sort): spheres sorted by
     ``column_id << zbits | quantize(z)`` — each xy-column is a z-sorted
     contiguous run.
  2. Per-sphere candidate **runs**: for each sorted sphere i and each of
     the 5 half-stencil column offsets, the conservative z-window of
     possible partners (|z_i - z_j| < r_i + r_max is necessary for
     overlap) is one ``searchsorted`` range in the sorted key array —
     batched into a single hierarchical lookup (ops/offset.py). Runs are
     exact supersets; the self-offset run starts at i+1 (the j > i dedup,
     the analog of the reference's right_edge rule, collision.cl:198-200).
  3. Zero-length runs are compacted away; an inclusive scan of run
     lengths lays all candidates out in one flat deterministic order
     (sorted-sphere-major, offset-minor, ascending j).
  4. Candidate pass (chunked ``lax.scan``): for every candidate slot,
     recover its run via a consecutive-query lookup (each kept run
     consumes >= 1 slot, so a strided coarse search plus an S-wide refine
     window is exact), gather both spheres' AABBs, apply the exact strict
     overlap test -> survivor bitmask.
  5. Count-then-fill without a cursor: a two-level cumulative sum of the
     survivor mask assigns each surviving candidate its output slot; the
     pair buffer is built by the **inverse** lookup (output slot ->
     candidate index, another hierarchical searchsorted) followed by pure
     gathers of the two original sphere ids.

Contract parity (SURVEY §3.1): exact unordered unique pairs of original
ids under strict AABB overlap; the returned total is the true count even
past ``capacity`` while only the first ``capacity`` pairs are
materialized, in deterministic order; unfilled slots hold 0xFFFFFFFF.

The only scene-dependent knob is ``cand_capacity`` (static upper bound on
conservative candidates). Overflow is *detected* (``ok=False``, with the
exact requirement returned for the host retry) — never a silent wrong
answer, mirroring the reference's count-past-capacity retry contract.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .columns import COLUMN_OFFSETS, _column_sort, _quantize, _zbits
from .ops.offset import sorted_bucket_starts
from .ops.scan import inclusive_scan

NO_PAIR = np.uint32(0xFFFFFFFF)

#: Refine width of the consecutive-query run lookup (coarse search every
#: S-th candidate; exact because every kept run covers >= 1 candidate).
_S = 8


def _auto_strides(table_len):
    """Stride pyramid keeping every dense top-level compare small."""
    strides = [64]
    r = -(-table_len // 64)
    while r > 256:
        strides.append(128)
        r = -(-r // 128)
    return tuple(strides)


def _run_of_consecutive(ic, k0, m):
    """Run index for the m consecutive candidates starting at k0.

    ``ic`` is the inclusive cumsum of kept (length >= 1) run lengths,
    padded past the last run with the total. The run of candidate k is
    the first r with ic[r] > k; for a block of S consecutive candidates
    those runs all lie within S entries of the first — one hierarchical
    lookup per S queries plus an S-wide gathered refine window.
    """
    nseg = m // _S
    q0 = k0 + jnp.arange(nseg, dtype=jnp.int32) * _S
    r0 = sorted_bucket_starts(ic, q0 + 1, strides=_auto_strides(ic.shape[0]))
    win = jnp.take(ic, r0[:, None] + jnp.arange(_S)[None, :], axis=0)
    kseg = q0[:, None] + jnp.arange(_S, dtype=jnp.int32)[None, :]
    radd = jnp.sum(
        win[:, None, :] <= kseg[:, :, None], axis=-1, dtype=jnp.int32)
    return (r0[:, None] + radd).reshape(m)


def _candidate_runs(cs, gxy):
    """Per-sphere conservative z-window runs, 5 half-stencil offsets each.

    Returns (run_w0, run_len, run_i), each [5n] in candidate order:
    sorted-sphere-major, offset-minor, ascending j.
    """
    n = cs.key_s.shape[0]
    zbits = _zbits(gxy)
    zmax = (1 << zbits) - 1
    col_s = (cs.key_s >> zbits).astype(jnp.int32)
    cx = col_s // gxy
    cy = col_s % gxy
    half = cs.r_s + cs.r_max  # |z_i - z_j| < r_i + r_max is necessary
    qlo = _quantize(cs.z_s - half, cs.lo_s[2], cs.zscale, zmax)
    qhi = _quantize(cs.z_s + half, cs.lo_s[2], cs.zscale, zmax)

    keys_q, valid = [], []
    for (dx, dy) in COLUMN_OFFSETS:
        xb = cx + dx
        yb = cy + dy
        okc = (yb >= 0) & (yb < gxy) & (xb < gxy)
        cb = (xb * gxy + jnp.clip(yb, 0, gxy - 1)).astype(jnp.uint32)
        keys_q.append((cb << zbits) + qlo)
        keys_q.append((cb << zbits) + qhi + 1)
        valid.append(okc)
    pos = sorted_bucket_starts(
        cs.key_s, jnp.stack(keys_q).reshape(-1),
        strides=_auto_strides(n),
    ).reshape(5, 2, n)

    i_idx = jnp.arange(n, dtype=jnp.int32)
    w0s, lens = [], []
    for off in range(5):
        w0 = pos[off, 0]
        wend = pos[off, 1]
        if COLUMN_OFFSETS[off] == (0, 0):
            w0 = jnp.maximum(w0, i_idx + 1)  # j > i dedup in own column
        w0 = jnp.where(valid[off], w0, 0)
        wlen = jnp.where(valid[off], jnp.maximum(wend - w0, 0), 0)
        w0s.append(w0)
        lens.append(wlen)
    run_w0 = jnp.stack(w0s, axis=1).reshape(-1)    # [5n]
    run_len = jnp.stack(lens, axis=1).reshape(-1)  # [5n]
    run_i = jnp.repeat(i_idx, 5)
    return run_w0, run_len, run_i


@partial(jax.jit, static_argnames=("gxy",))
def candidate_count(coords, radii, gxy):
    """Exact conservative-candidate total as float32 (overflow-proof).

    The host uses this to size ``cand_capacity`` in one shot after an
    ``ok=False`` fill (XLA's tree-reduced f32 sum is accurate to ~2^-20
    relative — exact enough to size a buffer with a small margin).
    """
    cs = _column_sort(coords, radii, gxy)
    _, run_len, _ = _candidate_runs(cs, gxy)
    return jnp.sum(run_len.astype(jnp.float32))


@partial(jax.jit, static_argnames=("capacity", "gxy", "cand_capacity",
                                   "chunk"))
def _run_fill(coords, radii, capacity, gxy, cand_capacity, chunk):
    n = coords.shape[0]
    cs = _column_sort(coords, radii, gxy)
    ids_s = cs.ids_s

    # Sorted AABB component arrays (input precision).
    axlo = cs.x_s - cs.r_s
    axhi = cs.x_s + cs.r_s
    aylo = cs.y_s - cs.r_s
    ayhi = cs.y_s + cs.r_s
    azlo = cs.z_s - cs.r_s
    azhi = cs.z_s + cs.r_s

    run_w0, run_len, run_i = _candidate_runs(cs, gxy)

    # --- compact away zero-length runs (the consecutive-query lookup
    # requires every kept run to cover >= 1 candidate) ---
    nruns = run_len.shape[0]
    keep = run_len > 0
    keep_ic = inclusive_scan(keep.astype(jnp.int32))
    n_kept = keep_ic[-1]
    total_cand = jnp.sum(run_len)
    # Guard the int32 candidate arithmetic itself: XLA's tree reduction
    # makes the f32 sum accurate to ~2^-20 relative, so a margined
    # threshold below 2^31 is a sound overflow detector (a clustered
    # scene can have ~n^2 conservative candidates).
    fsum = jnp.sum(run_len.astype(jnp.float32))
    ok = (total_cand <= cand_capacity) & (fsum < float(2 ** 31 - 2 ** 26))
    sel_r = sorted_bucket_starts(
        keep_ic, jnp.arange(nruns, dtype=jnp.int32) + 1,
        strides=_auto_strides(nruns))
    sel_r = jnp.minimum(sel_r, nruns - 1)
    live_r = jnp.arange(nruns, dtype=jnp.int32) < n_kept
    c_len = jnp.where(live_r, jnp.take(run_len, sel_r), 0)
    c_w0 = jnp.where(live_r, jnp.take(run_w0, sel_r), 0)
    c_i = jnp.where(live_r, jnp.take(run_i, sel_r), 0)
    c_ic = inclusive_scan(c_len)                    # pad tail == total_cand
    c_ex = c_ic - c_len

    # --- candidate pass: survivor bitmask, chunked ---
    nch = -(-cand_capacity // chunk)

    def chunk_mask(c, _):
        k0 = c * chunk
        k = k0 + jnp.arange(chunk, dtype=jnp.int32)
        r = _run_of_consecutive(c_ic, k0, chunk)
        r = jnp.minimum(r, nruns - 1)
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
        return c + 1, m.astype(jnp.int8)

    _, mask = jax.lax.scan(
        chunk_mask, jnp.int32(0), None, length=nch)
    mask = mask.reshape(-1)[:cand_capacity]

    ic_mask = inclusive_scan(mask.astype(jnp.int32))
    total = ic_mask[-1]

    if capacity == 0:
        return None, total.astype(jnp.uint32), ok

    # --- output slot -> candidate index -> (i, j) -> original ids ---
    q = jnp.arange(capacity, dtype=jnp.int32)
    sel_c = sorted_bucket_starts(
        ic_mask, q + 1, strides=_auto_strides(cand_capacity))
    sel_c = jnp.minimum(sel_c, cand_capacity - 1)
    r = sorted_bucket_starts(
        c_ic, sel_c + 1, strides=_auto_strides(nruns))
    r = jnp.minimum(r, nruns - 1)
    i = jnp.take(c_i, r)
    j = jnp.clip(jnp.take(c_w0, r) + (sel_c - jnp.take(c_ex, r)), 0, n - 1)
    ida = jnp.take(ids_s, i)
    idb = jnp.take(ids_s, j)
    live = q < jnp.minimum(total, capacity)
    pairs = jnp.where(
        live[:, None],
        jnp.stack([ida, idb], axis=1),
        jnp.uint32(NO_PAIR),
    )
    return pairs, total.astype(jnp.uint32), ok


def run_fill(coords, radii, capacity, gxy, cand_capacity, chunk=1 << 20):
    """Enumerate colliding pairs into a ``capacity``-slot buffer.

    Args:
      coords: [n, 3] float32/float64 centers.
      radii:  [n] radii (same dtype).
      capacity: static pair-buffer capacity (0 = count-only).
      gxy: static columns per xy axis (see columns.default_column_config).
      cand_capacity: static bound on conservative candidates; when the
        scene needs more, ``ok`` comes back False and the result is a
        (correct-prefix) underestimate — retry with a larger bound.
      chunk: static candidate-pass chunk length.

    Returns:
      (pairs[capacity, 2] uint32 or None, total uint32, ok bool).
    """
    chunk = int(min(chunk, max(_S, -(-cand_capacity // _S) * _S)))
    chunk = -(-chunk // _S) * _S
    cand_capacity = -(-cand_capacity // chunk) * chunk
    return _run_fill(coords, radii, int(capacity), int(gxy),
                     int(cand_capacity), chunk)
