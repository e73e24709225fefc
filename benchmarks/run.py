"""Benchmark suite at the reference's pinned workload shapes.

Reference shapes (SURVEY.md §6): scan at 307200/1536000/3072000, radix sort
at 307200 keys over three distributions (+ payload variants), bounds
reduction at 1536000/3072000 ×f32x3, find_offsets over 2^21 sorted values,
and the full collide pipeline count-only at 307200/307201 spheres — plus the
1M-sphere scene. Run on a GPU: ``python -m benchmarks.run [--quick]``.

Every row is wall-clock per call ending in ``block_until_ready``
(benchmarks/harness.bench) and names the device it ran on.
"""

import argparse
import sys

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="fewer/smaller configs")
    parser.add_argument("--jsonl", default=None,
                        help="also append machine-readable rows to this "
                             "JSON-lines file")
    parser.add_argument("--tag", action="append", default=[],
                        help="key=value tag for every JSONL row")
    args = parser.parse_args()

    from collision_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    import jax.numpy as jnp

    from collision_tpu import (
        Collider, exclusive_scan, find_offsets, scene_bounds,
        sort_key_value, sort_keys,
    )
    from .harness import bench, report, require_gpu, set_jsonl

    device = require_gpu()
    if args.jsonl:
        set_jsonl(args.jsonl, **dict(t.split("=", 1) for t in args.tag))

    rng = np.random.RandomState(4)
    print("device:", device, file=sys.stderr)

    # --- exclusive prefix scan (reference benchmarks/test_scan.py) ---
    scan_sizes = [307200] if args.quick else [307200, 1536000, 3072000]
    for n in scan_sizes:
        values = jnp.asarray(rng.randint(0, 3, n).astype("uint32"))
        report("scan n={}".format(n), bench(exclusive_scan, values), device)

    # --- radix sort (reference benchmarks/test_radix.py) ---
    n = 307200
    dists = {
        "randint-1000": rng.randint(0, 1000, n).astype("uint32"),
        "randint-n": rng.randint(0, n, n).astype("uint32"),
        "arange": np.arange(n, dtype="uint32"),
    }
    for name, keys in dists.items():
        report("sort n={} {}".format(n, name),
               bench(sort_keys, jnp.asarray(keys)), device)

    keys = jnp.asarray(dists["randint-n"])
    for vname, values in {
        "u32": rng.randint(0, n, n).astype("uint32"),
        "f32x4": rng.random((n, 4)).astype("float32"),
    }.items():
        report("sort+values n={} {}".format(n, vname),
               bench(sort_key_value, keys, jnp.asarray(values)), device)

    # --- bounds reduction (reference benchmarks/test_bounds.py) ---
    bounds_sizes = [1536000] if args.quick else [1536000, 3072000]
    for n in bounds_sizes:
        coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
        report("bounds n={}".format(n), bench(scene_bounds, coords), device)

    # --- find_offsets (reference benchmarks/test_offset.py) ---
    n = 2 ** 21
    for maxval in (2000, 2000000):
        values = jnp.asarray(
            np.sort(rng.randint(0, maxval, n)).astype("uint32"))
        report("find_offsets n=2^21 maxval={}".format(maxval),
               bench(find_offsets, values, maxval + 2), device)

    # --- full collide pipeline, count-only, through the Collider ---
    collide_sizes = [65536] if args.quick else [307200, 307201, 1000000]
    for n in collide_sizes:
        coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
        radii = jnp.asarray(
            rng.uniform(0, 0.06 if n <= 307201 else 1 / n ** 0.5, n)
            .astype("float32")
        )
        collider = Collider(n)
        stats = bench(
            lambda c, r: collider.get_collisions(c, r, 0, collisions=None),
            coords, radii, rounds=3, warmup=1)
        count = int(collider.get_collisions(coords, radii, 0,
                                            collisions=None))
        report("collide count-only n={}".format(n), stats, device,
               extra="(count={}, rung={})".format(count, collider.last_rung))


if __name__ == "__main__":
    main()
