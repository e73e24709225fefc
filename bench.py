"""Benchmark: one full broad-phase step, count-only, on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device"}. The scene is
1M uniform spheres (seed 4, r ~ U(0, 1/sqrt(n))) through the public
``collide``; the step must be exact (``ok``) before it is timed. The value
is the median wall-clock per step, each step waited for with
``block_until_ready``. The run stops when JAX finds no GPU.

Env overrides: BENCH_N (default 1_000_000), BENCH_ROUNDS (default 20).
"""

import json
import os

import numpy as np


def main():
    from collision_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    import jax.numpy as jnp

    from benchmarks.harness import bench, require_gpu
    from collision_tpu import collide

    device = require_gpu()
    n = int(os.environ.get("BENCH_N", 1_000_000))
    rounds = int(os.environ.get("BENCH_ROUNDS", 20))

    rng = np.random.RandomState(4)
    coords = jnp.asarray(rng.random((n, 3)).astype("float32"))
    radii = jnp.asarray(rng.uniform(0, 1 / n ** 0.5, n).astype("float32"))

    res = collide(coords, radii, 0)
    if not bool(res.ok):
        raise SystemExit("count at default knobs not exact (ok=False)")
    stats = bench(lambda c, r: collide(c, r, 0), coords, radii,
                  rounds=rounds)

    print(json.dumps({
        "metric": "broadphase_step_ms_n{}".format(n),
        "value": stats["median_ms"],
        "unit": "ms/step",
        "device": device,
    }))


if __name__ == "__main__":
    main()
