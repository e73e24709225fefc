"""Minimal benchmark harness (pytest-benchmark is not available here).

Mirrors the reference's pedantic-mode methodology
(/root/reference/tests/benchmarks: warmup rounds, explicit timed rounds).
Each timed call ends in ``jax.block_until_ready``, so the wall clock covers
the device work and not only its enqueue. Every row names the device it
ran on; a run that finds no GPU stops instead of timing the CPU.
"""

import json
import time

import numpy as np

#: When configured via :func:`set_jsonl`, every :func:`report` row is also
#: appended as one machine-readable JSON line.
_JSONL = {"path": None, "tags": {}}


def require_gpu():
    """The devices JAX found, as {"platform", "kind", "count"}; raises
    SystemExit when they are not GPUs."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu":
        raise SystemExit(
            "benchmark needs a GPU; JAX found platform {!r}".format(
                info["platform"]))
    return info


def set_jsonl(path, **tags):
    """Mirror all subsequent report() rows to ``path`` as JSON lines,
    each tagged with ``tags``."""
    _JSONL["path"] = path
    _JSONL["tags"] = dict(tags)


def bench(fn, *args, rounds=10, warmup=3):
    """Wall-clock milliseconds per call of ``fn(*args)``, each call
    waited for with ``block_until_ready``."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(rounds):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t) * 1e3)
    times = np.array(times)
    return {
        "min_ms": float(times.min()),
        "median_ms": float(np.median(times)),
        "mean_ms": float(times.mean()),
        "rounds": rounds,
    }


def report(name, stats, device, extra=""):
    """Print one row (and mirror it to the JSONL file, if set)."""
    if _JSONL["path"]:
        row = {"name": name, "device": device}
        row.update(_JSONL["tags"])
        row.update(stats)
        if extra:
            row["extra"] = extra
        with open(_JSONL["path"], "a") as f:
            f.write(json.dumps(row) + "\n")
    print(
        "{:<44s} min {:>9.3f} ms   median {:>9.3f} ms   [{} {} x{}] {}"
        .format(name, stats["min_ms"], stats["median_ms"],
                device["platform"], device["kind"], device["count"], extra),
        flush=True,
    )
