"""Smoke test of the broad phase on the GPU, at the sizes users run.

Drives the public entry points — ``collide``, ``collide_exact``,
``Collider.get_collisions`` and ``simulate`` — on 1M uniform spheres, the
reference's dense 307,200-sphere scene and 1M mixed radii, and checks every
answer exactly: against the independent engines (LBVH, grid stencil), a
blocked O(N^2) oracle, and a numpy Morton reference. Every comparison is
integer or set equality.

    python chip_smoke.py          # one GPU: phases A-G
    python chip_smoke.py --four   # four GPUs: the sharded paths only

It exits non-zero, printing no result, when JAX finds no GPU or when
``collision_tpu`` is not beside this file. Any failed check raises. On
success the last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Compile and warm-run seconds, memory analyses and peak device bytes are
printed on earlier lines as findings, not benchmark numbers.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: Pair capacity of the fill phases.
CAPACITY = 16384

#: Scene sizes: the bench.py scene, the blocked-oracle scene, the
#: reference's dense scene and the mixed-radius scene.
N_UNIFORM = 1_000_000
N_BLOCKED = 65536
N_DENSE = 307200
N_POWERLAW = 1_000_000

NO_PAIR = 0xFFFFFFFF


class SmokeError(Exception):
    """A check failed: the smoke run is not ok."""


def check(cond, what):
    if not cond:
        raise SmokeError(what)


def check_equal(what, got, want):
    if int(got) != int(want):
        raise SmokeError("{}: got {}, want {}".format(what, int(got),
                                                     int(want)))


# ---- scenes (host numpy, deterministic from the seed) ----

def uniform_scene(n, seed=4):
    """The bench.py scene: centers in the unit cube, r ~ U(0, 1/sqrt(n))."""
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 1 / n ** 0.5, n).astype("float32")
    return coords, radii


def dense_scene(n=N_DENSE, seed=4):
    """The reference benchmark's dense scene: r ~ U(0, 0.06)."""
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    radii = rng.uniform(0, 0.06, n).astype("float32")
    return coords, radii


def powerlaw_scene(n=N_POWERLAW, seed=4):
    """Mixed radii: r = (pareto(2.5) + 0.2) / sqrt(n), clipped at 0.05."""
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype("float32")
    r = (1.0 / n ** 0.5) * (rng.pareto(2.5, n) + 0.2)
    radii = np.clip(r, 0, 0.05).astype("float32")
    return coords, radii


# ---- host-side checks ----

def check_pairs(what, pairs, count, capacity, coords, radii):
    """The first min(count, capacity) slots hold unique real pairs whose
    AABBs strictly overlap; every slot after them is empty."""
    pairs = np.asarray(pairs)
    check(pairs.shape == (capacity, 2), "{}: pair buffer shape {}".format(
        what, pairs.shape))
    k = min(int(count), capacity)
    p = pairs[:k].astype(np.int64)
    check((pairs[k:] == NO_PAIR).all(), what + ": slots past the count")
    n = len(coords)
    check(((p >= 0) & (p < n)).all(), what + ": pair id out of range")
    a, b = p.min(axis=1), p.max(axis=1)
    check((a != b).all(), what + ": self pair")
    check(len(np.unique(a * n + b)) == k, what + ": duplicate pair")
    lo = coords - radii[:, None]
    hi = coords + radii[:, None]
    ov = ((hi[a] > lo[b]) & (lo[a] < hi[b])).all(axis=1)
    check(ov.all(), "{}: {} pairs do not overlap".format(what,
                                                        int((~ov).sum())))


def pair_keys(pairs, count, n):
    """Sorted int64 keys min*n + max of the first ``count`` pairs."""
    p = np.asarray(pairs)[:int(count)].astype(np.int64)
    return np.sort(p.min(axis=1) * n + p.max(axis=1))


def morton_reference(coords, lo, hi):
    """numpy float32 Morton codes: the reference's quantization
    (collision.cl:14-40) by the reciprocal of the extent, with the
    library's degenerate-axis rule."""
    coords = np.asarray(coords, np.float32)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    ext = hi - lo
    safe = ext > 0
    inv = np.where(safe, np.float32(1) / np.where(safe, ext, np.float32(1)),
                   np.float32(0)).astype(np.float32)
    scale = np.float32(1023)
    q = np.clip((coords - lo) * inv * scale, np.float32(0),
                scale).astype(np.uint32)

    def expand(v):
        v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
        v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
        v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
        v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
        return v

    x, y, z = (expand(q[:, a]) for a in range(3))
    return (x << np.uint32(2)) + (y << np.uint32(1)) + z


def result_line(platform, kind, count):
    """The last line: exactly the keys the driver reads."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": int(count)}})


# ---- run helpers ----

def say(*parts):
    print(*parts, flush=True)


def timed(label, fn):
    """Run ``fn`` twice to completion; print cold (compile + run) and warm
    seconds; return the warm result."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t2 = time.perf_counter()
    say("  {}: first call {:.3f} s (compile + run), warm {:.3f} s".format(
        label, t1 - t0, t2 - t1))
    return out


def peak_bytes(phase):
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    say("  {} peak_bytes_in_use: {}".format(
        phase, stats.get("peak_bytes_in_use", "not reported")))


def memory_analysis(label, coords, radii, capacity):
    """XLA's memory analysis of the compiled ``collide`` step."""
    from collision_tpu.collider import _collide

    m = _collide.lower(coords, radii, capacity, method="column") \
        .compile().memory_analysis()
    say("  memory_analysis {}: argument {} B, output {} B, temp {} B, "
        "generated code {} B".format(
            label, m.argument_size_in_bytes, m.output_size_in_bytes,
            m.temp_size_in_bytes, m.generated_code_size_in_bytes))


def grid_reference(coords, radii):
    """Exact count from the grid stencil, an engine independent of the
    column pipeline and the LBVH: cells at least 2*r_max wide (at most
    the default grid), capacity doubled until no cell overflows."""
    import jax.numpy as jnp

    from collision_tpu import collide
    from collision_tpu.collider import default_grid_config

    c, r = np.asarray(coords), np.asarray(radii)
    n = len(c)
    ext = float((c.max(axis=0) - c.min(axis=0)).max())
    gd = default_grid_config(n)[0]
    if r.max() > 0:
        gd = int(max(1, min(gd, ext // (2 * float(r.max())))))
    occ = n / gd ** 3
    cap = int(-(-int(occ + 5 * occ ** 0.5 + 4) // 8) * 8)
    for _ in range(8):
        res = collide(jnp.asarray(c), jnp.asarray(r), 0, method="grid",
                      grid_dim=gd, cell_capacity=cap)
        if bool(res.ok):
            say("  grid reference: grid_dim {}, cell_capacity {}".format(
                gd, cap))
            return int(res.count)
        cap *= 2
    raise SmokeError("grid reference overflowed at cell_capacity {}".format(
        cap))


RUNG_NAMES = {"first": "first shot", "candidates": "candidate-count retry",
              "bvh": "LBVH"}


# ---- phases ----

def phase_a(n_devices):
    import jax

    devs = jax.devices()
    say("A. device: platform {}, kind {}, count {}, jax {}".format(
        devs[0].platform, devs[0].device_kind, len(devs), jax.__version__))
    say("  XLA_FLAGS: {}".format(os.environ.get("XLA_FLAGS", "(unset)")))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        say(line.strip())
    check(len(devs) >= n_devices, "need {} GPUs, JAX found {}".format(
        n_devices, len(devs)))
    return devs[0]


def phase_b():
    import jax.numpy as jnp

    from collision_tpu import Collider, collide

    n = N_UNIFORM
    say("B. uniform {} (seed 4, r ~ U(0, 1/sqrt(n)))".format(n))
    c_np, r_np = uniform_scene(n)
    c, r = jnp.asarray(c_np), jnp.asarray(r_np)
    cnt = timed("collide count", lambda: collide(c, r, 0))
    check(bool(cnt.ok), "collide count ok")
    fill = timed("collide fill", lambda: collide(c, r, CAPACITY))
    check(bool(fill.ok), "collide fill ok")
    check_equal("fill total vs count", fill.count, cnt.count)
    check_pairs("collide fill", fill.pairs, fill.count, CAPACITY, c_np, r_np)
    coll = Collider(n)
    ccount = timed("Collider count", lambda: coll.get_collisions(
        c, r, 0, collisions=None))
    say("  Collider rung: {}".format(RUNG_NAMES[coll.last_rung]))
    check_equal("Collider count", ccount, cnt.count)
    bvh = timed("LBVH count", lambda: collide(c, r, 0, method="bvh"))
    check(bool(bvh.ok), "LBVH ok")
    check_equal("LBVH count", bvh.count, cnt.count)
    grid = timed("grid_count", lambda: collide(c, r, 0, method="grid"))
    check(bool(grid.ok), "grid_count ok")
    check_equal("grid_count", grid.count, cnt.count)
    memory_analysis("count", c, r, 0)
    memory_analysis("fill", c, r, CAPACITY)
    say("  count {} (collide = Collider = LBVH = grid_count)".format(
        int(cnt.count)))
    peak_bytes("B")


def phase_c():
    import jax.numpy as jnp

    from collision_tpu import Collider, candidate_count, collide
    from collision_tpu.columns import default_column_config
    from collision_tpu.testing import blocked_collisions

    n = N_BLOCKED
    say("C. blocked brute force, uniform {} (seed 4)".format(n))
    c_np, r_np = uniform_scene(n)
    c, r = jnp.asarray(c_np), jnp.asarray(r_np)
    t0 = time.perf_counter()
    total, ref_pairs = blocked_collisions(c, r)
    say("  blocked oracle: {} pairs in {:.3f} s".format(
        total, time.perf_counter() - t0))
    first = collide(c, r, 0)
    say("  default-knob collide ok: {}".format(bool(first.ok)))
    coll = Collider(n)
    ccount = timed("Collider count", lambda: coll.get_collisions(
        c, r, 0, collisions=None))
    say("  Collider rung: {}".format(RUNG_NAMES[coll.last_rung]))
    check_equal("Collider count vs blocked oracle", ccount, total)
    needed = float(candidate_count(c, r, default_column_config(n)))
    cand = 1 << int(needed).bit_length()
    cap = 1 << int(total).bit_length()
    cnt = timed("collide count", lambda: collide(
        c, r, 0, cand_capacity=cand))
    check(bool(cnt.ok), "collide count ok")
    check_equal("collide count vs blocked oracle", cnt.count, total)
    fill = timed("collide fill", lambda: collide(
        c, r, cap, cand_capacity=cand))
    check(bool(fill.ok), "collide fill ok")
    check_equal("collide fill total vs blocked oracle", fill.count, total)
    check_pairs("collide fill", fill.pairs, fill.count, cap, c_np, r_np)
    check(np.array_equal(pair_keys(fill.pairs, fill.count, n),
                         np.sort(ref_pairs[:, 0] * n + ref_pairs[:, 1])),
          "collide pair set vs blocked oracle")
    say("  count {} (collide = Collider = blocked oracle; pair sets "
        "equal)".format(total))
    peak_bytes("C")


def exact_phase(label, c_np, r_np):
    """Count and fill through Collider and collide_exact, which must
    agree with each other and with the independent grid stencil."""
    import jax.numpy as jnp

    from collision_tpu import Collider, collide_exact

    n = len(c_np)
    c, r = jnp.asarray(c_np), jnp.asarray(r_np)
    coll = Collider(n)
    ccount = timed("Collider count", lambda: coll.get_collisions(
        c, r, 0, collisions=None))
    say("  Collider count rung: {}".format(RUNG_NAMES[coll.last_rung]))
    ecount = timed("collide_exact count", lambda: collide_exact(c, r, 0))
    check(ecount.ok is None or bool(ecount.ok), "collide_exact count ok")
    check_equal("collide_exact count vs Collider", ecount.count, ccount)
    fcount, fpairs = timed("Collider fill", lambda: coll.get_collisions(
        c, r, CAPACITY))
    say("  Collider fill rung: {}".format(RUNG_NAMES[coll.last_rung]))
    check_equal("Collider fill total (count past capacity)", fcount, ccount)
    check_pairs("Collider fill", fpairs, fcount, CAPACITY, c_np, r_np)
    efill = timed("collide_exact fill", lambda: collide_exact(
        c, r, CAPACITY))
    check(efill.ok is None or bool(efill.ok), "collide_exact fill ok")
    check_equal("collide_exact fill total", efill.count, ccount)
    check(np.array_equal(np.asarray(efill.pairs), np.asarray(fpairs)),
          "collide_exact fill vs Collider fill")
    grid = grid_reference(c_np, r_np)
    check_equal("{} count vs grid_count".format(label), ccount, grid)
    say("  count {} (Collider = collide_exact = grid_count, the "
        "independent engine)".format(int(ccount)))


def phase_d():
    say("D. dense reference scene: {} spheres, r ~ U(0, 0.06)".format(
        N_DENSE))
    exact_phase("dense", *dense_scene())
    peak_bytes("D")


def phase_e():
    say("E. mixed radii {}: pareto(2.5), clipped at 0.05".format(
        N_POWERLAW))
    exact_phase("mixed radii", *powerlaw_scene())
    peak_bytes("E")


def phase_f():
    import jax.numpy as jnp

    from collision_tpu import simulate

    n, steps = N_UNIFORM, 5
    say("F. simulate: uniform {}, {} count-only steps".format(n, steps))
    c_np, r_np = uniform_scene(n)
    v_np = np.random.RandomState(5).uniform(-1, 1, (n, 3)).astype("float32")
    c, v, r = jnp.asarray(c_np), jnp.asarray(v_np), jnp.asarray(r_np)
    fc, fv, counts, ok = timed("simulate", lambda: simulate(
        c, v, r, n_steps=steps))
    check(bool(ok), "simulate ok")
    counts = np.asarray(counts)
    say("  per-step counts: {}".format(counts.tolist()))
    final = grid_reference(np.asarray(fc), r_np)
    check_equal("final-step count vs grid_count", counts[-1], final)
    peak_bytes("F")


def phase_g():
    import jax
    import jax.numpy as jnp

    from collision_tpu import morton_encode

    n = N_UNIFORM
    say("G. Morton codes of {} random f32 points vs numpy".format(n))
    rng = np.random.RandomState(6)
    c_np = rng.uniform(-100, 100, (n, 3)).astype("float32")
    lo, hi = c_np.min(axis=0), c_np.max(axis=0)
    enc = jax.jit(morton_encode)
    codes = timed("morton_encode", lambda: enc(
        jnp.asarray(c_np), jnp.asarray(lo), jnp.asarray(hi)))
    want = morton_reference(c_np, lo, hi)
    diff = int((np.asarray(codes) != want).sum())
    check(diff == 0, "{} Morton codes differ from numpy".format(diff))
    say("  all {} codes bit-equal".format(n))
    peak_bytes("G")


def phase_four():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from collision_tpu import collide
    from collision_tpu.collider import default_cand_capacity
    from collision_tpu.columns import default_column_config
    from collision_tpu.fill import run_fill
    from collision_tpu.parallel import make_sharded_collider, make_sharded_fill

    n = N_UNIFORM
    say("four GPUs: sharded fill and sharded LBVH, uniform {}, capacity "
        "{}".format(n, CAPACITY))
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    c_np, r_np = uniform_scene(n)
    c, r = jnp.asarray(c_np), jnp.asarray(r_np)
    gxy = default_column_config(n)
    cand = default_cand_capacity(n, CAPACITY)
    fill_step = make_sharded_fill(mesh, CAPACITY, gxy, cand)
    sf = timed("sharded fill (4 GPUs)", lambda: fill_step(c, r))
    rp, rt, rok = timed("run_fill (1 GPU)", lambda: run_fill(
        c, r, CAPACITY, gxy, cand))
    check(bool(sf.ok) and bool(rok), "fill ok")
    check_equal("sharded fill count", sf.count, rt)
    check(np.array_equal(np.asarray(sf.pairs), np.asarray(rp)),
          "sharded fill pairs bit-identical to one GPU")
    bvh_step = make_sharded_collider(mesh, capacity=CAPACITY)
    sb = timed("sharded LBVH (4 GPUs)", lambda: bvh_step(c, r))
    rb = timed("LBVH (1 GPU)", lambda: collide(c, r, CAPACITY, method="bvh"))
    check(bool(rb.ok), "LBVH ok")
    check_equal("sharded LBVH count", sb.count, rb.count)
    check(np.array_equal(np.asarray(sb.pairs), np.asarray(rb.pairs)),
          "sharded LBVH pairs bit-identical to one GPU")
    check_equal("sharded LBVH vs sharded fill count", sb.count, sf.count)
    check_pairs("sharded fill", sf.pairs, sf.count, CAPACITY, c_np, r_np)
    say("  count {} (sharded fill = run_fill = sharded LBVH = LBVH, "
        "bit-identical buffers)".format(int(sb.count)))
    peak_bytes("four")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded paths on four GPUs")
    args = parser.parse_args(argv)

    sys.path.insert(0, HERE)
    import collision_tpu

    pkg = os.path.dirname(os.path.abspath(collision_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        print("chip_smoke: collision_tpu is not beside this script "
              "(found {})".format(pkg), file=sys.stderr)
        return 2
    from collision_tpu.utils import enable_compilation_cache

    cache = enable_compilation_cache()

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print("chip_smoke: needs a GPU; JAX found platform {!r}".format(
            platform), file=sys.stderr)
        return 2
    say("compilation cache: {}".format(cache))
    n_devices = 4 if args.four else 1
    dev = phase_a(n_devices)
    count = len(jax.devices())
    if args.four:
        phase_four()
    else:
        for phase in (phase_b, phase_c, phase_d, phase_e, phase_f, phase_g):
            t0 = time.perf_counter()
            phase()
            say("  phase wall {:.3f} s".format(time.perf_counter() - t0))
    print(result_line(dev.platform, dev.device_kind, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
