"""chip_smoke.py's helpers on the CPU: deterministic scenes, checks that
catch planted faults, the last-line format, and refusal off the GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

from collision_tpu import collide, morton_encode  # noqa: E402
from collision_tpu.testing import brute_force_collisions  # noqa: E402


@pytest.mark.parametrize("gen", [
    chip_smoke.uniform_scene, chip_smoke.dense_scene,
    chip_smoke.powerlaw_scene])
def test_scenes_deterministic_from_seed(gen):
    c1, r1 = gen(500, seed=4)
    c2, r2 = gen(500, seed=4)
    c3, _ = gen(500, seed=5)
    assert c1.dtype == r1.dtype == np.float32
    assert c1.shape == (500, 3) and r1.shape == (500,)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(r1, r2)
    assert not np.array_equal(c1, c3)
    assert (r1 >= 0).all() and (c1 >= 0).all() and (c1 < 1).all()


def test_scene_radius_bounds():
    assert chip_smoke.uniform_scene(10000)[1].max() <= 1 / 100
    assert chip_smoke.dense_scene(10000)[1].max() <= 0.06
    r = chip_smoke.powerlaw_scene(10000)[1]
    assert r.max() <= 0.05 and r.min() >= 0.2 / 100 * (1 - 1e-6)


def test_check_equal_catches_planted_count():
    chip_smoke.check_equal("same", np.uint32(7), 7)
    with pytest.raises(chip_smoke.SmokeError, match="got 8, want 7"):
        chip_smoke.check_equal("planted", np.uint32(8), 7)


def _filled(n=300, cap=64, grow=8):
    coords, radii = chip_smoke.uniform_scene(n, seed=8)
    radii = radii * grow
    res = collide(jnp.asarray(coords), jnp.asarray(radii), cap)
    assert bool(res.ok) and int(res.count) > 8
    return coords, radii, np.asarray(res.pairs).copy(), int(res.count)


def test_check_pairs_accepts_real_fill():
    coords, radii, pairs, count = _filled()
    chip_smoke.check_pairs("real", pairs, count, 64, coords, radii)


@pytest.mark.parametrize("fault", ["non_overlap", "duplicate", "self",
                                   "past_count", "count"])
def test_check_pairs_catches_planted_fault(fault):
    coords, radii, pairs, count = _filled()
    k = min(count, 64)
    if fault == "non_overlap":
        far = np.argmax(np.linalg.norm(coords - coords[pairs[0, 0]], axis=1))
        pairs[0, 1] = far
    elif fault == "duplicate":
        pairs[1] = pairs[0][::-1]
    elif fault == "self":
        pairs[0, 1] = pairs[0, 0]
    elif fault == "past_count":
        count = k - 1
    else:
        count = k - 2
        pairs[k - 2:k] = chip_smoke.NO_PAIR
        count += 1  # one slot claims a pair that is empty
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.check_pairs(fault, pairs, count, 64, coords, radii)


def test_pair_keys_match_oracle():
    coords, radii, pairs, count = _filled(cap=4096, grow=2)
    assert count <= 4096
    n = len(coords)
    want = np.sort([a * n + b for a, b in brute_force_collisions(
        coords, radii)])
    np.testing.assert_array_equal(chip_smoke.pair_keys(pairs, count, n), want)


def test_morton_reference_matches_encoder():
    rng = np.random.RandomState(6)
    c = rng.uniform(-100, 100, (5000, 3)).astype("float32")
    c[:3, 1] = 7.0  # include exact repeats of the axis extremes
    lo, hi = c.min(axis=0), c.max(axis=0)
    got = np.asarray(morton_encode(jnp.asarray(c), jnp.asarray(lo),
                                   jnp.asarray(hi)))
    np.testing.assert_array_equal(got, chip_smoke.morton_reference(c, lo, hi))


def test_grid_reference_counts_exactly():
    coords, radii = chip_smoke.dense_scene(1500)
    assert chip_smoke.grid_reference(coords, radii) == len(
        brute_force_collisions(coords, radii))


def test_result_line_has_exactly_the_driver_keys():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_and_names_platform():
    p = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert p.returncode != 0
    assert "'cpu'" in p.stderr
    assert '"ok"' not in p.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
