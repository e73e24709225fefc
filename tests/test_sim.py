"""Moving-spheres sim loop: on-chip stepping with per-step collision counts
checked against the host oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from collision_tpu.sim import simulate
from collision_tpu.testing import brute_force_collisions, pair_array_to_set


def _host_step(coords, velocities, dt=0.01, lo=0.0, hi=1.0):
    c = coords + velocities * dt
    over = c > hi
    under = c < lo
    c = np.where(over, 2 * hi - c, np.where(under, 2 * lo - c, c))
    v = np.where(over | under, -velocities, velocities)
    return c, v


def test_simulate_counts_match_oracle():
    rng = np.random.RandomState(4)
    n, steps = 64, 5
    coords = rng.random((n, 3)).astype("float32")
    velocities = rng.uniform(-1, 1, (n, 3)).astype("float32")
    radii = rng.uniform(0, 1 / np.sqrt(n), n).astype("float32")

    final_c, final_v, counts, ok = simulate(
        jnp.asarray(coords), jnp.asarray(velocities), jnp.asarray(radii),
        n_steps=steps,
    )
    assert bool(ok)
    counts = np.asarray(counts)

    c, v = coords, velocities
    for s in range(steps):
        c, v = _host_step(c, v)
        assert counts[s] == len(brute_force_collisions(c, radii)), s
    np.testing.assert_allclose(np.asarray(final_c), c, rtol=1e-5, atol=1e-6)


def test_simulate_final_pairs():
    rng = np.random.RandomState(9)
    n = 32
    coords = rng.random((n, 3)).astype("float32")
    velocities = rng.uniform(-1, 1, (n, 3)).astype("float32")
    radii = rng.uniform(0, 0.2, n).astype("float32")

    final_c, final_v, counts, pairs, ok = simulate(
        jnp.asarray(coords), jnp.asarray(velocities), jnp.asarray(radii),
        n_steps=3, capacity=4096,
    )
    assert bool(ok)
    expected = brute_force_collisions(np.asarray(final_c), radii)
    assert pair_array_to_set(pairs, min(len(expected), 4096)) == expected


def test_simulate_final_pairs_grid_method():
    # The final-pairs pass must honor the per-step engine choice
    # (method= forwarded), and the grid fill path must agree with the
    # oracle end-to-end.
    rng = np.random.RandomState(11)
    n = 48
    coords = rng.random((n, 3)).astype("float32")
    velocities = rng.uniform(-1, 1, (n, 3)).astype("float32")
    radii = rng.uniform(0, 0.15, n).astype("float32")

    final_c, final_v, counts, pairs, ok = simulate(
        jnp.asarray(coords), jnp.asarray(velocities), jnp.asarray(radii),
        n_steps=3, capacity=2048, method="grid",
    )
    assert bool(ok)
    expected = brute_force_collisions(np.asarray(final_c), radii)
    assert pair_array_to_set(pairs, min(len(expected), 2048)) == expected


def test_simulate_final_fill_retries_to_exact(monkeypatch):
    """A clustering/heterogeneous end state must not leave the one
    result users read pairs from silently short: the capacity > 0 final
    fill goes through the Collider-style exact-knob retry chain."""
    from collision_tpu import Collider

    calls = {"retried": False}
    real_exact = Collider._exact

    def rec(self, coords, radii, capacity):
        res = real_exact(self, coords, radii, capacity)
        calls["retried"] = self.last_rung != "first"
        return res

    monkeypatch.setattr(Collider, "_exact", rec)

    # Power-law radii wide enough that the default candidate bound
    # (max(2^17, 8 * capacity, 32n)) is too small on the final scene.
    rng = np.random.RandomState(21)
    n = 600
    coords = rng.random((n, 3)).astype("float32")
    velocities = np.zeros((n, 3), "float32")
    radii = (0.004 * (1 + rng.pareto(1.2, n))).clip(0, 0.5)\
        .astype("float32")
    fc, fv, counts, pairs, ok = simulate(
        jnp.asarray(coords), jnp.asarray(velocities),
        jnp.asarray(radii), n_steps=1, capacity=4096)
    expected = brute_force_collisions(np.asarray(fc), radii)
    assert calls["retried"], "final fill never hit the retry chain"
    assert pair_array_to_set(pairs, min(len(expected), 4096)) == expected
