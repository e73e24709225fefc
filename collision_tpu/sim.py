"""Moving-spheres simulation loop, fully on the device.

The reference has no sim loop — its README frames per-frame re-use of the
Collider: per-step re-sort and rebuild for many steps. Here, fully jitted
with no host round-trips, the whole loop is one ``lax.scan`` over the collide
step: positions integrate and reflect off the unit box, every step rebuilds
the broad phase from scratch and counts collisions, and nothing leaves the
device until the final (positions, per-step counts) land. The one result
users actually *read* pairs from — the capacity > 0 final fill — gets the
Collider-style host retry (collide_exact) when the call is eager, so a
clustering end state is re-run with exact knobs instead of returning a
silently short buffer.
"""

from functools import partial

import jax
import jax.numpy as jnp

from .collider import collide, collide_exact


@partial(jax.jit, static_argnames=("n_steps", "method"))
def _simulate_scan(coords, velocities, radii, n_steps, dt, lo, hi, method):
    """The on-device part: n_steps of integrate → reflect → count."""

    def step(carry, _):
        c, v, ok = carry
        c = c + v * dt
        # Reflect off the walls.
        over = c > hi
        under = c < lo
        c = jnp.where(over, 2 * hi - c, jnp.where(under, 2 * lo - c, c))
        v = jnp.where(over | under, -v, v)
        res = collide(c, radii, 0, method=method)
        if res.ok is not None:
            ok = ok & res.ok
        return (c, v, ok), res.count

    return jax.lax.scan(
        step, (coords, velocities, jnp.bool_(True)), None, length=n_steps
    )


def simulate(coords, velocities, radii, n_steps, dt=0.01, lo=0.0, hi=1.0,
             capacity=0, method="auto"):
    """Integrate spheres for ``n_steps``, re-colliding every step.

    Args:
      coords: [n, 3] initial centers.
      velocities: [n, 3] velocities.
      radii: [n] radii.
      n_steps: static step count.
      dt: time step.
      lo, hi: axis-aligned box walls; spheres reflect off them.
      capacity: 0 counts collisions per step (the sim-loop benchmark shape);
        > 0 additionally returns the final step's pairs.
      method: collide engine per step — "auto"/"column" (run-expansion
        pipeline), "grid" (dense stencil count) or "bvh" (always exact).
        Static-capacity overflow in any step surfaces via the returned
        ``ok`` flag.

        .. note:: in-scan steps use fixed default knobs with no retry,
           so clustered scenes can return ``ok=False`` (per-step counts
           under-reported) — callers MUST check ``ok``, or pass
           ``method="bvh"`` for always-exact per-step counts. The
           capacity > 0 **final fill** IS retried to exact knobs
           host-side (when called eagerly), so the pair buffer users
           read is never silently short while ``ok`` is True.

    Returns:
      (final_coords, final_velocities, counts[n_steps], ok) and, when
      capacity > 0, the final step's pairs inserted before ``ok``.
      ``ok`` is False if any step's static knobs overflowed (counts
      would be under-reported); the BVH engine always returns True.
    """
    coords = jnp.asarray(coords)
    velocities = jnp.asarray(velocities)
    radii = jnp.asarray(radii)

    (coords, velocities, ok), counts = _simulate_scan(
        coords, velocities, radii, n_steps, dt, lo, hi, method)
    if capacity:
        eager = not isinstance(coords, jax.core.Tracer)
        if eager:
            res = collide_exact(coords, radii, capacity, method=method)
        else:
            res = collide(coords, radii, capacity, method=method)
        if res.ok is not None:
            ok = ok & res.ok
        return coords, velocities, counts, res.pairs, ok
    return coords, velocities, counts, ok
