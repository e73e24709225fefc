"""Bottom-up AABB refit, without atomics.

Re-design of the reference's leafBounds/internalBounds kernels
(/root/reference/collision/collision.cl:128-162). The reference climbs
leaf-to-root with an atomic per-node readiness flag (first arriver exits,
second computes the union); XLA has no atomics to express that, and a racy
climb is the wrong shape for it anyway. Instead the refit is *level-synchronous*:
every round gathers both children's AABBs for all internal nodes at once and
commits the union for exactly the nodes whose children are both ready. A
round is three gathers + min/max + select over fixed-shape arrays, and the
loop runs until every internal node is ready — at most the tree depth, which
the (code, index) tie-break bounds by 64 (the effective key width), and which
is ~2·log2(n) for random scenes. Determinism replaces the reference's race.
"""

import jax
import jax.numpy as jnp


def leaf_bounds(coords, radii, leaf_id):
    """Per-leaf AABBs: center ± radius, in sorted-leaf order.

    Equivalent of leafBounds (collision.cl:128-141): leaf k's bound comes from
    the sphere with original id leaf_id[k].

    Returns (lo, hi), each [n, 3] in the coord dtype.
    """
    coords = jnp.asarray(coords)
    radii = jnp.asarray(radii)
    c = jnp.take(coords, leaf_id, axis=0)
    r = jnp.take(radii, leaf_id, axis=0)[:, None]
    return c - r, c + r


def refit(tree, leaf_lo, leaf_hi, max_rounds=64):
    """Internal-node AABBs from leaf AABBs.

    Args:
      tree: :class:`collision_tpu.lbvh.LBVH`.
      leaf_lo, leaf_hi: [n, 3] leaf AABBs in sorted-leaf order.
      max_rounds: safety cap on the readiness loop; 64 covers the worst-case
        radix-tree depth over 32-bit codes with 32-bit index tie-breaks.

    Returns:
      (lo, hi): [2n - 1, 3] AABBs for every node, internal nodes first —
      the same node numbering as the reference's bounds buffer
      (collision.py:74-78).
    """
    n = tree.n_leaves
    dt = leaf_lo.dtype
    if n == 1:
        return leaf_lo, leaf_hi

    n_int = n - 1
    lo = jnp.concatenate([jnp.full((n_int, 3), jnp.inf, dt), leaf_lo])
    hi = jnp.concatenate([jnp.full((n_int, 3), -jnp.inf, dt), leaf_hi])
    valid = jnp.concatenate(
        [jnp.zeros((n_int,), jnp.bool_), jnp.ones((n,), jnp.bool_)]
    )

    left = tree.left
    right = tree.right

    def cond(carry):
        _, _, valid, rounds = carry
        return jnp.logical_and(~jnp.all(valid[:n_int]), rounds < max_rounds)

    def body(carry):
        lo, hi, valid, rounds = carry
        ready = valid[left] & valid[right] & ~valid[:n_int]
        new_lo = jnp.minimum(lo[left], lo[right])
        new_hi = jnp.maximum(hi[left], hi[right])
        lo = lo.at[:n_int].set(jnp.where(ready[:, None], new_lo, lo[:n_int]))
        hi = hi.at[:n_int].set(jnp.where(ready[:, None], new_hi, hi[:n_int]))
        valid = valid.at[:n_int].set(valid[:n_int] | ready)
        return lo, hi, valid, rounds + 1

    lo, hi, _, _ = jax.lax.while_loop(
        cond, body, (lo, hi, valid, jnp.int32(0))
    )
    return lo, hi
