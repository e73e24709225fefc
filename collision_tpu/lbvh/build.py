"""Karras (HPG 2012) parallel binary-radix-tree construction.

Re-design of the reference's generateBVH/fillInternal kernels
(/root/reference/collision/collision.cl:42-121). The reference stores nodes as
a packed 16-byte struct with a parent pointer, a right_edge, and a
leaf-id/children union; XLA wants structure-of-arrays with static shapes, so
the tree is five flat arrays (see :class:`LBVH`). The per-internal-node
construction is a pure function of the sorted codes, ``vmap``-ed over all
n - 1 internal nodes; the reference's data-dependent while loops become
fixed-bound ``fori_loop``s with done-flags (every search is bounded by the
32-bit key width), which XLA compiles without dynamic shapes.

Node numbering matches the reference exactly: internal nodes occupy
[0, n - 1), leaves occupy [n - 1, 2n - 1) in sorted-code order, the root is
node 0, and ``right_edge`` of a node is the largest sorted-leaf index in its
subtree — the field both the pair-dedup rule and the golden-tree tests key on.

The duplicate-code tie-break is ``32 + clz(i ^ j)`` (collision.cl:74-76),
i.e. equal codes fall back to a radix tree over leaf indices; the reference's
``test_problem_codes`` regression (a duplicate-heavy corpus that once produced
a parentless node) is ported verbatim in tests/test_lbvh.py.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

#: Sentinel for "no node" (root's parent), uint32 max — reference collision.py:11.
NO_NODE = np.uint32(0xFFFFFFFF)


class LBVH(NamedTuple):
    """Structure-of-arrays binary radix tree over n sorted leaves.

    Fields (n = number of leaves; 2n - 1 nodes total, internal first):
      parent:     uint32[2n - 1]; parent[0] == NO_NODE.
      left:       uint32[n - 1]; left child of each internal node.
      right:      uint32[n - 1]; right child of each internal node.
      right_edge: uint32[2n - 1]; max sorted-leaf index in each subtree
                  (leaves: their own index, collision.cl:62).
      leaf_id:    uint32[n]; original sphere id of each sorted leaf
                  (collision.cl:61).
    """

    parent: jax.Array
    left: jax.Array
    right: jax.Array
    right_edge: jax.Array
    leaf_id: jax.Array

    @property
    def n_leaves(self):
        return self.leaf_id.shape[0]

    @property
    def n_nodes(self):
        return self.parent.shape[0]

    @property
    def leaf_start(self):
        return self.n_leaves - 1


def build(codes, leaf_ids=None):
    """Build the radix tree over ``codes`` (sorted uint32 Morton codes).

    Args:
      codes: uint32[n] sorted (ascending) codes, n >= 1, n <= 2**30.
      leaf_ids: optional uint32[n] original ids per sorted leaf (the sort
        permutation); defaults to arange(n).

    Returns:
      :class:`LBVH`.
    """
    codes = jnp.asarray(codes, jnp.uint32)
    n = codes.shape[0]
    if leaf_ids is None:
        leaf_ids = jnp.arange(n, dtype=jnp.uint32)
    else:
        leaf_ids = jnp.asarray(leaf_ids, jnp.uint32)

    leaf_edges = jnp.arange(n, dtype=jnp.uint32)
    if n == 1:
        return LBVH(
            parent=jnp.full((1,), NO_NODE, jnp.uint32),
            left=jnp.zeros((0,), jnp.uint32),
            right=jnp.zeros((0,), jnp.uint32),
            right_edge=leaf_edges,
            leaf_id=leaf_ids,
        )

    child_a, child_b, edge = _internal_nodes(codes)

    iota = jnp.arange(n - 1, dtype=jnp.uint32)
    parent = jnp.full((2 * n - 1,), NO_NODE, jnp.uint32)
    parent = parent.at[child_a].set(iota)
    parent = parent.at[child_b].set(iota)

    right_edge = jnp.concatenate([edge.astype(jnp.uint32), leaf_edges])
    return LBVH(
        parent=parent,
        left=child_a.astype(jnp.uint32),
        right=child_b.astype(jnp.uint32),
        right_edge=right_edge,
        leaf_id=leaf_ids,
    )


def _internal_nodes(codes):
    """Children + right_edge of every internal node, vmapped over i."""
    n = codes.shape[0]
    leaf_start = n - 1

    def delta(i, j):
        """Common-prefix length of the (code, index) keys at i and j, or -1
        when j is out of range (collision.cl:65-77). i is always in range."""
        valid = (j >= 0) & (j < n)
        js = jnp.clip(j, 0, n - 1)
        diff = codes[i] ^ codes[js]
        tie = 32 + jax.lax.clz(
            i.astype(jnp.uint32) ^ js.astype(jnp.uint32)
        ).astype(jnp.int32)
        d = jnp.where(diff != 0, jax.lax.clz(diff).astype(jnp.int32), tie)
        return jnp.where(valid, d, -1)

    def one(i):
        # Direction: toward the neighbor with the longer common prefix.
        d_fwd = delta(i, i + 1)
        d_bwd = delta(i, i - 1)
        forward = d_fwd > d_bwd
        d = jnp.where(forward, 1, -1).astype(jnp.int32)
        delta_min = jnp.where(forward, d_bwd, d_fwd)

        # Exponential search for an upper bound on the range length
        # (collision.cl:92-94). len_max doubles from 2 while the probe still
        # shares more than delta_min bits; out-of-range probes return -1 so
        # the loop self-terminates within 32 doublings for n <= 2**30.
        def grow(_, carry):
            len_max, done = carry
            go = (delta(i, i + d * len_max) > delta_min) & ~done
            return jnp.where(go, len_max * 2, len_max), done | ~go

        len_max, _ = jax.lax.fori_loop(
            0, 34, grow, (jnp.int32(2), jnp.bool_(False))
        )

        # Binary search for the exact range length (collision.cl:96-99).
        # len_max is a power of two, so the probe offsets len_max >> k
        # reproduce the reference's halving sequence exactly.
        def shrink(k, length):
            t = len_max >> k
            go = (t > 0) & (delta(i, i + d * (length + t)) > delta_min)
            return jnp.where(go, length + t, length)

        length = jax.lax.fori_loop(1, 33, shrink, jnp.int32(0))
        j = i + d * length
        delta_node = delta(i, j)

        # Split search (collision.cl:103-111): do { t = ceil(t/2); ... }
        # while (t > 1), as a fixed 34-iteration loop with a done flag; the
        # final t == 1 body still applies before done latches.
        def split(_, carry):
            s, t, done = carry
            t2 = (t + 1) // 2
            go = (delta(i, i + d * (s + t2)) > delta_node) & ~done
            s = jnp.where(go, s + t2, s)
            return s, jnp.where(done, t, t2), done | (t2 <= 1)

        s, _, _ = jax.lax.fori_loop(
            0, 34, split, (jnp.int32(0), length, jnp.bool_(False))
        )

        gamma = jnp.where(forward, i + s, i - s - 1)
        lo_ij = jnp.minimum(i, j)
        hi_ij = jnp.maximum(i, j)
        child_a = jnp.where(lo_ij == gamma, leaf_start + gamma, gamma)
        child_b = jnp.where(hi_ij == gamma + 1, leaf_start + gamma + 1, gamma + 1)
        return child_a, child_b, hi_ij

    return jax.vmap(one)(jnp.arange(n - 1, dtype=jnp.int32))
