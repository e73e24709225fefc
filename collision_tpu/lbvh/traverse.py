"""BVH pair-finding traversal with count-then-fill compaction.

Re-design of the reference's traverse kernel
(/root/reference/collision/collision.cl:164-226). The reference runs one
SIMT thread per query leaf, each with a private 64-entry stack, emitting
pairs through a global atomic cursor. XLA expresses neither per-thread
control flow nor atomics, so the traversal here is *lockstep*: every query leaf
advances through its own bounded stack simultaneously, with masked selects
playing the role of divergence — the whole frontier is fixed-shape [n]
arrays that XLA compiles to plain vector code.

Pair emission replaces the atomic cursor with a deterministic two-pass
count-then-fill: pass 1 traverses counting hits per query; an exclusive scan
of the counts assigns each query a contiguous slice of the output buffer;
pass 2 re-traverses and writes query q's k-th pair at offsets[q] + k,
dropping writes past capacity. This preserves the reference's overflow
contract for free — the returned total is the true pair count even when it
exceeds capacity, and only the first ``capacity`` pairs are materialized
(collision.cl:203-207) — while making emission order deterministic (the
reference leaves it undefined).

Semantics preserved exactly:
  * strict AABB overlap — touching boxes do NOT collide (collision.cl:164-166);
  * dedup/pruning rule — skip any child subtree whose ``right_edge`` is
    <= the query's sorted index, so each unordered pair is reported once by
    its leftmost-in-sorted-order participant, and never as a self-pair
    (collision.cl:198-200);
  * pairs carry *original sphere ids* (collision.cl:205-206,212-213).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.scan import exclusive_scan

#: Traversal-stack terminator (reference pushes UINT_MAX, collision.cl:188).
SENTINEL = np.uint32(0xFFFFFFFF)

#: Value marking unwritten pair slots in the output buffer.
NO_PAIR = np.uint32(0xFFFFFFFF)

#: Reference private-stack depth (collision.cl:186).
STACK_DEPTH = 64


def aabb_overlap(alo, ahi, blo, bhi):
    """Strict overlap: all(ahi > blo) & all(alo < bhi) (collision.cl:164-166)."""
    return jnp.all((ahi > blo) & (alo < bhi), axis=-1)


def _traverse(tree, lo, hi, on_hits, carry, stack_depth, queries=None):
    """Run the lockstep traversal, folding ``on_hits`` over each step.

    on_hits(carry, q, hit_a, hit_b, ca, cb) -> carry, where q is the
    sorted-query-index vector and hit_a/hit_b mark queries that hit a leaf
    child this step (ca/cb are the uint32 child node ids).

    ``queries`` optionally restricts the pass to a subset of sorted-leaf
    indices (uint32[m]) — the seam the multi-chip path shards on: the tree
    is replicated, each device traverses its own query slice.

    Returns (carry, ok): ``ok`` is False if any push hit the stack
    ceiling. The reference silently overwrites its top slot in that case
    (undefined behavior waiting to happen, collision.cl:186-191); here the
    push is clipped the same way but *detected*, so callers retry with a
    deeper stack instead of silently losing the deferred subtree.
    """
    n = tree.n_leaves
    n_int = n - 1
    if queries is None:
        q = jnp.arange(n, dtype=jnp.uint32)
    else:
        q = jnp.asarray(queries, jnp.uint32)
    m = q.shape[0]
    qlo = lo[n_int + q]
    qhi = hi[n_int + q]
    left, right, redge = tree.left, tree.right, tree.right_edge

    idx0 = jnp.zeros((m,), jnp.uint32)
    stack0 = jnp.full((m, stack_depth), SENTINEL, jnp.uint32)
    sp0 = jnp.ones((m,), jnp.int32)
    lanes = jnp.arange(m)

    def cond(state):
        idx = state[0]
        return jnp.any(idx != SENTINEL)

    def body(state):
        idx, stack, sp, ovf, carry = state
        active = idx != SENTINEL
        i = jnp.where(active, idx, 0).astype(jnp.int32)
        i = jnp.clip(i, 0, n_int - 1)
        ca = left[i]
        cb = right[i]

        oa = aabb_overlap(qlo, qhi, lo[ca], hi[ca]) & (redge[ca] > q) & active
        ob = aabb_overlap(qlo, qhi, lo[cb], hi[cb]) & (redge[cb] > q) & active

        leaf_a = ca >= n_int
        leaf_b = cb >= n_int
        hit_a = oa & leaf_a
        hit_b = ob & leaf_b
        ta = oa & ~leaf_a
        tb = ob & ~leaf_b

        carry = on_hits(carry, q, hit_a, hit_b, ca, cb)

        # Pop (both subtrees rejected) or descend, pushing the second child
        # when both need visiting (collision.cl:216-224).
        pop = ~ta & ~tb
        read_at = jnp.clip(sp - 1, 0, stack_depth - 1)
        popped = stack[lanes, read_at]
        write_at = jnp.clip(sp, 0, stack_depth - 1)
        push = ta & tb & active
        ovf = ovf | jnp.any(push & (sp >= stack_depth))
        stack = stack.at[lanes, write_at].set(
            jnp.where(push, cb, stack[lanes, write_at])
        )
        new_idx = jnp.where(pop, popped, jnp.where(ta, ca, cb))
        idx = jnp.where(active, new_idx, idx)
        sp = jnp.where(
            active, sp + push.astype(jnp.int32) - pop.astype(jnp.int32), sp
        )
        return idx, stack, sp, ovf, carry

    _, _, _, ovf, carry = jax.lax.while_loop(
        cond, body, (idx0, stack0, sp0, jnp.bool_(False), carry))
    return carry, ~ovf


def traverse_count(tree, lo, hi, stack_depth=STACK_DEPTH, queries=None,
                   with_ok=False):
    """Pass 1: number of pairs each query leaf will emit. Returns uint32[m]
    (m = number of queries; all n leaves when ``queries`` is None), or
    (counts, ok) when ``with_ok`` — ok False on a clipped stack push."""
    n = tree.n_leaves
    m = n if queries is None else queries.shape[0]
    if n <= 1:
        counts = jnp.zeros((m,), jnp.uint32)
        return (counts, jnp.bool_(True)) if with_ok else counts

    def on_hits(counts, q, hit_a, hit_b, ca, cb):
        return counts + hit_a.astype(jnp.uint32) + hit_b.astype(jnp.uint32)

    counts, ok = _traverse(
        tree, lo, hi, on_hits, jnp.zeros((m,), jnp.uint32), stack_depth,
        queries=queries,
    )
    return (counts, ok) if with_ok else counts


def traverse_fill(tree, lo, hi, offsets, capacity, stack_depth=STACK_DEPTH,
                  queries=None, with_ok=False):
    """Pass 2: write query q's k-th pair at offsets[q] + k.

    ``offsets`` is aligned with the query vector (uint32[m]) and holds each
    query's base slot in the global pair buffer — for the sharded path these
    are global positions even though the query slice is local.

    Returns uint32[capacity, 2] of (query original id, hit original id);
    unwritten slots hold NO_PAIR. Writes at or past ``capacity`` are dropped
    while counting continues — the reference's overflow contract
    (collision.cl:203-207).
    """
    n = tree.n_leaves
    m = n if queries is None else queries.shape[0]
    pairs0 = jnp.full((capacity, 2), NO_PAIR, jnp.uint32)
    if n <= 1 or capacity == 0:
        return (pairs0, jnp.bool_(True)) if with_ok else pairs0
    n_int = n - 1
    leaf_id = tree.leaf_id
    offsets = offsets.astype(jnp.uint32)
    lanes = jnp.arange(m)

    def emit(pairs, write_idx, valid, qid, hit_node):
        hit_leaf = jnp.clip(hit_node.astype(jnp.int32) - n_int, 0, n - 1)
        vals = jnp.stack([qid, leaf_id[hit_leaf]], axis=-1)
        # Invalid / overflowing writes are redirected out of bounds + dropped.
        target = jnp.where(valid & (write_idx < capacity), write_idx, capacity)
        return pairs.at[target].set(vals, mode="drop")

    def on_hits(carry, q, hit_a, hit_b, ca, cb):
        pairs, k = carry
        qid = leaf_id[q]
        base = offsets[lanes]
        pairs = emit(pairs, base + k, hit_a, qid, ca)
        k = k + hit_a.astype(jnp.uint32)
        pairs = emit(pairs, base + k, hit_b, qid, cb)
        k = k + hit_b.astype(jnp.uint32)
        return pairs, k

    (pairs, _), ok = _traverse(
        tree, lo, hi, on_hits,
        (pairs0, jnp.zeros((m,), jnp.uint32)), stack_depth,
        queries=queries,
    )
    return (pairs, ok) if with_ok else pairs


def find_pairs(tree, lo, hi, capacity, stack_depth=STACK_DEPTH,
               with_ok=False):
    """Count-then-fill: returns (pairs uint32[capacity, 2], total uint32).

    ``total`` is the exact number of colliding pairs, which may exceed
    ``capacity``; only min(total, capacity) slots of ``pairs`` are written.
    With ``with_ok`` a third element reports stack-overflow-free
    completion (False -> retry with a deeper ``stack_depth``).
    """
    counts, ok = traverse_count(
        tree, lo, hi, stack_depth=stack_depth, with_ok=True)
    total = jnp.sum(counts, dtype=jnp.uint32)
    offsets = exclusive_scan(counts)
    pairs = traverse_fill(tree, lo, hi, offsets, capacity, stack_depth=stack_depth)
    return (pairs, total, ok) if with_ok else (pairs, total)
