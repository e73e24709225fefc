"""Public broad-phase API: functional ``collide`` step + stateful ``Collider``.

Re-design of the reference's pipeline orchestrator
(/root/reference/collision/collision.py:32-198). The reference enqueues ~11
OpenCL commands per frame wired by an event DAG; here a whole frame is one
pure function inside one ``jit``, so XLA's scheduler replaces the hand-built
event DAG and a moving-spheres simulation loop never leaves the device
between steps.

Engines (``method``), all plain XLA:
  * "column" (what "auto" runs): column sort, per-sphere candidate runs,
    an exact candidate pass and count-then-fill emission (columns.py,
    fill.py);
  * "grid": dense uniform-grid stencil count (grid.py); its fills take the
    column engine's emission;
  * "bvh": scene bounds → Morton encoding → stable key/id sort → Karras
    LBVH build → level-synchronous AABB refit → lockstep traversal with
    count-then-fill pair compaction (lbvh/).

Contract parity with the reference (SURVEY.md §3.1):
  1. output = set of unordered pairs of original sphere ids whose
     center±radius AABBs *strictly* overlap, each reported once, no
     self-pairs;
  2. pair order and within-pair order are unspecified (here: deterministic,
     stronger than the reference);
  3. the returned count is the true total even when it exceeds capacity, and
     only the first ``capacity`` pairs are written;
  4. count-only mode: capacity == 0 computes the count without a pair buffer;
     a ``None`` pair request with capacity > 0 raises ValueError
     (collision.py:134-135);
  5. Morton quantization: 10 bits/axis over the exact scene AABB of centers.
"""

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .columns import default_column_config
from .fill import candidate_count, run_fill
from .grid import grid_count
from .lbvh.build import build, NO_NODE
from .lbvh.refit import leaf_bounds, refit
from .lbvh.traverse import find_pairs, traverse_count, STACK_DEPTH
from .ops.morton import morton_encode
from .ops.reduce import scene_bounds
from .ops.sort import argsort_keys
from .utils import round_up


class CollisionResult(NamedTuple):
    """Result of one broad-phase step.

    count:     uint32 — true number of colliding pairs (may exceed capacity).
    pairs:     uint32[capacity, 2] of original sphere ids, or None when
               capacity == 0 (count-only mode). Slots past min(count,
               capacity) hold 0xFFFFFFFF.
    scene_min: [3] scene AABB lower corner (of centers).
    scene_max: [3] scene AABB upper corner.
    ok:        bool — True unless a static knob of the selected method
               was insufficient (candidate bound, grid cell capacity, BVH
               traversal-stack depth, count near int32 wrap); on False
               the caller must retry with larger knobs (the static-shape
               analog of the reference's count-past-capacity retry
               contract). None means trivially ok (single-sphere scene).
    """

    count: jax.Array
    pairs: Optional[jax.Array]
    scene_min: jax.Array
    scene_max: jax.Array
    ok: Optional[jax.Array] = None

    @property
    def overflowed(self):
        """True when count exceeded the pair-buffer capacity.

        Count-only results (pairs is None) never overflow — there is no
        buffer to overflow; the count is always the exact total.
        """
        if self.pairs is None:
            return False
        return self.count > self.pairs.shape[0]


#: Engines :func:`collide` accepts; "auto" runs "column".
METHODS = ("auto", "column", "grid", "bvh")


def _check_method(method):
    if method not in METHODS:
        raise ValueError("Unknown method {!r}; expected one of {}".format(
            method, ", ".join(METHODS)))


def default_grid_config(n, target_occupancy=72):
    """(grid_dim, cell_capacity) for ~``target_occupancy`` spheres per cell.

    Capacity is sized ~5 Poisson sigmas above the mean occupancy so
    uniform scenes don't trip the overflow flag.
    """
    gd = int(min(max(round((n / target_occupancy) ** (1 / 3)), 4), 64))
    occ = n / gd ** 3
    mc = int(round_up(int(occ + 5 * occ ** 0.5 + 4), 8))
    mc = max(16, min(mc, max(16, round_up(n, 8))))
    return gd, mc


def default_grid_dim(n, target_occupancy=72):
    """Cells per axis for ~``target_occupancy`` spheres per cell."""
    return default_grid_config(n, target_occupancy)[0]


def default_cand_capacity(n, capacity):
    """Static bound on the fill pipeline's conservative candidates.

    Sized for uniform scenes (~30 conservative candidates per sphere at
    the default column occupancy); the ``ok`` retry contract covers
    denser scenes.
    """
    return max(1 << 17, 8 * capacity, 32 * n)


def collide(coords, radii, capacity, stack_depth=STACK_DEPTH, method="auto",
            grid_dim=None, cell_capacity=None, gxy=None, cand_capacity=None):
    """One fully-jitted broad-phase step.

    Args:
      coords: [n, 3] float sphere centers (n >= 1).
      radii:  [n] float radii.
      capacity: static pair-buffer capacity; 0 = count-only.
      stack_depth: static traversal-stack depth of "bvh" (reference: 64).
      method: "auto" or "column" (run-expansion pipeline, fill.py), "grid"
        (dense stencil count, grid.py; fills run the column pipeline) or
        "bvh" (LBVH build + lockstep traversal).
      grid_dim, cell_capacity: static grid knobs; None resolves
        :func:`default_grid_config`.
      gxy: static columns per xy axis of the column pipeline; None
        resolves :func:`columns.default_column_config`.
      cand_capacity: static candidate bound of the column pipeline; None
        resolves :func:`default_cand_capacity`.

    On any static-knob overflow the result's ``ok`` is False and the
    caller retries with larger knobs (:class:`Collider` and
    :func:`collide_exact` automate this).

    Returns:
      :class:`CollisionResult`.
    """
    _check_method(method)
    if method == "auto":
        method = "column"
    return _collide(coords, radii, capacity, stack_depth, method, grid_dim,
                    cell_capacity, gxy, cand_capacity)


@partial(jax.jit, static_argnames=(
    "capacity", "stack_depth", "method", "grid_dim", "cell_capacity",
    "gxy", "cand_capacity"))
def _collide(coords, radii, capacity, stack_depth=STACK_DEPTH,
             method="column", grid_dim=None, cell_capacity=None, gxy=None,
             cand_capacity=None):
    coords = jnp.asarray(coords)
    radii = jnp.asarray(radii)
    n = coords.shape[0]

    lo_scene, hi_scene = scene_bounds(coords)
    if n == 1:
        zero = jnp.uint32(0)
        pairs = (
            jnp.full((capacity, 2), NO_NODE, jnp.uint32) if capacity else None
        )
        return CollisionResult(zero, pairs, lo_scene, hi_scene)

    if method == "bvh":
        codes = morton_encode(coords, lo_scene, hi_scene)
        codes_sorted, ids_sorted = argsort_keys(codes)
        tree = build(codes_sorted, ids_sorted)
        llo, lhi = leaf_bounds(coords, radii, tree.leaf_id)
        lo, hi = refit(tree, llo, lhi)
        if capacity == 0:
            counts, ok = traverse_count(
                tree, lo, hi, stack_depth=stack_depth, with_ok=True)
            return CollisionResult(
                jnp.sum(counts, dtype=jnp.uint32), None, lo_scene, hi_scene,
                ok=ok,
            )
        pairs, total, ok = find_pairs(
            tree, lo, hi, capacity, stack_depth=stack_depth, with_ok=True)
        return CollisionResult(total, pairs, lo_scene, hi_scene, ok=ok)

    if method == "grid" and capacity == 0:
        auto_gd, auto_mc = default_grid_config(n)
        out = grid_count(
            coords, radii,
            grid_dim=auto_gd if grid_dim is None else grid_dim,
            cell_capacity=auto_mc if cell_capacity is None else cell_capacity)
        return CollisionResult(out.total, None, lo_scene, hi_scene, ok=out.ok)

    if gxy is None:
        gxy = default_column_config(n)
    if cand_capacity is None:
        cand_capacity = default_cand_capacity(n, capacity)
    pairs, total, ok = run_fill(coords, radii, capacity, gxy, cand_capacity)
    return CollisionResult(total, pairs, lo_scene, hi_scene, ok=ok)


def collide_exact(coords, radii, capacity, method="auto"):
    """One broad-phase step with host-side exact-knob retries.

    The functional analog of ``Collider.get_collisions``'s retry chain
    (reallocate-and-retry, as the reference's resize contract,
    collision.py:84-119): one ``collide`` attempt, then — on a
    static-knob overflow — the column pipeline with the candidate bound
    the scene needs, and finally the always-exact BVH. Requires concrete
    (non-traced) inputs; returns a :class:`CollisionResult` whose ``ok``
    is True (or None) unless every rung failed.
    """
    coords = jnp.asarray(coords)
    c = Collider(coords.shape[0], coord_dtype=np.dtype(coords.dtype.name),
                 method=method)
    return c._exact(coords, jnp.asarray(radii), capacity)


class Collider:
    """Stateful wrapper matching the reference Collider API
    (collision.py:32-135): holds (size, ngroups, group_size, coord_dtype),
    exposes ``padded_size``/``n_nodes``, validates the count-only contract,
    and supports ``resize``. Compilation caching plays the role the
    reference's shareable pre-compiled programs played — two Colliders with
    the same static shapes share one XLA executable.
    """

    code_dtype = np.dtype("uint32")
    flag_dtype = np.dtype("uint32")  # kept for parity; no flags are used
    counter_dtype = np.dtype("uint32")
    id_dtype = np.dtype("uint32")

    #: Largest candidate bound the retry will provision before falling
    #: back to the BVH engine.
    CAND_MAX = 1 << 28

    def __init__(self, size, ngroups=8, group_size=128,
                 coord_dtype=np.dtype("float32"), method="auto"):
        coord_dtype = np.dtype(coord_dtype)
        if coord_dtype.kind != "f":
            raise ValueError("Invalid dtype: {}".format(coord_dtype))
        self._check_params(size, ngroups, group_size)
        _check_method(method)
        self.size = size
        self.ngroups = ngroups
        self.group_size = group_size
        self.coord_dtype = coord_dtype
        #: Engine selection forwarded to :func:`collide`.
        self.method = method
        #: Which rung answered the last call: "first" (one ``collide``),
        #: "candidates" (column pipeline at the scene's exact candidate
        #: bound) or "bvh" (the LBVH last resort). None before any call.
        self.last_rung = None

    @staticmethod
    def _check_params(size, ngroups, group_size):
        """Eager parameter validation, mirroring the reference's size/shape
        checks (collision.py:84-119, radix.py:61-74): sizes are positive
        integers; group sizes are powers of two (the reference's scan/sort
        granularity constraint — kept so invalid configs fail here instead
        of as confusing downstream shape errors)."""
        if not isinstance(size, (int, np.integer)) or size < 1:
            raise ValueError("Invalid size: {!r}".format(size))
        if not isinstance(ngroups, (int, np.integer)) or ngroups < 1:
            raise ValueError("Invalid ngroups: {!r}".format(ngroups))
        if (not isinstance(group_size, (int, np.integer)) or group_size < 1
                or (group_size & (group_size - 1)) != 0):
            raise ValueError(
                "group_size must be a positive power of two, got {!r}".format(
                    group_size
                )
            )

    @property
    def n_nodes(self):
        return self.size * 2 - 1

    @property
    def padded_size(self):
        """Sorter-granularity padding (reference collision.py:125-128).

        XLA sorts any N, so nothing is actually padded — the property is
        kept because callers sized buffers from it.
        """
        return round_up(self.size, 2 * self.group_size)

    def resize(self, size=None, ngroups=None, group_size=None, radix_bits=None):
        """Revalidate-and-apply, rolling back on failure — the reference
        revalidates every derived quantity and restores prior state when a
        new configuration is invalid (collision.py:84-119, radix.py:93-97).
        """
        new_size = self.size if size is None else size
        new_ngroups = self.ngroups if ngroups is None else ngroups
        new_group_size = self.group_size if group_size is None else group_size
        # Raises before any state is mutated: rollback by construction.
        self._check_params(new_size, new_ngroups, new_group_size)
        if radix_bits is not None:
            # Parity with the reference's radix_bits constraint
            # (radix.py:61-74): must divide the 32-bit key width and fit
            # the per-tile bucket budget.
            if (not isinstance(radix_bits, (int, np.integer))
                    or radix_bits < 1 or 32 % radix_bits != 0
                    or 2 ** radix_bits > 2 * new_group_size):
                raise ValueError(
                    "Invalid radix_bits: {!r}".format(radix_bits)
                )
        self.size = new_size
        self.ngroups = new_ngroups
        self.group_size = new_group_size

    def get_collisions(self, coords, radii, n_collisions, collisions=True):
        """Run one frame; mirrors reference get_collisions (collision.py:130-198).

        Args:
          coords: [size, 3] centers; radii: [size] radii.
          n_collisions: pair-buffer capacity.
          collisions: pass None for count-only mode (with n_collisions == 0);
            None with n_collisions > 0 raises ValueError, matching
            collision.py:134-135.

        Returns:
          count (uint32) when count-only, else (count, pairs[n_collisions, 2]).
        """
        if collisions is None and n_collisions > 0:
            raise ValueError("Invalid collisions_buf for n_collisions > 0")
        coords = jnp.asarray(coords, self.coord_dtype)
        radii = jnp.asarray(radii, self.coord_dtype)
        if coords.shape != (self.size, 3):
            raise ValueError(
                "Expected coords of shape {}, got {}".format(
                    (self.size, 3), coords.shape
                )
            )
        result = self._exact(coords, radii, int(n_collisions))
        if collisions is None or n_collisions == 0:
            return result.count
        return result.count, result.pairs

    def _exact(self, coords, radii, capacity):
        """One ``collide`` attempt; on a static-knob overflow (ok=False)
        retry with the exact candidate bound — the host analog of the
        reference's reallocate-and-retry resize (collision.py:84-119) —
        and fall back to the always-exact BVH for scenes no bound under
        ``CAND_MAX`` can hold."""
        self.last_rung = "first"
        result = collide(coords, radii, capacity, method=self.method)
        if result.ok is None or bool(result.ok):
            return result
        # The exact requirement is one cheap (expansion-free) evaluation
        # away.
        needed = float(candidate_count(
            coords, radii, default_column_config(self.size)))
        if needed < self.CAND_MAX:
            self.last_rung = "candidates"
            result = collide(
                coords, radii, capacity, method="column",
                cand_capacity=min(int(needed * 1.02) + 1024, self.CAND_MAX))
            if bool(result.ok):
                return result
        self.last_rung = "bvh"
        return self._bvh_exact(coords, radii, capacity)

    def _bvh_exact(self, coords, radii, capacity):
        """Last-resort BVH collide, escalating the traversal-stack depth
        if a push was clipped (the reference would silently corrupt its
        traversal here, collision.cl:186-191)."""
        depth = STACK_DEPTH
        while True:
            res = collide(coords, radii, capacity, method="bvh",
                          stack_depth=depth)
            if res.ok is None or bool(res.ok) or depth >= 4096:
                return res
            depth *= 2
