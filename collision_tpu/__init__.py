"""collision_tpu — a broad-phase collision-detection library in JAX.

A from-scratch JAX/XLA rebuild with the capabilities of the
kwohlfahrt/collision OpenCL library: given N sphere centers and radii, compute
the exact set of strictly-overlapping pairs inside one jitted step — by the
column pipeline (column sort → candidate runs → exact candidate pass →
count-then-fill emission), the dense grid stencil (counts), or the
reference's own architecture (scene-bounds reduction → 30-bit Morton
encoding → stable sort → Karras LBVH construction → level-synchronous AABB
refit → lockstep BVH traversal with count-then-fill pair compaction). The
reference's standalone primitives (prefix scan, key/value sort, min/max and
sum reductions, gather/scatter, sorted-run offsets) are provided as jnp ops.

Unlike the reference (whose ``collision/__init__.py`` is empty and forces
submodule imports), the public surface is re-exported here.
"""

from .collider import (
    Collider,
    CollisionResult,
    collide,
    collide_exact,
)
from .columns import default_column_config
from .fill import candidate_count, run_fill
from .grid import GridCounts, build_grid, grid_count
from .sim import simulate
from .lbvh import LBVH, NO_NODE, build, leaf_bounds, refit
from .lbvh.traverse import (
    STACK_DEPTH,
    aabb_overlap,
    find_pairs,
    traverse_count,
    traverse_fill,
)
from .ops import (
    Bounds,
    Indexer,
    OffsetFinder,
    PrefixScanner,
    RadixSorter,
    Reducer,
    Summer,
    argsort_keys,
    exclusive_scan,
    expand_bits,
    find_offsets,
    gather,
    morton_encode,
    prefix_sum,
    reduce_values,
    scatter,
    scene_bounds,
    sort_key_value,
    sort_keys,
)
from .utils import next_power_of_2, product, round_up

__version__ = "0.2.0"

__all__ = [
    "Collider",
    "CollisionResult",
    "collide",
    "collide_exact",
    "default_column_config",
    "candidate_count",
    "run_fill",
    "GridCounts",
    "build_grid",
    "grid_count",
    "simulate",
    "LBVH",
    "NO_NODE",
    "build",
    "leaf_bounds",
    "refit",
    "STACK_DEPTH",
    "aabb_overlap",
    "find_pairs",
    "traverse_count",
    "traverse_fill",
    "Bounds",
    "Indexer",
    "OffsetFinder",
    "PrefixScanner",
    "RadixSorter",
    "Reducer",
    "Summer",
    "argsort_keys",
    "exclusive_scan",
    "expand_bits",
    "find_offsets",
    "gather",
    "morton_encode",
    "prefix_sum",
    "reduce_values",
    "scatter",
    "scene_bounds",
    "sort_key_value",
    "sort_keys",
    "next_power_of_2",
    "product",
    "round_up",
    "__version__",
]
