from .oracle import (
    blocked_collisions, brute_force_collisions, brute_force_count,
    pair_array_to_set,
)

__all__ = [
    "blocked_collisions", "brute_force_collisions", "brute_force_count",
    "pair_array_to_set",
]
