from .sharded import collide_sharded, make_sharded_collider
from .sharded_fill import fill_sharded, make_sharded_fill

__all__ = [
    "collide_sharded",
    "make_sharded_collider",
    "fill_sharded",
    "make_sharded_fill",
]
