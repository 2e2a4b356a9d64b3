"""Mesh sharding and multi-card / multi-process execution."""

from .distributed import distributed_config, initialize_distributed
from .mesh import (DATA_AXIS, SPACE_AXIS, frame_sharding, grade_on_mesh,
                   make_mesh, pad_to_multiple, replicated, shard_clip)

__all__ = [
    "DATA_AXIS", "SPACE_AXIS", "frame_sharding", "grade_on_mesh",
    "make_mesh", "pad_to_multiple", "replicated", "shard_clip",
    "distributed_config", "initialize_distributed",
]
