"""The distributed layer: the shard mesh, the all-to-all shuffle, the
distributed operators, the multi-process runtime and the per-stage
checkpoints (port of the JAX package's ``parallel/``)."""

from .dist_ops import (
    DistTable,
    collect,
    dist_aggregate,
    dist_distinct,
    dist_hash_join,
    dist_sort,
    distribute,
)
from .mesh import SHARD_AXIS, make_host_chip_mesh, make_mesh, mesh_size

__all__ = [
    "DistTable",
    "distribute",
    "collect",
    "dist_distinct",
    "dist_hash_join",
    "dist_aggregate",
    "dist_sort",
    "make_mesh",
    "make_host_chip_mesh",
    "mesh_size",
    "SHARD_AXIS",
]
