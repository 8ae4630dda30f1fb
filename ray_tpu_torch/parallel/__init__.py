"""Parallelism layer of the PyTorch/CUDA port (counterpart of
`ray_tpu/parallel`): named device meshes and logical sharding rules.

The JAX package's explicit collective API (`collective`), its pipeline
(`pipeline`) and its schedules (`schedule`) are not ported yet: they
belong to the parallelism slice (ROADMAP queue 1, item 8)."""

from .mesh import (
    AXES,
    MeshSpec,
    batch_size_per_host,
    data_axes,
    model_axes,
    single_host_mesh,
)
from .sharding import (
    ACT_RULES,
    PARAM_RULES,
    Annotated,
    annotate,
    placements_for,
    shard_tree,
    spec_for,
    tree_shardings,
)

__all__ = [
    "AXES",
    "MeshSpec",
    "single_host_mesh",
    "batch_size_per_host",
    "data_axes",
    "model_axes",
    "ACT_RULES",
    "PARAM_RULES",
    "Annotated",
    "annotate",
    "placements_for",
    "shard_tree",
    "spec_for",
    "tree_shardings",
]
