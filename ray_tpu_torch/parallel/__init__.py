"""Parallelism layer of the PyTorch/CUDA port (counterpart of
`ray_tpu/parallel`): named device meshes, logical sharding rules, the
explicit collectives over a mesh dimension's process group, the SPMD
GPipe pipeline, and the MPMD pipeline's schedules (`schedule`: 1F1B,
interleaved 1F1B, their validation and the layer partitioner; a copy of
the JAX package's pure-Python module)."""

from . import schedule
from .collective import (
    all_to_all,
    allgather,
    allreduce,
    axis_index,
    axis_size,
    barrier,
    broadcast,
    reducescatter,
    send_recv,
)
from .mesh import (
    AXES,
    PIPELINE_AXES,
    MeshSpec,
    batch_size_per_host,
    data_axes,
    model_axes,
    pipeline_mesh,
    single_host_mesh,
)
from .pipeline import (
    broadcast_from_last_stage,
    spmd_pipeline,
    stack_stage_params,
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
    "PIPELINE_AXES",
    "MeshSpec",
    "pipeline_mesh",
    "all_to_all",
    "allgather",
    "allreduce",
    "axis_index",
    "axis_size",
    "barrier",
    "broadcast",
    "reducescatter",
    "send_recv",
    "broadcast_from_last_stage",
    "spmd_pipeline",
    "stack_stage_params",
    "schedule",
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
