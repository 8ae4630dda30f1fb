"""Training of the PyTorch/CUDA port (counterpart of `ray_tpu/train`):
TorchTrainer, the sharded train step, sessions, backends and
checkpointing.

`make_train_step` lays a model out on every `MeshSpec` axis but pp
(dcn_dp, dp, fsdp, sp, tp; MoE models included);
`make_pp_train_step` is the pipeline-parallel step (pp x sp x ep);
`MPMDPipeline` the multi-program pipeline (1F1B stage actors of the
runtime over channel edges, `mpmd_pipeline.py`).

`TorchTrainer(num_workers > 1)` runs on a `WorkerGroup` of the port's
runtime actors (`worker_group.py`, copied), joined by `TorchBackend`.

`telemetry` (copied from `ray_tpu/train/telemetry.py`) is the
step-telemetry surface for hand-rolled loops and the head-side queries
(`step_summary`, `step_records`). Every program the steps run is registered with the
compile watch under the JAX package's names (`train.step`,
`train.pp_step`, `mpmd.s<stage>.<key>`, ...).

Not ported yet: datasets (ROADMAP queue 1, item 2)."""

from .backend import Backend, TorchBackend, init_torch_distributed, run_local_gang
from .checkpoint import (
    CheckpointManager,
    load_metadata,
    pending_checkpoints,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from .config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from .mpmd_pipeline import MPMDPipeline, MPMDPipelineError
from .pipeline_step import make_pp_train_step, stage_module, to_pipeline_params
from .session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_device_batches,
    report,
)
from .train_step import (
    SGD,
    TrainState,
    default_optimizer,
    make_train_step,
    prefetch_to_device,
    shard_batch,
)
from . import telemetry
from .trainer import TorchTrainer

__all__ = [
    "TorchTrainer",
    "ScalingConfig",
    "RunConfig",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "Backend",
    "TorchBackend",
    "init_torch_distributed",
    "run_local_gang",
    "TrainState",
    "make_train_step",
    "make_pp_train_step",
    "MPMDPipeline",
    "MPMDPipelineError",
    "stage_module",
    "to_pipeline_params",
    "default_optimizer",
    "SGD",
    "shard_batch",
    "prefetch_to_device",
    "report",
    "get_context",
    "get_checkpoint",
    "get_dataset_shard",
    "get_device_batches",
    "save_checkpoint",
    "restore_checkpoint",
    "load_metadata",
    "wait_for_checkpoints",
    "pending_checkpoints",
    "CheckpointManager",
    "telemetry",
]
