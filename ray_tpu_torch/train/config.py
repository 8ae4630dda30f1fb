"""Shared training configs (PyTorch port of `ray_tpu/train/config.py`):
ScalingConfig / RunConfig / CheckpointConfig / FailureConfig dataclasses
consumed by Trainer.fit, and the Result it returns."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..parallel.mesh import MeshSpec


@dataclasses.dataclass
class ScalingConfig:
    """How to scale training.

    The unit of scale is a device mesh: `num_workers` is the number of
    processes in the gang (1 = this process; more are actors of the
    port's runtime, one card each when `use_gpu`, else on the CPU); `mesh` is the gang's parallelism layout, one card
    per rank; `resources_per_worker` feeds the placement-group request
    when the gang is scheduled on a cluster.
    """

    num_workers: int = 1
    use_gpu: bool = True
    mesh: Optional[MeshSpec] = None
    resources_per_worker: Optional[Dict[str, float]] = None

    def resolved_mesh(self) -> MeshSpec:
        return self.mesh if self.mesh is not None else MeshSpec.auto()


@dataclasses.dataclass
class CheckpointConfig:
    """Keep-last-k retention."""

    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0  # steps; 0 = only on report()


@dataclasses.dataclass
class FailureConfig:
    """How many failed attempts `fit` retries."""

    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    """Name, storage and fault tolerance of a run."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig
    )


@dataclasses.dataclass
class Result:
    """What Trainer.fit returns."""

    metrics: Dict[str, Any]
    checkpoint_path: Optional[str]
    error: Optional[BaseException] = None
    metrics_history: list = dataclasses.field(default_factory=list)
    #: A gang's reports, one history per rank (rank 0's is
    #: `metrics_history`); empty for a loop run in this process.
    metrics_by_rank: list = dataclasses.field(default_factory=list)
