"""TorchTrainer: the port's counterpart of `ray_tpu/train/trainer.py`'s
JaxTrainer.

`num_workers=1` runs the loop in this process with a session for
`report()` and checkpoints. `num_workers > 1` runs it on a gang of the
port's runtime actors (`WorkerGroup`; call `ray_tpu_torch.init()`
first), joined by `TorchBackend` into one process group: NCCL, one card
per worker (`ScalingConfig.use_gpu`, the default), or gloo on the CPU.
The result holds rank 0's reports and checkpoint, and every rank's
reports (`Result.metrics_by_rank`). A failed attempt is retried up to
`FailureConfig.max_failures` times and resumes from the trial dir's
latest checkpoint; `fit` returns only once every async checkpoint the
loop issued is durable. `datasets` (`ray_tpu_torch.data` datasets) are
split once per trainer into one streaming shard per rank
(`streaming_split(world_size, equal=True)`); the loop reads its shard
with `get_dataset_shard` or `get_device_batches`.
"""

from __future__ import annotations

import gc
import inspect
import os
import tempfile
import traceback
from typing import Any, Callable, Dict, Optional

from .backend import Backend, TorchBackend
from .checkpoint import wait_for_checkpoints
from .config import Result, RunConfig, ScalingConfig
from .session import TrainContext, clear_session, init_session


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable[[Optional[dict]], Any],
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend: Optional[Backend] = None,
        backend_config: Optional[dict] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self._train_loop = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend = backend or TorchBackend()
        device = "cuda" if self.scaling_config.use_gpu else "cpu"
        self.backend_config = {"device": device, **(backend_config or {})}
        self.datasets = datasets or {}

    def fit(self) -> Result:
        max_failures = self.run_config.failure_config.max_failures
        name = self.run_config.name or "torch_trainer"
        # One storage dir for all attempts: retries find the previous
        # attempt's checkpoint marker there and resume from it.
        storage = self.run_config.storage_path or tempfile.mkdtemp(
            prefix=f"rtt_train_{name}_"
        )
        os.makedirs(storage, exist_ok=True)
        attempt = 0
        fit_once = (self._fit_local if self.scaling_config.num_workers <= 1
                    else self._fit_gang)
        while True:
            try:
                return fit_once(name, storage)
            except Exception as e:  # noqa: BLE001
                attempt += 1
                if attempt > max_failures:
                    return Result(
                        metrics={}, checkpoint_path=None, error=e
                    )
                traceback.print_exc()
            finally:
                # The attempt's model is dropped: free it now, though
                # FSDP2 holds it in reference cycles (`shard_module`).
                gc.collect()

    def _loop_args(self):
        return (
            (self._train_loop_config,)
            if self._train_loop_config is not None
            or self._takes_config()
            else ()
        )

    def _takes_config(self) -> bool:
        try:
            sig = inspect.signature(self._train_loop)
            return len(sig.parameters) > 0
        except (TypeError, ValueError):
            return False

    def _make_shards(self, world_size: int, rank: int) -> Dict[str, Any]:
        """Rank's streaming shard of each dataset, split once per trainer
        (as JaxTrainer's, ray_tpu/train/trainer.py:95-116; reference:
        DataConfig's streaming split)."""
        if not self.datasets:
            return {}
        if not hasattr(self, "_split_cache"):
            self._split_cache = {
                name: ds.streaming_split(world_size, equal=True)
                for name, ds in self.datasets.items()
            }
        return {name: splits[rank]
                for name, splits in self._split_cache.items()}

    def _make_gang_shards(self, world_size: int):
        if not self.datasets:
            return None
        return [self._make_shards(world_size, rank)
                for rank in range(world_size)]

    def _fit_local(self, name: str, storage: str) -> Result:
        """The loop runs here, with this process's mesh."""
        history = []

        def on_result(metrics, checkpoint):
            history.append(dict(metrics))

        context = TrainContext(
            world_rank=0,
            world_size=1,
            experiment_name=name,
            trial_dir=storage,
        )
        session = init_session(context, result_callback=on_result,
                               dataset_shards=self._make_shards(1, rank=0))
        try:
            self._train_loop(*self._loop_args())
        finally:
            clear_session()
            # Fit-exit durability barrier: async saves issued by the
            # loop must be on disk before fit() returns (or before a
            # retry attempt restores from them).
            wait_for_checkpoints()
        metrics = history[-1] if history else {}
        return Result(
            metrics=metrics,
            checkpoint_path=session.latest_checkpoint,
            metrics_history=history,
        )

    def _resources_per_worker(self) -> Dict[str, float]:
        resources = self.scaling_config.resources_per_worker
        if resources is not None:
            return dict(resources)
        return {"CPU": 1, "GPU": 1} if self.scaling_config.use_gpu else {"CPU": 1}

    def _fit_gang(self, name: str, storage: str) -> Result:
        """The loop on a gang of runtime actors (as JaxTrainer's
        `_fit_gang`, ray_tpu/train/trainer.py:152-179): the backend joins
        them into one process group, every rank runs the loop in a
        session of its own, and the result is rank 0's reports and
        checkpoint beside every rank's reports."""
        from .worker_group import WorkerGroup

        group = WorkerGroup(self.scaling_config.num_workers,
                            self._resources_per_worker())
        try:
            self.backend.on_start(group, self.backend_config)
            try:
                outs = group.run_train_loop(
                    self._train_loop, name, self._loop_args(),
                    trial_dir=storage,
                    dataset_shards_per_rank=self._make_gang_shards(
                        self.scaling_config.num_workers))
            finally:
                self.backend.on_shutdown(group)
        finally:
            group.shutdown()
        history = outs[0]["reported"]
        return Result(
            metrics=history[-1] if history else {},
            checkpoint_path=outs[0]["checkpoint"],
            metrics_history=history,
            metrics_by_rank=[out["reported"] for out in outs],
        )
