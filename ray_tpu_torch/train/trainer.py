"""TorchTrainer: the port's counterpart of `ray_tpu/train/trainer.py`'s
JaxTrainer.

`num_workers=1` runs the loop in this process with a session for
`report()` and checkpoints; a failed attempt is retried up to
`FailureConfig.max_failures` times and resumes from the trial dir's
latest checkpoint; `fit` returns only once every async checkpoint the
loop issued is durable. A gang of `num_workers > 1` needs the copied
actor runtime (`WorkerGroup`), and `datasets` the copied data runtime:
both raise instead of running locally.
"""

from __future__ import annotations

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
        self.backend_config = backend_config or {}
        if self.scaling_config.num_workers > 1:
            raise NotImplementedError(
                f"num_workers={self.scaling_config.num_workers}: the trainer "
                "gang needs WorkerGroup and the actor runtime, not copied "
                "into the port yet (ROADMAP queue 1, trainer gang)")
        if datasets:
            raise NotImplementedError(
                "datasets: the data runtime (ray_tpu.data) is not copied into "
                "the port yet (ROADMAP queue 1, trainer gang and datasets)")

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
        while True:
            try:
                return self._fit_local(name, storage)
            except Exception as e:  # noqa: BLE001
                attempt += 1
                if attempt > max_failures:
                    return Result(
                        metrics={}, checkpoint_path=None, error=e
                    )
                traceback.print_exc()

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
        session = init_session(context, result_callback=on_result)
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
