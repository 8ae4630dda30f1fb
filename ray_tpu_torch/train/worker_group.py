# Copied from ray_tpu/train/worker_group.py (JAX-free): module names read ray_tpu_torch, and the TPU resource is the GPU.
"""Gang of training workers as actors on the distributed runtime.

Reference anatomy: BackendExecutor creates a placement group + a
WorkerGroup of RayTrainWorker actors, sets ranks, and launches the
train loop on each (reference: train/_internal/backend_executor.py:135,
219, 369, 451; worker_group.py:19). Here the gang members are actors of
our own runtime; rank/world-size context is installed per worker and
functions are executed on all members in parallel.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from .. import api as rt
from ..actor import ActorHandle


class _TrainWorker:
    """Actor body running on each gang member (reference:
    train/_internal/worker_group.py RayTrainWorker)."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self._state = {}

    def run(self, fn, args=(), kwargs=None):
        return fn(*args, **(kwargs or {}))

    def run_with_context(
        self,
        fn,
        experiment_name="",
        args=(),
        trial_dir=None,
        dataset_shards=None,
    ):
        from .session import TrainContext, clear_session, init_session

        context = TrainContext(
            world_rank=self.rank,
            world_size=self.world_size,
            local_rank=self.rank,
            experiment_name=experiment_name,
            trial_dir=trial_dir,
        )
        session = init_session(context, dataset_shards=dataset_shards)
        try:
            result = fn(*args)
        finally:
            clear_session()
            # Fit-exit durability barrier, worker-side: this rank's
            # async checkpoint saves must persist before the gang
            # result (which names them) reaches the trainer.
            from .checkpoint import wait_for_checkpoints

            wait_for_checkpoints()
        return {
            "result": result,
            "reported": session.results,
            "checkpoint": session.latest_checkpoint,
        }


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Optional[dict] = None,
    ):
        self.size = num_workers
        options = dict(resources_per_worker or {})
        actor_cls = rt.remote(
            num_cpus=options.pop("CPU", 1),
            num_gpus=options.pop("GPU", 0),
            resources=options or None,
        )(_TrainWorker)
        self.workers: List[ActorHandle] = [
            actor_cls.remote(rank, num_workers)
            for rank in range(num_workers)
        ]

    def run_all(self, fn: Callable, args=(), kwargs=None) -> List[Any]:
        """Execute fn on every member; gather results (reference:
        backend_executor's start_training fan-out)."""
        refs = [
            w.run.remote(fn, args, kwargs or {}) for w in self.workers
        ]
        return rt.get(refs)

    def run_per_rank(
        self, fn: Callable, args_for_rank: Callable[[int], tuple]
    ) -> List[Any]:
        refs = [
            w.run.remote(fn, args_for_rank(rank))
            for rank, w in enumerate(self.workers)
        ]
        return rt.get(refs)

    def run_train_loop(
        self,
        fn: Callable,
        experiment_name="",
        args=(),
        trial_dir=None,
        dataset_shards_per_rank=None,
    ):
        refs = [
            w.run_with_context.remote(
                fn,
                experiment_name,
                args,
                trial_dir,
                dataset_shards_per_rank[rank]
                if dataset_shards_per_rank
                else None,
            )
            for rank, w in enumerate(self.workers)
        ]
        return rt.get(refs)

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:
                pass
