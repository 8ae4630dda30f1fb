"""Per-worker training session: report(), get_context(), checkpoints
(PyTorch port of `ray_tpu/train/session.py`).

User code calls `report(metrics, checkpoint=...)`, `get_context()` and
`get_checkpoint()` (for restore); a retried attempt finds the previous
attempt's latest checkpoint through the marker in the trial dir. The
dataset shards (`get_dataset_shard`, `get_device_batches`) wait for the
copied data runtime."""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .._private import step_telemetry

_CKPT_MARKER = ".latest_checkpoint"


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    trial_dir: Optional[str] = None
    mesh: Any = None  # the gang's DeviceMesh


class _Session:
    def __init__(
        self,
        context: TrainContext,
        result_callback=None,
        dataset_shards: Optional[Dict[str, Any]] = None,
    ):
        self.context = context
        self.results: List[Dict[str, Any]] = []
        self.latest_checkpoint: Optional[str] = None
        self._result_callback = result_callback
        self.dataset_shards = dataset_shards or {}
        self._lock = threading.Lock()
        # Step telemetry: report() is the per-step heartbeat of every
        # train loop, so it doubles as the step boundary — the wall
        # interval between consecutive reports, minus the wait phases
        # the data/H2D/checkpoint layers accumulated in that window,
        # is the step's own time.
        self._step_index = 0
        self._last_report_t = time.monotonic()
        # Drop phases accumulated on this thread BEFORE the session
        # existed (warmup/validation passes over instrumented
        # iterators): step 1 must not inherit their stall time.
        step_telemetry.take_phases()

    def report(
        self, metrics: Dict[str, Any], checkpoint: Optional[str] = None
    ) -> None:
        now = time.monotonic()
        with self._lock:
            self.results.append(dict(metrics))
            if checkpoint is not None:
                self.latest_checkpoint = checkpoint
                self._persist_marker(checkpoint)
            self._step_index += 1
            step = self._step_index
            wall_ms = (now - self._last_report_t) * 1e3
            self._last_report_t = now
        # An explicit step_ms metric (the loop timed its own step) wins
        # over the wall-minus-waits derivation.
        step_ms = metrics.get("step_ms")
        try:
            step_ms = None if step_ms is None else float(step_ms)
        except (TypeError, ValueError):
            step_ms = None
        # The first report's wall interval starts at session
        # construction, so everything train_func did before its loop
        # (model build, dataset setup) is inside it — a derived
        # step_ms would be setup time, not a step. Flag it so the
        # head's stats/skew (and the chrome trace) exclude it instead
        # of reporting setup noise as the cluster's max skew.
        warmup = step == 1 and step_ms is None
        step_telemetry.report_step(
            step,
            rank=self.context.world_rank,
            step_ms=step_ms,
            wall_ms=wall_ms,
            extra={"warmup": 1} if warmup else None,
        )
        if self._result_callback is not None:
            self._result_callback(metrics, checkpoint)

    def _persist_marker(self, checkpoint: str) -> None:
        """Record the latest checkpoint path in the trial dir so a
        restarted attempt (trainer retry / resumed experiment) can
        restore from it."""
        trial_dir = self.context.trial_dir
        if not trial_dir:
            return
        tmp = os.path.join(trial_dir, _CKPT_MARKER + ".tmp")
        try:
            with open(tmp, "w") as f:
                f.write(checkpoint)
            os.replace(tmp, os.path.join(trial_dir, _CKPT_MARKER))
        except OSError:
            pass


_session_holder = threading.local()


def init_session(
    context: TrainContext,
    result_callback=None,
    dataset_shards: Optional[Dict[str, Any]] = None,
) -> _Session:
    session = _Session(context, result_callback, dataset_shards)
    if context.trial_dir:
        # A retrying attempt in the same process may race its failed
        # predecessor's async checkpoint write: settle pending saves
        # before judging which marker paths exist on disk.
        from .checkpoint import wait_for_checkpoints

        wait_for_checkpoints()
        marker = os.path.join(context.trial_dir, _CKPT_MARKER)
        try:
            with open(marker) as f:
                path = f.read().strip()
            if path and os.path.exists(path):
                session.latest_checkpoint = path
        except OSError:
            pass
    _session_holder.session = session
    return session


def clear_session() -> None:
    _session_holder.session = None


def get_session() -> Optional[_Session]:
    return getattr(_session_holder, "session", None)


def report(metrics: Dict[str, Any], checkpoint: Optional[str] = None) -> None:
    """Report metrics (and optionally a checkpoint dir) from the train
    loop."""
    session = get_session()
    if session is None:
        raise RuntimeError(
            "report() called outside a training session"
        )
    session.report(metrics, checkpoint)


def get_context() -> TrainContext:
    session = get_session()
    if session is None:
        return TrainContext()
    return session.context


def get_checkpoint() -> Optional[str]:
    session = get_session()
    return session.latest_checkpoint if session else None


def get_dataset_shard(name: str = "train"):
    """This worker's streaming shard of the trainer's dataset: waits
    for the copied data runtime."""
    raise NotImplementedError(
        "get_dataset_shard: the data runtime (ray_tpu.data) is not copied "
        "into the port yet (ROADMAP queue 1, item 2, \"Data\")")


def get_device_batches(name: str = "train", **kwargs):
    """This rank's shard as device-resident batches: waits for the
    copied data runtime (`prefetch_to_device` over any host iterator
    works meanwhile)."""
    raise NotImplementedError(
        "get_device_batches: the data runtime (ray_tpu.data) is not copied "
        "into the port yet (ROADMAP queue 1, item 2, \"Data\"); "
        "prefetch_to_device takes any iterator of host batches")
