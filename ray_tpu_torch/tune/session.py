# Copied from ray_tpu/tune/session.py (JAX-free).
"""In-trial session: tune.report / tune.get_checkpoint.

Reference: ray.tune function-trainable session (python/ray/tune/
trainable/function_trainable.py) — the user function runs on a thread
inside the trial actor; report() hands a result to the controller and
blocks until the controller decides; a stop decision surfaces as
StopTrial at the next report call.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional


class StopTrial(Exception):
    """Raised inside the trainable when the scheduler stops the trial;
    the runner thread exits cleanly."""


class _TrialSession(threading.local):
    def __init__(self):
        self.active: Optional["TrialRuntime"] = None


_session = _TrialSession()


class TrialRuntime:
    """Lives inside the trial actor; bridges the trainable thread and
    the controller's polling."""

    def __init__(self, checkpoint: Optional[Dict[str, Any]] = None):
        # maxsize=1 makes report() block until the controller drains
        # the result — the reference's rendezvous semantics, without
        # which fast trials outrun the scheduler's stop decisions.
        self.results: "queue.Queue[dict]" = queue.Queue(maxsize=1)
        self.stop_requested = threading.Event()
        self.checkpoint_in = checkpoint
        self.latest_checkpoint: Optional[Dict[str, Any]] = checkpoint
        self.iteration = 0

    def report(
        self,
        metrics: Dict[str, Any],
        checkpoint: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.iteration += 1
        out = dict(metrics)
        out.setdefault("training_iteration", self.iteration)
        if checkpoint is not None:
            self.latest_checkpoint = dict(checkpoint)
        out["__has_checkpoint__"] = self.latest_checkpoint is not None
        self.results.put(out)
        if self.stop_requested.is_set():
            raise StopTrial()


def report(
    metrics: Dict[str, Any],
    *,
    checkpoint: Optional[Dict[str, Any]] = None,
) -> None:
    """Report one iteration's metrics (and optionally a checkpoint
    dict) from inside a trainable."""
    if _session.active is None:
        raise RuntimeError(
            "tune.report() called outside a Tune trial"
        )
    _session.active.report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Dict[str, Any]]:
    """Checkpoint to resume from (set when the trial was restored or
    cloned by PBT), else None."""
    if _session.active is None:
        return None
    return _session.active.checkpoint_in


def set_active(runtime: Optional[TrialRuntime]) -> None:
    _session.active = runtime
