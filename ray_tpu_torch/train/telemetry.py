# Copied from ray_tpu/train/telemetry.py.
"""User-facing step-telemetry surface.

The runtime core lives in `_private/step_telemetry.py` (importable
from the data layer without pulling in jax); this module re-exports it
for train-loop authors and adds the head-side queries:

    report_step(step, rank=..., step_ms=...)  # hand-rolled loops
    step_summary()  # gang-step skew + per-worker stats
    step_records()  # raw per-step, per-rank phase records

Sessions created by the trainer emit records automatically on every
`train.report()` — these APIs are for loops that bypass the session
and for reading the head's aggregation back.
"""

from __future__ import annotations

from typing import List

from .._private.step_telemetry import (  # noqa: F401 — re-exports
    add_phase,
    phase_timer,
    report_step,
    steps_to_chrome_trace,
    take_phases,
    timed_iter,
)

__all__ = [
    "add_phase",
    "take_phases",
    "phase_timer",
    "timed_iter",
    "report_step",
    "steps_to_chrome_trace",
    "step_summary",
    "step_records",
]


def _worker():
    from .. import exceptions as exc
    from .._private.worker import global_worker

    worker = global_worker()
    if worker is None:
        raise exc.RayTpuError("ray_tpu_torch.init() has not been called")
    return worker


def _flush_local() -> None:
    # Best-effort pre-read flush so records emitted this instant are
    # visible; a transient delivery failure requeues the batch for
    # the background flusher instead of failing the read.
    from ..util.metrics import flush_best_effort

    flush_best_effort()


def step_summary(limit: int = 1000) -> dict:
    """Head-side digest of the step telemetry: per-worker step-time
    stats and per-step gang skew (max - min step_ms across workers of
    the same step index)."""
    _flush_local()
    return _worker().call("step_summary", limit=limit)["summary"]


def step_records(limit: int = 1000) -> List[dict]:
    """Raw per-step, per-rank phase records from the head's ring."""
    _flush_local()
    return _worker().call("step_summary", limit=limit, records=True)[
        "records"
    ]
