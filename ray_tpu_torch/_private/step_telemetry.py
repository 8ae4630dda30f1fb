"""Per-step train-loop telemetry: a copy of `add_phase`, `take_phases`,
`phase_timer`, `stalls_active`, `timed_iter` and `report_step` from
`ray_tpu/_private/step_telemetry.py` (the port imports nothing of
`ray_tpu`).

The prefetcher (`train/train_step.py`) and the checkpoint writer
(`train/checkpoint.py`) accumulate per-phase wall time (`h2d_ms`,
`data_wait_ms`, `ckpt_block_ms`) into a thread-local, and the session's
per-step `report()` hands them to `report_step`. In the JAX package
`report_step` sends one record per (step, rank) down the worker's
metrics pipe to the head; without a worker it drops them. The port has
no worker yet (the actor runtime is not copied, ROADMAP queue 1), so
its `report_step` always drops them.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "add_phase",
    "take_phases",
    "phase_timer",
    "timed_iter",
    "report_step",
    "stalls_active",
]

_tl = threading.local()


def _phases() -> Dict[str, float]:
    phases = getattr(_tl, "phases", None)
    if phases is None:
        phases = _tl.phases = {}
    return phases


def add_phase(name: str, ms: float) -> None:
    """Accumulate `ms` of wall time into the current thread's phase
    bucket (drained by the next report_step on this thread)."""
    phases = _phases()
    phases[name] = phases.get(name, 0.0) + float(ms)


def take_phases() -> Dict[str, float]:
    """Pop-and-reset the current thread's accumulated phases.

    Also the baseline drain for hand-rolled loops: call it once right
    before the step loop starts so stall time accumulated during setup
    (preprocessing passes over instrumented iterators) is not billed
    to the first step's report_step(). Sessions do this automatically
    at construction."""
    phases = getattr(_tl, "phases", None)
    _tl.phases = {}
    return phases or {}


class phase_timer:
    """Context manager billing a consumer-visible stall into `phase`.

    Reentrancy-safe per (thread, phase): only the OUTERMOST active
    timer records. An inner timed region — e.g. a telemetry-wrapped
    iterator pulled through a user's generator transform into
    prefetch_to_device — is already inside the outer timer's wall,
    and billing both would double-count the same stall (driving the
    derived step_ms = wall - waits negative)."""

    __slots__ = ("_phase", "_outer", "_t0")

    def __init__(self, phase: str):
        self._phase = phase

    def __enter__(self) -> "phase_timer":
        depths = getattr(_tl, "depths", None)
        if depths is None:
            depths = _tl.depths = {}
        self._outer = not depths.get(self._phase)
        depths[self._phase] = depths.get(self._phase, 0) + 1
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _tl.depths[self._phase] -= 1
        # Exhaustion (StopIteration) and errors don't bill the phase.
        if self._outer and exc_type is None:
            add_phase(
                self._phase, (time.monotonic() - self._t0) * 1e3
            )
        return False


def stalls_active() -> bool:
    """True when any phase_timer is currently open on this thread.

    The worker's get path uses this to bill ``get_wait_ms`` only when
    no enclosing instrumented phase (data_wait, h2d, send/recv, ...)
    is already measuring the same wall — otherwise a get() issued
    inside a timed data iterator would be billed twice and the phases
    would stop partitioning the step wall."""
    depths = getattr(_tl, "depths", None)
    return bool(depths) and any(depths.values())


class _TimedIterator:
    """Iterator wrapper accumulating the consumer-visible blocked time
    of each next() into a named phase. The wrap happens at the
    OUTERMOST boundary (post-prefetch), so what's measured is the
    stall the train loop actually pays, not producer-side work that
    overlapped compute. Stacked instrumentation (prefetch_to_device,
    or a user transform over one of these) never double-counts
    because every layer times through the reentrancy-guarded
    phase_timer."""

    def __init__(self, iterator: Iterator[Any], phase: str):
        self._it = iter(iterator)
        self._phase = phase

    def __iter__(self) -> "_TimedIterator":
        return self

    def __next__(self) -> Any:
        with phase_timer(self._phase):
            return next(self._it)

    def close(self) -> None:
        # Cascading cancellation (dataset._prefetched relies on it).
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


def timed_iter(
    iterator: Iterator[Any], phase: str = "data_wait_ms"
) -> _TimedIterator:
    return _TimedIterator(iterator, phase)


def report_step(
    step: int,
    *,
    rank: int = 0,
    step_ms: Optional[float] = None,
    wall_ms: Optional[float] = None,
    extra: Optional[dict] = None,
) -> None:
    """Drop the phases accumulated on this thread since the last step,
    as the JAX package's `report_step` does outside a worker: the pipe
    to the head waits for the copied runtime."""
    take_phases()
