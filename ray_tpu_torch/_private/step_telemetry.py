# Copied from ray_tpu/_private/step_telemetry.py (JAX-free), whole: module
# names read ray_tpu_torch, and `report_step` sends its records down the
# copied runtime's metrics pipe, with HBM from `compile_watch.device_memory`.
"""Per-step, per-worker train-loop telemetry (runtime core).

PR 4 proved the input pipeline and checkpointing can be driven off the
step's critical path — but only bench.py could SHOW it. This module
moves that attribution into the runtime, always on: the data plane
(data/dataset.py), the H2D prefetcher (train/train_step.py), and the
checkpoint writer (train/checkpoint.py) accumulate per-phase wall time
into a thread-local, and the session's per-step report() folds them
into ONE record per (step index, worker rank):

    {step, rank, wall_ms, data_wait_ms, h2d_ms, ckpt_block_ms,
     step_ms, ckpt_inflight}

Records ride the existing metrics pipe (util/metrics._Buffer — one
batched RPC every 0.5 s, nothing per step) as kind="step" and land in
the head's step ring, where `step_summary` computes gang-step skew
(max - min step_ms across workers of the same step index) — the
number that answers "why is step N slow, and which worker is the
straggler" (PAPERS: Podracer architectures; per-stage timing
attribution per arXiv 2412.14374).

Lives in _private so the runtime can import it without dragging in
the torch-importing train package; `ray_tpu_torch.train.telemetry`
re-exports the user-facing surface.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "add_phase",
    "take_phases",
    "phase_timer",
    "timed_iter",
    "report_step",
    "steps_to_chrome_trace",
    "goodput_from_records",
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


#: Phase layout order inside a step slice: the waits the loop paid
#: before/around the step, then the step itself. send/recv wait are
#: the MPMD pipeline's channel-blocked time (dag/edges.py bills them)
#: — the per-stage bubble attribution the pipeline doctor reads.
#: queue_wait is the decoupled RL dataflow's rollout-queue stall
#: (rl/dataflow.py bills it) — the learner starving on rollouts,
#: billed exactly like a trainer starving on input (data_wait);
#: weight_sync is its drainless weight-publish stall. compile is XLA
#: trace+compile time (_private/compile_watch.py bills it on digest
#: misses) — the cold-compile step's cost, attributed instead of
#: masquerading as a giant step_ms. get_wait is object-plane blocked
#: time: rt.get() waits billed by worker._record_get with the
#: resolution's provenance (pull vs restore vs local — the transfer
#: matrix says which), only when no enclosing phase already measures
#: the same wall (see stalls_active).
_TRACE_PHASES = (
    "data_wait_ms",
    "get_wait_ms",
    "queue_wait_ms",
    "h2d_ms",
    "ckpt_block_ms",
    "weight_sync_ms",
    "send_wait_ms",
    "recv_wait_ms",
    "compile_ms",
    "step_ms",
)


def steps_to_chrome_trace(records) -> list:
    """Per-step, per-rank phase records (the head's step ring) ->
    chrome trace 'X' slices: one row per worker rank, one slice per
    phase, consecutive steps of a rank laid end-to-end. Timestamps
    are synthesized (records carry durations plus the head's arrival
    time — which is the BATCH arrival, shared by every step delivered
    in one metrics flush, so arrival times alone would stack a
    flush's steps on top of each other) — widths and per-rank
    alignment are the signal, matching what gang-skew diagnosis
    needs."""
    by_rank: dict = {}
    for rec in records:
        by_rank.setdefault(int(rec.get("rank", 0)), []).append(rec)
    trace = []
    for rank, recs in sorted(by_rank.items()):
        recs.sort(
            key=lambda r: (
                int(r.get("step", 0)),
                float(r.get("time", 0.0)),
            )
        )
        cursor_us = None
        for rec in recs:
            step = int(rec.get("step", 0))
            # Warmup (first-report) records anchor their wall at
            # session construction and derive step_ms from it — both
            # setup-dominated; laying either out would draw a giant
            # phantom step-1 slice. Draw only the measured waits.
            if rec.get("warmup"):
                trace_phases = _TRACE_PHASES[:-1]
                wall_ms = 0.0
            else:
                trace_phases = _TRACE_PHASES
                wall_ms = float(rec.get("wall_ms", 0.0) or 0.0)
            if wall_ms <= 0.0:
                wall_ms = sum(
                    float(rec.get(p, 0.0) or 0.0)
                    for p in trace_phases
                )
            if cursor_us is None:
                end_t = float(rec.get("time", 0.0))
                cursor_us = (end_t - wall_ms / 1e3) * 1e6
            step_start_us = cursor_us
            for phase in trace_phases:
                dur_ms = float(rec.get(phase, 0.0) or 0.0)
                if dur_ms <= 0.0:
                    continue
                trace.append(
                    {
                        "name": f"step {step} {phase[:-3]}",
                        "cat": "step",
                        "ph": "X",
                        "ts": cursor_us,
                        "dur": max(1.0, dur_ms * 1e3),
                        "pid": "steps",
                        "tid": f"rank {rank}",
                        "args": {"step": step, "rank": rank},
                    }
                )
                cursor_us += dur_ms * 1e3
            # Steps whose phases undershoot the wall interval still
            # advance a full wall window — the gap IS unattributed
            # time, not overlap.
            cursor_us = max(
                cursor_us, step_start_us + wall_ms * 1e3
            )
    return trace


#: Wait phases that classify as stall time in goodput accounting.
#: send/recv wait are pipeline-channel blocked time: for an MPMD
#: stage, that IS the (bubble + transport) share of its wall.
#: queue_wait/weight_sync are the RL dataflow's consume-side stalls —
#: a learner whose goodput is eaten by queue_wait is runner-bound,
#: one eaten by weight_sync is sync-bound (doctor's verdict.rl reads
#: the same attribution from the rl_* series).
#: compile is XLA's share of the wall: a loop whose goodput is eaten
#: by compile_ms is recompiling (see verdict.compile), not slow.
#: get_wait is the object plane's share: goodput eaten here means the
#: loop blocks on rt.get — /api/transfers says whether those bytes
#: were pulls, restores, or misplacement (README runbook).
_STALL_PHASES = (
    "data_wait_ms",
    "get_wait_ms",
    "queue_wait_ms",
    "h2d_ms",
    "ckpt_block_ms",
    "weight_sync_ms",
    "send_wait_ms",
    "recv_wait_ms",
    "compile_ms",
)


def goodput_from_records(records) -> Dict[str, dict]:
    """Classify each job's reported step wall clock into productive
    vs stall time (PAPERS: the Gemma-on-TPU serving/fine-tuning
    comparison hinges on sustained-throughput accounting — goodput is
    its training-side analog).

    Per job: ``wall_ms`` = sum of non-warmup step walls, split into
    ``productive_ms`` (step compute), per-phase ``stalls``
    (`data_wait`/`h2d`/`ckpt_block`) and ``idle_ms`` (wall the phases
    don't attribute). By construction productive + stall + idle == wall
    exactly: phases are capped at the wall they sit inside (the same
    cap `report_step` applies), so the goodput fraction is a true
    fraction of measured wall clock, never >1 and never negative.

    Warmup records (session setup) and records with no wall anchor
    (hand-rolled `report_step(step_ms=...)` without `wall_ms`) carry
    no usable wall interval and are skipped; `steps` counts what was
    actually classified.
    """
    jobs: Dict[str, dict] = {}
    for rec in records:
        if rec.get("warmup"):
            continue
        try:
            wall = float(rec.get("wall_ms", 0.0) or 0.0)
        except (TypeError, ValueError):
            continue
        if wall <= 0.0:
            continue
        job = str(rec.get("job", ""))
        row = jobs.setdefault(
            job,
            {
                "steps": 0,
                "wall_ms": 0.0,
                "productive_ms": 0.0,
                "stall_ms": 0.0,
                "idle_ms": 0.0,
                "stalls": {p: 0.0 for p in _STALL_PHASES},
            },
        )
        stall = 0.0
        for phase in _STALL_PHASES:
            try:
                ms = float(rec.get(phase, 0.0) or 0.0)
            except (TypeError, ValueError):
                ms = 0.0
            # A stall inside this step's wall cannot exceed the wall
            # REMAINING after the stalls already counted.
            ms = max(0.0, min(ms, wall - stall))
            row["stalls"][phase] += ms
            stall += ms
        try:
            productive = float(rec.get("step_ms", 0.0) or 0.0)
        except (TypeError, ValueError):
            productive = 0.0
        productive = max(0.0, min(productive, wall - stall))
        row["steps"] += 1
        row["wall_ms"] += wall
        row["productive_ms"] += productive
        row["stall_ms"] += stall
        row["idle_ms"] += wall - stall - productive
    for row in jobs.values():
        wall = row["wall_ms"]
        row["goodput"] = round(
            row["productive_ms"] / wall if wall > 0 else 0.0, 4
        )
        for key in ("wall_ms", "productive_ms", "stall_ms", "idle_ms"):
            row[key] = round(row[key], 3)
        row["stalls"] = {
            p: round(v, 3) for p, v in row["stalls"].items()
        }
    return jobs


def report_step(
    step: int,
    *,
    rank: int = 0,
    step_ms: Optional[float] = None,
    wall_ms: Optional[float] = None,
    extra: Optional[dict] = None,
) -> None:
    """Emit one per-step phase record through the metrics pipe.

    Called by the session on every train.report(); usable directly
    from hand-rolled loops — which should call take_phases() once
    before their loop starts, so stall time accumulated during setup
    is not billed to the first step. `step_ms` defaults to the wall
    interval minus the accumulated wait phases — the residual that IS
    the step's compute + dispatch. Outside a session (no initialized
    worker) the accumulated phases are dropped silently: telemetry
    must never make a unit test need a cluster.
    """
    from .worker import global_worker

    worker = global_worker()
    if worker is None:
        take_phases()
        return
    phases = take_phases()
    if wall_ms is not None:
        # A consumer-visible stall inside this step's wall interval
        # cannot exceed the interval — excess is accumulation from
        # BEFORE the loop (a hand-rolled loop that skipped the
        # take_phases() baseline drain); billing it would misdirect
        # the input-pipeline-vs-step runbook decision.
        cap = max(0.0, float(wall_ms))
        for name in phases:
            if phases[name] > cap:
                phases[name] = cap
    # pid + node identify the REPORTING PROCESS: the doctor reads
    # them as its liveness signal (a worker with a recent step record
    # is progressing — its long-lived fit task is not hung). `job`
    # keeps step stats from different training jobs apart — the
    # head's summary is computed per job, never over a mixture.
    record: Dict[str, Any] = {
        "rank": int(rank),
        "pid": os.getpid(),
        "node": worker.node_id.hex(),
        "job": worker.job_id.hex(),
    }
    # The executing task's id (thread-local): lets the doctor exempt
    # exactly the reporting train-loop task, not everything that
    # happens to share its process (a concurrent actor's OTHER call
    # may be genuinely hung).
    task_id = getattr(worker._ctx, "task_id", None)
    if task_id is not None:
        record["task"] = task_id.hex()
    for name, ms in phases.items():
        record[name] = round(ms, 3)
    if wall_ms is not None:
        record["wall_ms"] = round(float(wall_ms), 3)
    if step_ms is None and wall_ms is not None:
        step_ms = max(
            0.0,
            float(wall_ms)
            - sum(phases.get(p, 0.0) for p in _STALL_PHASES),
        )
    try:
        record["step_ms"] = round(float(step_ms or 0.0), 3)
    except (TypeError, ValueError):
        record["step_ms"] = 0.0
    try:
        from ..train.checkpoint import pending_checkpoints

        record["ckpt_inflight"] = len(pending_checkpoints())
    except Exception:
        pass
    if extra:
        record.update(extra)
    from ..util.metrics import _Buffer

    buf = _Buffer.get()
    # Per-rank HBM occupancy from device.memory_stats(), folded into
    # the same step record (and exported as (job, rank)-labeled
    # gauges — both bounded, and without the job label two jobs'
    # same-numbered ranks would clobber one series). None on CPU or
    # when the runtime exposes no stats: the fields are ABSENT, never
    # fake zeros that would read as "no pressure".
    from .compile_watch import device_memory

    hbm = device_memory()
    if hbm:
        hbm_tags = (
            ("job", record["job"]),
            ("rank", str(int(rank))),
        )
        for key, value in hbm.items():
            record[key] = int(value)
            buf.push(
                ("gauge", "rt_" + key, float(value), hbm_tags)
            )
    buf.push(
        (
            "step",
            "train_step",
            float(step),
            tuple(sorted(record.items())),
        )
    )
