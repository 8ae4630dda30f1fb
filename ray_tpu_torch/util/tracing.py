# Copied from ray_tpu/util/tracing.py (JAX-free): module names read ray_tpu_torch.
"""Chrome-trace timeline export.

Reference: `ray.timeline()` builds a chrome://tracing JSON from the
per-task state-transition events batched into GcsTaskManager
(core_worker/task_event_buffer.h). Our head records the same
transitions (daemon _record_task_event); this module folds them into
duration events: one slice per task from its first RUNNING-adjacent
state to its final state.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import List, Optional

_BEGIN_STATES = {
    "PENDING_ARGS_AVAIL",
    "FORWARDED",
    "PENDING_NODE_ASSIGNMENT",
    # Re-queue transitions: a retried/reconstructing task is waiting
    # to be scheduled again — that wait is queue time, not runtime.
    "RETRY",
    "RECONSTRUCTING",
}
#: Transitions that put an already-dispatched task BACK in the queue:
#: the lifecycle splits into attempts here, each with its own slice
#: and queue accounting (one slice across a retry would bill the
#: reschedule wait as runtime).
_REQUEUE_STATES = {"RETRY", "RECONSTRUCTING"}
_END_STATES = {"FINISHED", "FAILED", "DONE"}


def timeline_to_chrome_trace(
    events: List[dict], path: Optional[str] = None
) -> List[dict]:
    """Fold task state events into chrome trace 'X' slices; returns the
    trace (and writes JSON to `path` when given)."""
    by_task = defaultdict(list)
    for event in events:
        by_task[event["task_id"]].append(event)
    trace = []
    for task_id, task_events in by_task.items():
        task_events.sort(key=lambda e: e["time"])
        # Split the lifecycle into attempts at re-queue transitions,
        # then anchor each attempt's slice at its first
        # RUNNING-adjacent event: a single slice from submission to
        # completion would bill queue time (PENDING_*/FORWARDED, and
        # any RETRY reschedule wait) as runtime. Queue time is still
        # reported — as each slice's own arg, not inside it.
        attempts: List[List[dict]] = [[]]
        for e in task_events:
            if e["state"] in _REQUEUE_STATES and attempts[-1]:
                # The requeue event both CLOSES the running attempt
                # (its end timestamp) and OPENS the next one's queue
                # period.
                attempts[-1].append(e)
                attempts.append([])
            attempts[-1].append(e)
        for idx, attempt in enumerate(attempts):
            submitted = attempt[0]
            start = next(
                (
                    e
                    for e in attempt
                    if e["state"] not in _BEGIN_STATES
                ),
                None,
            )
            end = next(
                (e for e in attempt if e["state"] in _END_STATES),
                attempt[-1],
            )
            if start is None:
                # This attempt never left the queue: its whole span
                # is queue time, not runtime — render a minimal
                # marker slice at its start so nothing reads as
                # execution.
                start = submitted
                queued_us = max(
                    0.0, (end["time"] - submitted["time"]) * 1e6
                )
                duration_us = 1.0
            else:
                queued_us = max(
                    0.0, (start["time"] - submitted["time"]) * 1e6
                )
                duration_us = max(
                    1.0, (end["time"] - start["time"]) * 1e6
                )
            args = {
                "task_id": task_id,
                "final_state": end["state"],
                "queued_us": round(queued_us, 1),
                "states": [e["state"] for e in attempt],
            }
            if len(attempts) > 1:
                args["attempt"] = idx + 1
                args["attempts"] = len(attempts)
            trace.append(
                {
                    "name": task_events[0].get("name")
                    or task_events[0].get("kind", "task"),
                    "cat": task_events[0].get("kind", "task"),
                    "ph": "X",
                    "ts": start["time"] * 1e6,
                    "dur": duration_us,
                    "pid": "cluster",
                    "tid": task_id[:8],
                    "args": args,
                }
            )
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def export_timeline(path: str) -> List[dict]:
    """`ray.timeline(filename=...)` equivalent: fetch events from the
    head and write a chrome trace."""
    import ray_tpu_torch

    return timeline_to_chrome_trace(ray_tpu_torch.timeline(), path)


# ---------------------------------------------------------------------
# Distributed spans with OTLP-JSON export (reference: ray's OTel
# integration, python/ray/util/tracing/ — spans around task submit and
# execution with remote context propagation). Self-contained: the OTLP
# wire shape is produced directly, no opentelemetry SDK needed, so any
# OTLP/JSON-ingesting backend (collector file receiver, Tempo, Jaeger)
# reads the export.
# ---------------------------------------------------------------------

import contextvars
import os as _os
import time as _time
from contextlib import contextmanager

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "rt_current_span", default=None
)


class SpanContext:
    __slots__ = ("trace_id", "span_id", "attributes")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id
        #: Mutable: add_span_attributes() writes here until span exit.
        self.attributes: dict = {}


def add_span_attributes(**attributes) -> None:
    """Attach attributes to the CURRENT span (exported at its exit).
    No-op outside any span — callers never need to guard."""
    ctx = _current_span.get()
    if ctx is not None and hasattr(ctx, "attributes"):
        ctx.attributes.update(
            {str(k): str(v) for k, v in attributes.items()}
        )


def current_span_context() -> "SpanContext | None":
    return _current_span.get()


def _rand_hex(nbytes: int) -> str:
    return _os.urandom(nbytes).hex()


def _record_span(record: dict) -> None:
    """Ship one finished span to the head's DEDICATED span ring (not
    the task-event ring: sharing one deque would let busy task streams
    evict spans — and vice versa — and force every event consumer to
    filter foreign records)."""
    from .._private.worker import global_worker

    worker = global_worker()
    if worker is None:
        return
    try:
        worker._client.notify("span_event", spans=[record])
    except Exception:
        pass


@contextmanager
def span(name: str, **attributes):
    """Open a span; nests under the current one (including a parent
    propagated from a remote caller). Usable in drivers and tasks."""
    parent = _current_span.get()
    ctx = SpanContext(
        parent.trace_id if parent else _rand_hex(16), _rand_hex(8)
    )
    start = _time.time_ns()
    token = _current_span.set(ctx)
    error = None
    try:
        yield ctx
    except BaseException as e:  # noqa: BLE001 — recorded then re-raised
        error = repr(e)
        raise
    finally:
        _current_span.reset(token)
        _record_span({
            "name": name,
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent_span_id": parent.span_id if parent else "",
            "start_ns": start,
            "end_ns": _time.time_ns(),
            "attributes": {
                **{str(k): str(v) for k, v in attributes.items()},
                **ctx.attributes,
                **({"error": error} if error else {}),
            },
        })


def inject_context() -> "dict | None":
    """Wire-shippable form of the CURRENT span context — exactly the
    dict `remote_parent()` adopts on the receiving side. None outside
    any span, so callers can ship it unconditionally (serve's router
    attaches it to every request context)."""
    ctx = _current_span.get()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


@contextmanager
def remote_parent(trace_ctx: "dict | None"):
    """Adopt a caller-propagated span context (worker-side, around
    task execution)."""
    if not trace_ctx:
        yield
        return
    token = _current_span.set(
        SpanContext(trace_ctx["trace_id"], trace_ctx["span_id"])
    )
    try:
        yield
    finally:
        _current_span.reset(token)


def _otlp_value(v: str) -> dict:
    return {"stringValue": v}


def spans_to_otlp(records) -> dict:
    """Span records -> one OTLP/JSON ExportTraceServiceRequest."""
    return {
        "resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": _otlp_value("ray_tpu_torch"),
            }]},
            "scopeSpans": [{
                "scope": {"name": "ray_tpu_torch.util.tracing"},
                "spans": [{
                    "traceId": r["trace_id"],
                    "spanId": r["span_id"],
                    **({"parentSpanId": r["parent_span_id"]}
                       if r.get("parent_span_id") else {}),
                    "name": r["name"],
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": str(r["start_ns"]),
                    "endTimeUnixNano": str(r["end_ns"]),
                    "attributes": [
                        {"key": k, "value": _otlp_value(v)}
                        for k, v in (r.get("attributes") or {}).items()
                    ],
                } for r in records],
            }],
        }]
    }


def spans_to_chrome_trace(records) -> List[dict]:
    """Span records -> chrome trace 'X' slices (one pid per trace,
    one tid per span chain depth proxy: the span id). Lets spans sit
    in the same chrome://tracing view as task slices and step
    phases (`ray_tpu_torch doctor --trace`)."""
    trace = []
    for r in records:
        trace.append(
            {
                "name": r["name"],
                "cat": "span",
                "ph": "X",
                "ts": r["start_ns"] / 1e3,
                "dur": max(
                    1.0, (r["end_ns"] - r["start_ns"]) / 1e3
                ),
                "pid": f"trace:{r['trace_id'][:8]}",
                "tid": r.get("parent_span_id") or "root",
                "args": dict(r.get("attributes") or {}),
            }
        )
    return trace


def merge_chrome_trace(
    task_events: List[dict],
    span_records: List[dict],
    step_records: List[dict],
    path: Optional[str] = None,
) -> List[dict]:
    """One chrome trace out of the three observability streams: task
    state-event slices (queue time excluded per the slice anchor
    above), finished spans, and per-step per-rank phase slices. The
    `ray_tpu_torch doctor --trace out.json` artifact."""
    from .._private.step_telemetry import steps_to_chrome_trace

    trace = timeline_to_chrome_trace(task_events)
    trace.extend(spans_to_chrome_trace(span_records))
    trace.extend(steps_to_chrome_trace(step_records))
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def export_otlp(path: "str | None" = None) -> dict:
    """Fetch recorded spans from the head and write/return OTLP JSON
    (`ray.timeline()`'s role for the span world)."""
    from .. import exceptions as exc
    from .._private.worker import global_worker

    worker = global_worker()
    if worker is None:
        raise exc.RayTpuError(
            "export_otlp() requires an initialized session "
            "(call ray_tpu_torch.init() first)"
        )
    records = worker.call("list_spans", limit=10000)["spans"]
    otlp = spans_to_otlp(records)
    if path:
        with open(path, "w") as f:
            json.dump(otlp, f)
    return otlp
