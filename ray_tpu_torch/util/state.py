# Copied from ray_tpu/util/state.py (JAX-free): module names read ray_tpu_torch.
"""State API: programmatic cluster introspection.

Reference: python/ray/util/state/api.py:110 — list_nodes/actors/tasks/
objects/placement_groups aggregated from the control plane; the CLI
(`ray list ...`, util/state/state_cli.py) prints the same tables.
"""

from __future__ import annotations

from typing import List, Optional

from .. import exceptions as exc


def _worker():
    from .._private.worker import global_worker

    worker = global_worker()
    if worker is None:
        raise exc.RayTpuError("ray_tpu_torch.init() has not been called")
    return worker


def list_nodes() -> List[dict]:
    return _worker().call("list_nodes")["nodes"]


def list_actors() -> List[dict]:
    return _worker().call("list_actors")["actors"]


def list_tasks(limit: int = 1000) -> List[dict]:
    events = _worker().call("list_task_events")["events"]
    # Collapse the event stream into latest-state-per-task (reference:
    # GcsTaskManager keeps per-task state transitions).
    latest = {}
    for event in events:
        latest[event["task_id"]] = event
    # Newest first BEFORE truncating: dict order here is event-stream
    # order, so a plain [:limit] under load dropped an arbitrary slice
    # of tasks — the recent ones an operator is actually after.
    rows = sorted(
        latest.values(),
        key=lambda e: float(e.get("time", 0.0)),
        reverse=True,
    )
    return rows[:limit]


def list_objects(limit: int = 1000) -> List[dict]:
    """Cluster object table, size-descending. The head sorts BEFORE
    applying `limit` (the old dict-order truncation dropped an
    arbitrary slice — the big consumers an operator is after; same
    bug class as the list_tasks newest-first fix). Rows carry the
    ledger's attribution columns (job, owner, age_s, spilled, pinned)
    and the data-plane columns: node (a copy holder), copies (how
    many nodes hold one), source (how this node's copy materialised:
    inline/local/pull/pull_spill/restore)."""
    rows = _worker().call("list_objects", limit=limit)["objects"]
    # Defensive re-sort: a pre-ledger head returns creation order.
    rows.sort(key=lambda r: int(r.get("size") or 0), reverse=True)
    return rows


def memory_summary() -> dict:
    """The cluster memory ledger (`ray_tpu_torch memory` / `/api/memory`):
    arena totals + per-job attribution, per-(job, owner) bytes, top
    objects, per-node reports, spill/restore rates, and the doctor's
    `verdict.memory` (near-capacity nodes, leak suspects, spill
    thrash) over the same data."""
    return _worker().call("memory_summary", timeout=30.0)["memory"]


def transfer_summary() -> dict:
    """The cluster transfer matrix (`ray_tpu_torch memory --transfers` /
    `/api/transfers`): per-(job, src_node, dst_node) flows with
    bytes/ms/pull/restore/abort counts, per-job get provenance
    (inline / local / pull / restore_local / restore_remote) and
    locality hit rates, the top remote-pulling task classes, and
    per-job spill/restore op totals."""
    return _worker().call("transfer_summary", timeout=30.0)[
        "transfers"
    ]


def object_locations(
    object_ids: Optional[List[str]] = None, limit: int = 1000
) -> List[dict]:
    """Head-side object location/size index: for each sealed object,
    the nodes holding a copy, its size, owner, and whether it is
    spilled — size-descending. `object_ids` (hex) filters to specific
    objects. This is the index the doctor's misplaced-task conviction
    reads; use it to check where a ref's bytes live before deciding
    where to schedule its consumer."""
    kwargs: dict = {"limit": int(limit)}
    if object_ids is not None:
        kwargs["oids"] = [bytes.fromhex(o) for o in object_ids]
    return _worker().call(
        "object_locations", timeout=30.0, **kwargs
    )["locations"]


def list_placement_groups() -> List[dict]:
    return _worker().call("placement_group_table")["table"]


def summarize() -> dict:
    return _worker().call("state_summary")["summary"]


def event_stats() -> dict:
    """Per-RPC-handler timing stats of the local daemon (count,
    mean/max execution and queueing delay — reference:
    src/ray/common/event_stats.cc debug dump). The first place to
    look when the control plane feels sluggish: a hot row with high
    exec time is a slow handler; uniformly high queue delay is a
    starved dispatch pool."""
    return _worker().call("event_stats")["handlers"]


def profile_worker(
    pid: int,
    *,
    kind: str = "cpu",
    duration_s: float = 5.0,
    hz: float = 100.0,
    top: int = 20,
    node_id: Optional[str] = None,
) -> dict:
    """Attach an on-demand profiler to a live worker process
    (reference: dashboard reporter profile_manager.py — py-spy
    cpu/stack profiles, memray memory profiles; here in-process,
    _private/profiling.py). kind: "cpu" (folded flamegraph stacks),
    "stack" (instant dump), "memory" (tracemalloc window). node_id
    (hex) targets a worker on another node."""
    kwargs: dict = {
        "pid": int(pid),
        "kind": kind,
        "duration_s": float(duration_s),
        "hz": float(hz),
        "top": int(top),
    }
    if node_id is not None:
        kwargs["node_id"] = bytes.fromhex(node_id)
    return _worker().call(
        "profile_worker", timeout=float(duration_s) + 40.0, **kwargs
    )


def profile_gang(
    job_id: Optional[str] = None,
    *,
    duration_s: float = 2.0,
    hz: float = 100.0,
    path: Optional[str] = None,
) -> dict:
    """Coordinated gang profiling: fan ONE synchronized start/stop
    window out to every step-reporting rank of a job (default: the
    most recently reporting job) and merge the per-rank captures —
    `torch.profiler` traces of the card where a rank has initialised
    CUDA, the in-process timeline sampler everywhere — with the gang's step-telemetry phases into
    one chrome trace on a shared unix-epoch clock. Returns
    ``{"job", "trace", "ranks", "errors", "window"}``; with `path`
    the merged trace is additionally written as chrome-trace JSON
    (load in chrome://tracing or Perfetto). CLI surface:
    ``ray_tpu_torch profile --job``."""
    kwargs: dict = {
        "duration_s": float(duration_s),
        "hz": float(hz),
    }
    if job_id is not None:
        kwargs["job"] = str(job_id)
    reply = _worker().call(
        "profile_gang",
        timeout=float(duration_s) + 120.0,
        **kwargs,
    )
    if path is not None:
        import json

        with open(path, "w") as f:
            json.dump(reply.get("trace", []), f)
    return reply


def compile_summary() -> dict:
    """The head's folded XLA compile table: per-program compile
    counts/durations, the bounded shape-digest rings, and the current
    recompile-storm findings (`/api/compile`; the cluster half of
    `_private.compile_watch.snapshot()`)."""
    return _worker().call("compile_summary")["compile"]


__all__ = [
    "list_nodes",
    "list_actors",
    "list_tasks",
    "list_objects",
    "list_placement_groups",
    "memory_summary",
    "transfer_summary",
    "object_locations",
    "summarize",
    "event_stats",
    "profile_worker",
    "profile_gang",
    "compile_summary",
]
