# Copied from ray_tpu/_private/metric_defs.py (JAX-free): module names read ray_tpu_torch.
"""Central core-metrics registry.

Reference: src/ray/stats/metric_defs.cc:46-260 — ~60 gauges/counters
defined in ONE table (tasks, actors, objects, scheduler, gRPC, io
loop) so operators learn a single namespace. The TPU-native runtime
does the same in one module: `CORE_METRICS` declares every metric,
`CoreCounters` holds the monotonic event counters the daemon bumps at
the few places things happen, and `collect(daemon)` computes the
point-in-time gauges straight off daemon state at scrape time (pull
model — zero steady-state cost, unlike the reference's push-through-
agent pipeline).

Per-node metrics ride heartbeats to the head (a ~60-float dict every
heartbeat); the head keeps the latest snapshot per node and serves the
aggregate through `metrics_summary` / the dashboard's Prometheus
endpoint with a `node` label.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

#: Cross-node aggregation for gauges where a sum is a lie; everything
#: else sums (counters always sum).
GAUGE_AGGREGATION: Dict[str, str] = {
    "rt_uptime_s": "max",
    "rt_rpc_queue_lag_ms": "mean",
    "rt_rpc_queue_lag_max_ms": "max",
}

#: name -> (kind, unit, description). Names are Prometheus-safe.
CORE_METRICS: Dict[str, tuple] = {
    # -- tasks (reference: metric_defs.cc tasks category) ------------
    "rt_tasks_queued": ("gauge", "tasks", "Tasks waiting in the local scheduler queue"),
    "rt_tasks_running": ("gauge", "tasks", "Tasks currently executing on leased workers"),
    "rt_tasks_infeasible": ("gauge", "tasks", "Tasks no live node can satisfy"),
    "rt_tasks_finished_total": ("counter", "tasks", "Tasks completed successfully"),
    "rt_tasks_failed_total": ("counter", "tasks", "Tasks that raised or died"),
    "rt_tasks_retried_total": ("counter", "tasks", "Task retry resubmissions"),
    "rt_task_events_buffered": ("gauge", "events", "Task state events held for the state API"),
    # -- actors ------------------------------------------------------
    "rt_actors_alive": ("gauge", "actors", "Actors in ALIVE state"),
    "rt_actors_restarting": ("gauge", "actors", "Actors mid-restart"),
    "rt_actors_dead": ("gauge", "actors", "Actors permanently dead"),
    "rt_actors_created_total": ("counter", "actors", "Actor creations requested"),
    "rt_actor_restarts_total": ("counter", "actors", "Actor restart attempts"),
    # -- workers -----------------------------------------------------
    "rt_workers_alive": ("gauge", "workers", "Registered worker processes"),
    "rt_workers_spawning": ("gauge", "workers", "Workers being spawned (startup gate)"),
    "rt_workers_started_total": ("counter", "workers", "Worker processes started"),
    "rt_worker_crashes_total": ("counter", "workers", "Workers that died unexpectedly"),
    "rt_workers_oom_killed_total": ("counter", "workers", "Workers killed by the memory monitor"),
    # -- leases / scheduler ------------------------------------------
    "rt_leases_active": ("gauge", "leases", "Outstanding worker leases"),
    "rt_lease_requests_total": ("counter", "leases", "Worker-lease requests handled"),
    "rt_placement_groups": ("gauge", "groups", "Placement groups registered (head)"),
    # -- objects / store ---------------------------------------------
    "rt_objects_local": ("gauge", "objects", "Objects tracked by this node"),
    "rt_object_store_bytes_used": ("gauge", "bytes", "Shared-memory arena bytes in use"),
    "rt_object_store_bytes_capacity": ("gauge", "bytes", "Shared-memory arena capacity"),
    "rt_object_store_objects": ("gauge", "objects", "Objects resident in the local arena"),
    "rt_objects_spilled": ("gauge", "objects", "Objects currently spilled to disk"),
    "rt_spilled_bytes": ("gauge", "bytes", "Bytes currently spilled to disk"),
    "rt_object_spills_total": ("counter", "spills", "Objects written to spill storage"),
    "rt_object_restores_total": ("counter", "restores", "Spilled objects restored into the arena"),
    "rt_object_pulls_total": ("counter", "pulls", "Cross-node object pulls started"),
    "rt_object_pulls_aborted_total": ("counter", "pulls", "Cross-node pulls that died mid-flight (source gone/evicted); counted here, never billed as transferred bytes"),
    "rt_object_pull_chunks_total": ("counter", "chunks", "Object chunks fetched from remote nodes"),
    "rt_object_pushes_total": ("counter", "pushes", "Object chunks served to remote nodes"),
    # -- control plane (head) ----------------------------------------
    "rt_nodes_alive": ("gauge", "nodes", "Live daemons in the cluster (head)"),
    "rt_nodes_dead": ("gauge", "nodes", "Daemons marked dead (head)"),
    "rt_jobs": ("gauge", "jobs", "Jobs registered (head)"),
    "rt_heartbeats_total": ("counter", "beats", "Heartbeats processed (head)"),
    "rt_kv_keys": ("gauge", "keys", "Internal KV entries (head)"),
    "rt_pubsub_subscribers": ("gauge", "subs", "Live pubsub subscriptions"),
    # -- rpc / event loop (reference: io_context_event_loop_lag_ms) --
    "rt_rpc_requests_total": ("counter", "rpcs", "RPC frames dispatched"),
    "rt_rpc_errors_total": ("counter", "rpcs", "RPC handlers that raised"),
    "rt_rpc_queue_lag_ms": ("gauge", "ms", "Mean handler queueing delay (lifetime; request-weighted across nodes)"),
    "rt_rpc_queue_lag_max_ms": ("gauge", "ms", "Max handler queueing delay observed (lifetime)"),
    # -- process -----------------------------------------------------
    "rt_uptime_s": ("gauge", "s", "Daemon uptime"),
    "rt_rss_mb": ("gauge", "MiB", "Daemon resident set size"),
}

#: Descriptions for metrics that ride the util/metrics._Buffer pipe
#: (pushed by workers, folded into the head's aggregate table) rather
#: than being collect()ed off daemon state. Kept here so the whole
#: namespace is documented in ONE module and `/metrics` renders HELP
#: lines for them; absence from this table is fine (user metrics),
#: it just means no HELP line.
PIPE_METRICS: Dict[str, tuple] = {
    # -- XLA layer (_private/compile_watch.py) -----------------------
    "rt_jax_compiles_total": (
        "counter", "compiles",
        "XLA compilations recorded per program (label: program name "
        "only — shape digests stay in the diagnostic ring)",
    ),
    "rt_jax_compile_ms": (
        "histogram", "ms",
        "Duration of each recorded XLA compilation, per program",
    ),
    "rt_hbm_bytes_in_use": (
        "gauge", "bytes",
        "Device HBM bytes in use, per reporting rank "
        "(device.memory_stats(); absent on CPU backends)",
    ),
    "rt_hbm_peak_bytes": (
        "gauge", "bytes",
        "Peak device HBM bytes in use, per reporting rank",
    ),
    "rt_hbm_bytes_limit": (
        "gauge", "bytes",
        "Device HBM capacity visible to the reporting rank",
    ),
}


class CoreCounters:
    """Monotonic event counters; one instance per daemon process.
    Increments take a lock: getattr/setattr read-modify-write from
    concurrent RPC pool threads would permanently lose counts
    otherwise. Reads stay lock-free (a torn read at scrape
    granularity is harmless; a lost write is forever)."""

    _NAMES = (
        "tasks_finished",
        "tasks_failed",
        "tasks_retried",
        "actors_created",
        "actor_restarts",
        "workers_started",
        "oom_kills",
        "lease_requests",
        "pulls",
        "pulls_aborted",
        "pull_chunks",
        "pushes",
        "heartbeats",
        "spills",
        "restores",
    )

    def __init__(self):
        self._bump_lock = threading.Lock()
        for name in self._NAMES:
            setattr(self, name, 0)

    def bump(self, name: str, n: int = 1) -> None:
        with self._bump_lock:
            setattr(self, name, getattr(self, name) + n)

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in self._NAMES}


def _rss_mb() -> float:
    try:
        import os

        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1024 * 1024)
    except Exception:  # noqa: BLE001 — metrics must not raise
        return 0.0


def collect(daemon) -> Dict[str, float]:
    """Scrape this daemon's core metrics. Reads daemon state
    defensively: a missing structure reports 0, never raises."""
    out: Dict[str, float] = {}
    counters = getattr(daemon, "core_counters", None)
    c = counters.as_dict() if counters is not None else {}

    def safe(fn, default=0.0):
        try:
            return float(fn())
        except Exception:  # noqa: BLE001
            return default

    # tasks / workers / leases (daemon-local, under its lock where
    # cheap; scrapes tolerate slightly torn reads)
    out["rt_tasks_queued"] = safe(
        lambda: daemon.scheduler.queued_count()
    )
    out["rt_tasks_running"] = safe(lambda: len(daemon.leases))
    out["rt_tasks_infeasible"] = safe(
        lambda: len(daemon._infeasible)
    )
    out["rt_workers_alive"] = safe(lambda: len(daemon.workers))
    out["rt_workers_spawning"] = safe(lambda: daemon._spawning)
    out["rt_leases_active"] = safe(lambda: len(daemon.leases))
    out["rt_objects_local"] = safe(lambda: len(daemon.objects))

    # store / spill
    try:
        info = daemon.store.size_info()
        out["rt_object_store_bytes_used"] = float(
            info.get("used", 0)
        )
        out["rt_object_store_bytes_capacity"] = float(
            info.get("capacity", 0)
        )
        out["rt_object_store_objects"] = float(
            info.get("num_objects", 0)
        )
    except Exception:  # noqa: BLE001
        pass
    try:
        if daemon.spill is not None:
            stats = daemon.spill.stats()
            out["rt_objects_spilled"] = float(
                stats.get("spilled_objects", 0)
            )
            out["rt_spilled_bytes"] = float(
                stats.get("spilled_bytes", 0)
            )
    except Exception:  # noqa: BLE001
        pass

    # head-only control plane
    if getattr(daemon, "is_head", False):
        try:
            summary = daemon.control.summary()
            alive = summary.get("alive_nodes", 0)
            out["rt_nodes_alive"] = float(alive)
            out["rt_nodes_dead"] = float(
                summary.get("nodes", 0) - alive
            )
            out["rt_jobs"] = float(summary.get("jobs", 0))
            out["rt_placement_groups"] = float(
                summary.get("placement_groups", 0)
            )
            actors = daemon.control.actors.values()
            states: Dict[str, int] = {}
            for a in actors:
                states[a.state] = states.get(a.state, 0) + 1
            out["rt_actors_alive"] = float(states.get("ALIVE", 0))
            out["rt_actors_restarting"] = float(
                states.get("RESTARTING", 0)
            )
            out["rt_actors_dead"] = float(states.get("DEAD", 0))
            out["rt_kv_keys"] = safe(
                lambda: sum(
                    len(ns) for ns in daemon.control.kv.values()
                )
            )
            out["rt_task_events_buffered"] = safe(
                lambda: len(daemon.control.task_events)
            )
        except Exception:  # noqa: BLE001
            pass

    # rpc event stats -> loop-lag gauges
    try:
        from .event_stats import stats as event_stats

        snap = event_stats().snapshot()
        total = sum(s["count"] for s in snap.values())
        errors = sum(s["errors"] for s in snap.values())
        queue_total = sum(
            s["mean_queue_ms"] * s["count"] for s in snap.values()
        )
        out["rt_rpc_requests_total"] = float(total)
        out["rt_rpc_errors_total"] = float(errors)
        out["rt_rpc_queue_lag_ms"] = (
            queue_total / total if total else 0.0
        )
        out["rt_rpc_queue_lag_max_ms"] = max(
            (s["max_queue_ms"] for s in snap.values()),
            default=0.0,
        )
    except Exception:  # noqa: BLE001
        pass

    # counters
    out["rt_tasks_finished_total"] = float(c.get("tasks_finished", 0))
    out["rt_tasks_failed_total"] = float(c.get("tasks_failed", 0))
    out["rt_tasks_retried_total"] = float(c.get("tasks_retried", 0))
    out["rt_actors_created_total"] = float(c.get("actors_created", 0))
    out["rt_actor_restarts_total"] = float(c.get("actor_restarts", 0))
    out["rt_workers_started_total"] = float(c.get("workers_started", 0))
    out["rt_worker_crashes_total"] = float(
        getattr(daemon, "_spawn_crash_total", 0)
    )
    out["rt_workers_oom_killed_total"] = float(c.get("oom_kills", 0))
    out["rt_lease_requests_total"] = float(c.get("lease_requests", 0))
    out["rt_object_spills_total"] = float(c.get("spills", 0))
    out["rt_object_restores_total"] = float(c.get("restores", 0))
    out["rt_object_pulls_total"] = float(c.get("pulls", 0))
    out["rt_object_pulls_aborted_total"] = float(c.get("pulls_aborted", 0))
    out["rt_object_pull_chunks_total"] = float(c.get("pull_chunks", 0))
    out["rt_object_pushes_total"] = float(c.get("pushes", 0))
    out["rt_heartbeats_total"] = float(c.get("heartbeats", 0))

    out["rt_uptime_s"] = time.time() - getattr(
        daemon, "started_at", time.time()
    )
    out["rt_rss_mb"] = _rss_mb()
    return out
