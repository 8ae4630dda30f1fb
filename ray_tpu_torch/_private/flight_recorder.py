# Copied from ray_tpu/_private/flight_recorder.py (JAX-free): module names read ray_tpu_torch.
"""Always-on per-process flight recorder.

Reference: the per-component event rings the reference keeps hot and
dumps cold — task events batched in core_worker/task_event_buffer.h,
the asio handler stats of common/event_stats.cc, and the debug-state
dumps raylets write on demand. The rebuild's version is ONE ring per
process (daemon, worker, driver alike) recording the events that
matter when a gang step stalls:

  rpc.client   — request/response latency of every outbound call
                 (method, ms, error) — hooked in rpc.RpcClient
  rpc.server   — handler execution + dispatch-queue wait per inbound
                 request — hooked in rpc.RpcServer._dispatch
  task         — task begin/end with duration and failure flag —
                 hooked in worker.CoreWorker._execute
  store.put /  — object-store writes/reads with payload size and
  store.get      duration — hooked in the worker's object plane
  lock.wait    — time spent waiting on a daemon hot-path lock

Steady-state cost is one `time` read plus a deque append (~1 us);
rings are NEVER pushed — the head pulls them lazily over the
`flight_recorder` RPC when an operator (or `ray_tpu_torch doctor`) asks.
Disable with ``RT_flight_recorder_enabled=0`` (config flag
`flight_recorder_enabled`); disabled cost is one attribute read per
hook site.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "recorder",
    "configure",
    "record",
    "snapshot",
]


class FlightRecorder:
    """Bounded in-memory event ring.

    Records are tuples ``(t, kind, name, dur_ms, extra)`` — `extra` is
    None on the hot path unless a hook passes keyword fields. Appends
    are lock-free (deque.append is GIL-atomic); `snapshot` copies under
    a lock only to get a consistent list view.
    """

    __slots__ = ("enabled", "_ring", "_lock", "_dropped")

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.enabled = enabled
        self._ring: deque = deque(maxlen=max(16, int(capacity)))
        self._lock = threading.Lock()
        self._dropped = 0

    def record(
        self,
        kind: str,
        name: str,
        dur_ms: float,
        extra: Optional[dict] = None,
    ) -> None:
        if not self.enabled:
            return
        self._ring.append((time.time(), kind, name, dur_ms, extra))

    def snapshot(
        self,
        limit: int = 0,
        kinds: Optional[List[str]] = None,
    ) -> List[dict]:
        """Newest-last list of record dicts (wire-friendly)."""
        with self._lock:
            records = list(self._ring)
        if kinds:
            wanted = set(kinds)
            records = [r for r in records if r[1] in wanted]
        if limit and limit > 0:
            records = records[-int(limit):]
        out = []
        for t, kind, name, dur_ms, extra in records:
            # Base fields win on collision: a hook's extra payload
            # must never rewrite what/when the ring recorded.
            rec = dict(extra) if extra else {}
            rec.update(
                t=t,
                kind=kind,
                name=name,
                dur_ms=round(float(dur_ms), 3),
            )
            out.append(rec)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def resize(self, capacity: int) -> None:
        with self._lock:
            old = self._ring
            snap = list(old)
            self._ring = deque(snap, maxlen=max(16, int(capacity)))
            # record() is deliberately lock-free, so an append can
            # race this swap into the retired deque — fold those
            # stragglers in rather than losing them. (An append that
            # grabbed `old` and lands after the line below is still
            # lost; for a diagnostic ring that sliver beats locking
            # the hot path.)
            for item in list(old)[len(snap):]:
                self._ring.append(item)

    def summary(self) -> Dict[str, dict]:
        """Per-(kind, name) aggregate of the current ring: count, mean
        and max duration, error count — the digest `ray_tpu_torch doctor`
        folds into its verdict."""
        with self._lock:
            records = list(self._ring)
        agg: Dict[str, dict] = {}
        for _, kind, name, dur_ms, extra in records:
            key = f"{kind}:{name}"
            row = agg.get(key)
            if row is None:
                row = agg[key] = {
                    "kind": kind,
                    "name": name,
                    "count": 0,
                    "total_ms": 0.0,
                    "max_ms": 0.0,
                    "errors": 0,
                }
            row["count"] += 1
            row["total_ms"] += float(dur_ms)
            if dur_ms > row["max_ms"]:
                row["max_ms"] = float(dur_ms)
            if extra and extra.get("error"):
                row["errors"] += 1
        for row in agg.values():
            row["mean_ms"] = round(row["total_ms"] / row["count"], 3)
            row["total_ms"] = round(row["total_ms"], 1)
            row["max_ms"] = round(row["max_ms"], 3)
        return agg


def _env_enabled() -> bool:
    raw = os.environ.get("RT_flight_recorder_enabled", "1")
    return raw.lower() in ("1", "true", "yes")


_GLOBAL = FlightRecorder(
    capacity=int(os.environ.get("RT_flight_recorder_capacity", "4096")),
    enabled=_env_enabled(),
)


def recorder() -> FlightRecorder:
    return _GLOBAL


def configure(config) -> None:
    """Apply a resolved runtime Config (daemons at construction,
    workers/drivers after registration hands them the cluster
    config). An explicit RT_flight_recorder_enabled in THIS process's
    environment wins over the cluster config — it is the documented
    per-process kill-switch, and the cluster config (resolved where
    the cluster was created) knows nothing about this process's
    env."""
    if "RT_flight_recorder_enabled" in os.environ:
        _GLOBAL.enabled = _env_enabled()
    else:
        _GLOBAL.enabled = bool(
            getattr(config, "flight_recorder_enabled", True)
        )
    if "RT_flight_recorder_capacity" in os.environ:
        capacity = int(os.environ["RT_flight_recorder_capacity"])
    else:
        capacity = int(
            getattr(config, "flight_recorder_capacity", 4096) or 4096
        )
    if capacity != _GLOBAL._ring.maxlen:
        _GLOBAL.resize(capacity)


def record(
    kind: str, name: str, dur_ms: float, extra: Optional[dict] = None
) -> None:
    _GLOBAL.record(kind, name, dur_ms, extra)


def snapshot(limit: int = 0, kinds=None) -> List[dict]:
    return _GLOBAL.snapshot(limit=limit, kinds=kinds)


def _reset_after_fork() -> None:
    # Forked children share the parent's ring OBJECT; give them a
    # fresh one so a worker's records never interleave with the
    # template process's.
    global _GLOBAL
    _GLOBAL = FlightRecorder(
        capacity=_GLOBAL._ring.maxlen or 4096, enabled=_GLOBAL.enabled
    )


os.register_at_fork(after_in_child=_reset_after_fork)
