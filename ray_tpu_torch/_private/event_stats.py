# Copied from ray_tpu/_private/event_stats.py (JAX-free): module names read ray_tpu_torch.
"""Per-handler RPC event statistics.

Reference: src/ray/common/event_stats.cc — every asio handler records
count, queueing delay, and execution time into a global registry that
surfaces in the debug state dump. The equivalent here instruments the
RPC server's dispatch path (rpc.py): queueing delay is the time a
frame waits between the hub thread enqueueing it and a pool thread
starting its handler — the direct analog of asio loop lag, and the
first number to look at when the daemon feels sluggish (is one
handler slow, or is the pool starved?).

Costs one monotonic read per enqueue and two per dispatch (~100 ns);
always on.
"""

from __future__ import annotations

import threading
from typing import Dict


class _HandlerStat:
    __slots__ = (
        "count",
        "total_exec_s",
        "max_exec_s",
        "total_queue_s",
        "max_queue_s",
        "errors",
    )

    def __init__(self):
        self.count = 0
        self.total_exec_s = 0.0
        self.max_exec_s = 0.0
        self.total_queue_s = 0.0
        self.max_queue_s = 0.0
        self.errors = 0


class EventStats:
    """Registry of per-handler timing stats for one process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, _HandlerStat] = {}

    def record(
        self,
        name: str,
        queue_s: float,
        exec_s: float,
        error: bool = False,
    ) -> None:
        with self._lock:
            stat = self._stats.get(name)
            if stat is None:
                stat = self._stats[name] = _HandlerStat()
            stat.count += 1
            stat.total_exec_s += exec_s
            stat.total_queue_s += queue_s
            if exec_s > stat.max_exec_s:
                stat.max_exec_s = exec_s
            if queue_s > stat.max_queue_s:
                stat.max_queue_s = queue_s
            if error:
                stat.errors += 1

    def snapshot(self) -> Dict[str, dict]:
        """{handler: {count, mean/max exec ms, mean/max queue ms,
        errors}}, sorted by cumulative execution time (the reference
        dump sorts the same way: the top row is where the loop's time
        went)."""
        with self._lock:
            items = list(self._stats.items())
        out = {}
        for name, s in sorted(
            items, key=lambda kv: -kv[1].total_exec_s
        ):
            out[name] = {
                "count": s.count,
                "mean_exec_ms": round(
                    s.total_exec_s / s.count * 1e3, 3
                ),
                "max_exec_ms": round(s.max_exec_s * 1e3, 3),
                "total_exec_ms": round(s.total_exec_s * 1e3, 1),
                "mean_queue_ms": round(
                    s.total_queue_s / s.count * 1e3, 3
                ),
                "max_queue_ms": round(s.max_queue_s * 1e3, 3),
                "errors": s.errors,
            }
        return out


_GLOBAL = EventStats()


def stats() -> EventStats:
    return _GLOBAL
