# Copied from ray_tpu/_private/timeseries.py (JAX-free): module names read ray_tpu_torch.
"""Head-side metrics time-series ring.

The live metrics table answers "what is the p99 NOW"; this store
answers "when did it get slow". A bounded ring of periodic snapshots
— each a compacted copy of the head's aggregate metric table — is
appended by the head daemon every `metrics_timeseries_interval_s`
seconds and queried through the `metrics_timeseries` RPC /
``/api/timeseries?name=...&since=...``. Counters in consecutive
snapshots are rate-computable by differencing; histogram snapshots
carry count/sum plus reservoir percentiles so p50/p99 TRENDS survive
past the live 1024-sample reservoir window.

Reference analogy: the reference ships series to an external
Prometheus whose TSDB keeps history; the rebuild keeps a bounded
in-head window so trend diagnosis needs no external infrastructure.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: Scalar keys copied into a snapshot per metric/tag-set. Buckets and
#: sample reservoirs stay out: a snapshot must be O(series), not
#: O(observations).
_SCALAR_KEYS = (
    "total",
    "value",
    "count",
    "sum",
    "min",
    "max",
    "p50",
    "p95",
    "p99",
)


def compact_summary(summary: Dict[str, dict]) -> Dict[str, dict]:
    """Strip a `metrics_summary` mapping down to the scalar series a
    snapshot retains: kind + scalars, per-tag-set scalars, per-node
    values. Descriptions, bucket tables and reservoirs are dropped —
    they are reconstructable from (or only meaningful against) the
    live table."""
    out: Dict[str, dict] = {}
    for name, entry in summary.items():
        compact: dict = {"kind": entry.get("kind")}
        for key in _SCALAR_KEYS:
            if key in entry:
                compact[key] = entry[key]
        by_tags = entry.get("by_tags")
        if by_tags:
            compact["by_tags"] = {
                flat: {
                    key: series[key]
                    for key in _SCALAR_KEYS
                    if key in series
                }
                for flat, series in by_tags.items()
            }
        by_node = entry.get("by_node")
        if by_node:
            compact["by_node"] = dict(by_node)
        out[name] = compact
    return out


class TimeSeriesStore:
    """Bounded ring of ``{"time": t, "metrics": {name: compact}}``
    snapshots. Appends evict the oldest snapshot past `max_snapshots`
    — history is a window, not a database."""

    def __init__(self, max_snapshots: int = 720):
        self._ring: deque = deque(maxlen=max(2, int(max_snapshots)))
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def max_snapshots(self) -> int:
        return self._ring.maxlen

    def append(
        self, metrics: Dict[str, dict], now: Optional[float] = None
    ) -> None:
        snapshot = {
            "time": time.time() if now is None else float(now),
            "metrics": metrics,
        }
        # Same lock as query(): iterating a deque while another
        # thread appends raises "deque mutated during iteration".
        with self._lock:
            self._ring.append(snapshot)

    def query(
        self,
        name: Optional[str] = None,
        since: float = 0.0,
        limit: int = 0,
    ) -> List[dict]:
        """Snapshots newer than `since`, oldest first. With `name`,
        each snapshot's `metrics` is filtered to that single series
        (snapshots in which the series did not exist yet are
        skipped); `limit` keeps the NEWEST snapshots."""
        with self._lock:
            snapshots = list(self._ring)
        if since:
            snapshots = [
                s for s in snapshots if s["time"] > float(since)
            ]
        if name is not None:
            snapshots = [
                {"time": s["time"], "metrics": {name: s["metrics"][name]}}
                for s in snapshots
                if name in s["metrics"]
            ]
        if limit and limit > 0:
            snapshots = snapshots[-int(limit):]
        return snapshots
