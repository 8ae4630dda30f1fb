# Copied from ray_tpu/util/metrics.py (JAX-free): module names read ray_tpu_torch.
"""User-defined metrics: Counter / Gauge / Histogram.

Reference: python/ray/util/metrics.py — application metrics recorded
from any worker, aggregated cluster-wide (the reference flows through
per-node metrics agents into Prometheus; here records flow through the
node daemon's KV-style metric table on the head and are queried with
`metrics_summary()`; a Prometheus text endpoint rides the dashboard).
"""

from __future__ import annotations

import logging
import os
import threading
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from .. import exceptions as exc
from ..devtools.lock_witness import make_lock

logger = logging.getLogger(__name__)

_FLUSH_INTERVAL_S = 0.5
#: Records kept while the head is unreachable (failed flushes requeue
#: their batch rather than dropping it; oldest age out past this cap).
_MAX_BUFFERED = 10000


def _worker():
    from .._private.worker import global_worker

    worker = global_worker()
    if worker is None:
        raise exc.RayTpuError("ray_tpu_torch.init() has not been called")
    return worker


class _Buffer:
    """Per-process record buffer with a background flusher.

    Lifecycle: `reset()` (called by ray_tpu_torch.shutdown()) stops the
    flusher thread and drops the singleton, so a re-init gets a fresh
    buffer + thread bound to the NEW worker — the old flusher no
    longer survives shutdown silently dropping records against a dead
    session. A flush SEALS the pending records into a numbered batch
    and delivers sealed batches in order, each tagged (sender, seq);
    the head drops seqs it already applied, so a retry after a lost
    reply cannot double-count — outages cost retries, not records and
    not duplicates. Failed batches stay sealed (bounded) for the next
    tick; the background loop warns ONCE per outage instead of
    swallowing every exception forever, while an explicit `flush()`
    raises."""

    _instance: Optional["_Buffer"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.records: List[tuple] = []
        self.records_lock = make_lock("metrics.records")
        self._stop = threading.Event()
        self._warned = False
        self._sender = uuid.uuid4().hex
        self._seq = 0
        self._sealed: List[Tuple[int, List[tuple]]] = []
        # Pre-flush drains: callables that push their own aggregated
        # records right before each seal (the worker's get-provenance
        # aggregates ride these — batched per flush tick, never one
        # record per get). Registered per buffer generation: fork and
        # shutdown drop the singleton, so hooks never outlive the
        # session they aggregate for.
        self._drain_hooks: List = []
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    @classmethod
    def get(cls) -> "_Buffer":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Final best-effort flush, stop the flusher, drop the
        singleton (ray_tpu_torch.shutdown() path)."""
        with cls._lock:
            buf, cls._instance = cls._instance, None
        if buf is None:
            return
        buf._stop.set()
        buf.flush(raise_on_error=False)
        buf.thread.join(timeout=2.0)

    @classmethod
    def _reset_after_fork(cls) -> None:
        # The flusher thread does not survive fork; drop any
        # inherited singleton so the child lazily creates a live one
        # (no lock: the parent may have held it mid-fork).
        cls._instance = None

    def push(self, record: tuple) -> None:
        with self.records_lock:
            self.records.append(record)

    def add_drain_hook(self, hook) -> None:
        """Register a callable run before each flush seals a batch
        (idempotent per hook object). Hooks push records via push();
        a raising hook is dropped from the list, never the flush."""
        with self.records_lock:
            if hook not in self._drain_hooks:
                self._drain_hooks.append(hook)

    def _loop(self) -> None:
        while not self._stop.wait(_FLUSH_INTERVAL_S):
            self.flush(raise_on_error=False)

    def _seal_and_trim_locked(self) -> None:
        """Move pending records into a new sealed batch and enforce
        the buffered-record cap across sealed batches. Caller holds
        `records_lock`. Boundary-carrying records (the 5-tuple each
        Histogram sends ONCE per buffer generation) survive trimming
        unconditionally: age them out and the head could never bucket
        that histogram again this process lifetime."""
        if self.records:
            self._seq += 1
            self._sealed.append((self._seq, self.records))
            self.records = []
        overflow = (
            sum(len(b) for _, b in self._sealed) - _MAX_BUFFERED
        )
        if overflow > 0:
            trimmed = []
            for seq, batch in self._sealed:
                if overflow > 0:
                    cut = min(overflow, len(batch))
                    declares = [
                        r for r in batch[:cut] if len(r) > 4
                    ]
                    batch = declares + batch[cut:]
                    overflow -= cut
                if batch:
                    trimmed.append((seq, batch))
            self._sealed = trimmed

    def flush(self, raise_on_error: bool = True) -> None:
        with self.records_lock:
            hooks = list(self._drain_hooks)
        for hook in hooks:
            try:
                hook()
            except Exception:
                # A broken drain must not wedge every future flush.
                with self.records_lock:
                    if hook in self._drain_hooks:
                        self._drain_hooks.remove(hook)
        with self.records_lock:
            self._seal_and_trim_locked()
            pending = list(self._sealed)
        for seq, batch in pending:
            try:
                # Bounded: an accepted-but-never-answered head (the
                # wedged-cluster case the doctor exists to diagnose)
                # must fail this flush — not hang rt.diagnose()'s
                # pre-read flush or shutdown()'s final one forever. A
                # timed-out batch stays sealed; head-side seq dedup
                # absorbs the retry if it was actually applied.
                _worker().call(
                    "metrics_record",
                    records=batch,
                    sender=self._sender,
                    seq=seq,
                    timeout=30.0,
                )
            except Exception as e:
                # The batch stays sealed under its seq for the next
                # tick: retried delivery is deduplicated head-side,
                # so an outage costs retries, not records and not
                # double-counts.
                if raise_on_error:
                    raise exc.RayTpuError(
                        f"metrics flush failed: {e}"
                    ) from e
                if not self._warned:
                    self._warned = True
                    logger.warning(
                        "metrics flush failed (%s); records are "
                        "buffered (max %d) and the flusher will keep "
                        "retrying — this is logged once per outage",
                        e,
                        _MAX_BUFFERED,
                    )
                return
            with self.records_lock:
                self._sealed = [
                    (s, b) for s, b in self._sealed if s != seq
                ]
        self._warned = False


os.register_at_fork(after_in_child=_Buffer._reset_after_fork)


class _Metric:
    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Sequence[str] = (),
    ):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _tags(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return tuple(sorted(merged.items()))


class Counter(_Metric):
    KIND = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None):
        if value < 0:
            raise ValueError("Counter.inc() takes a non-negative value")
        _Buffer.get().push(
            (self.KIND, self._name, float(value), self._tags(tags))
        )


class Gauge(_Metric):
    KIND = "gauge"

    def set(self, value: float, tags: Optional[dict] = None):
        _Buffer.get().push(
            (self.KIND, self._name, float(value), self._tags(tags))
        )


class Histogram(_Metric):
    KIND = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Sequence[float] = (),
        tag_keys: Sequence[str] = (),
    ):
        super().__init__(name, description, tag_keys)
        # Sorted up front: the head buckets with bisect against them.
        self._boundaries = sorted(float(b) for b in boundaries)
        self._declared_for: Optional["_Buffer"] = None

    def observe(self, value: float, tags: Optional[dict] = None):
        # Boundaries ride the instance's FIRST record per buffer
        # generation (5th field; counters and gauges stay 4-tuples):
        # the head keeps first-seen boundaries per name, so repeating
        # them on every observation is pure wire/CPU overhead. Keyed
        # to the buffer object — shutdown/re-init and fork build a
        # fresh buffer, whose (possibly new) head needs a re-declare.
        buf = _Buffer.get()
        rec = (self.KIND, self._name, float(value), self._tags(tags))
        if self._declared_for is not buf:
            rec = rec + (tuple(self._boundaries),)
            self._declared_for = buf
        buf.push(rec)


def flush() -> None:
    """Force-flush this process's buffered records (tests/shutdown).
    Raises RayTpuError when the records cannot be delivered (the
    background flusher instead warns once and retries)."""
    _Buffer.get().flush()


def flush_best_effort() -> None:
    """Flush without raising: a transient delivery failure requeues
    the batch for the background flusher instead of failing the
    caller (pre-read flushes in summaries and the doctor)."""
    _Buffer.get().flush(raise_on_error=False)


def _shutdown_buffer() -> None:
    """ray_tpu_torch.shutdown() hook: stop the flusher and drop the
    singleton so re-init binds a fresh buffer to the new session."""
    _Buffer.reset()


def metrics_summary() -> Dict[str, dict]:
    """Cluster-wide aggregated metrics: {name: {kind, total/value/
    count, by_tags}}. The incidental pre-read flush is best-effort —
    a transient delivery failure requeues the batch for the
    background flusher instead of failing the read."""
    flush_best_effort()
    return _worker().call("metrics_summary")["metrics"]


def metrics_timeseries(
    name: Optional[str] = None,
    since: float = 0.0,
    limit: int = 0,
) -> List[dict]:
    """Historical metric snapshots from the head's bounded
    time-series ring, oldest first: ``[{"time", "metrics": {name:
    {kind, total/value/count/sum/p50/p95/p99, by_tags, by_node}}}]``.
    Counters rate-compute by differencing consecutive snapshots;
    histogram snapshots carry reservoir percentiles so p99 trends
    survive past the live window. `name` filters to one series,
    `since` (unix seconds) to newer-than, `limit` keeps the newest N
    snapshots."""
    flush_best_effort()
    kwargs: dict = {"since": float(since), "limit": int(limit)}
    if name is not None:
        kwargs["name"] = str(name)
    return _worker().call("metrics_timeseries", **kwargs)[
        "snapshots"
    ]
