# Copied from ray_tpu/dag/edges.py (JAX-free): module names read ray_tpu_torch.
"""Instrumented channel edges: named send/recv endpoints with per-edge
counters riding the metrics pipe.

A compiled DAG / MPMD pipeline is only diagnosable if a straggler
STAGE can be named the way the step doctor names a straggler rank —
which takes per-edge numbers: how many records hopped, how many bytes,
and how long each endpoint sat blocked in put/get. `Edge` wraps a
channel (ShmChannel or TcpChannel — anything with put_bytes/get_bytes/
close/unlink) with exactly that: local counters (cheap, always on,
returned by `stats()`) plus export through the PR 7 metrics pipe
(`dag_channel_hops_total` / `dag_channel_bytes_total` counters and
`dag_channel_send_wait_ms` / `dag_channel_recv_wait_ms` histograms,
labeled by edge), which the head folds into `doctor --json` under
``verdict["dag"]``.

Export is BATCHED off the hot path: a compiled-DAG hop is ~25-45 us
(MICROBENCH dag_hop_per_s) and per-op metric pushes would tax exactly
the number this instrumentation exists to defend — so counters flush
as accumulated deltas (every `_FLUSH_OPS` ops or `_FLUSH_S`), and
wait histograms sample 1-in-`_WAIT_SAMPLE` of sub-millisecond waits
while recording every wait >= 1 ms unconditionally (the bubble tail
is the diagnostic signal; the sub-ms noise floor is not).

Blocked time additionally bills the step-telemetry phases
``send_wait_ms`` / ``recv_wait_ms``, so an MPMD pipeline step's
bubble shows up attributed in the same per-(step, rank) records
gang-skew diagnosis already reads.

Edges are picklable: the wrapped channel re-attaches on the far side
and the counters start fresh there — each PROCESS counts its own
sends/recvs, which is what "which endpoint waited" needs.
"""

from __future__ import annotations

import time
from pickle import dumps as _dumps, loads as _loads
from time import monotonic as _mono
from typing import Any, Optional

#: Histogram bucket boundaries for send/recv wait (ms): the hot path
#: is tens of microseconds (native shm hop), the interesting tail is
#: schedule bubble — seconds.
_WAIT_BOUNDARIES = (0.1, 1.0, 5.0, 25.0, 100.0, 500.0, 2000.0)
_FLUSH_OPS = 64
_FLUSH_S = 0.25
_WAIT_SAMPLE = 16
#: Waits at/above this always reach the histogram, unsampled.
_WAIT_ALWAYS_MS = 1.0

_metrics_cache: dict = {}


def _metrics():
    """Lazily-built shared metric instances (one set per process —
    tags carry the edge identity)."""
    if not _metrics_cache:
        from ..util.metrics import Counter, Histogram

        _metrics_cache.update(
            hops=Counter(
                "dag_channel_hops_total",
                "records moved over a compiled-DAG/pipeline channel edge",
                tag_keys=("edge", "dir"),
            ),
            bytes=Counter(
                "dag_channel_bytes_total",
                "payload bytes moved over a channel edge",
                tag_keys=("edge", "dir"),
            ),
            send_wait=Histogram(
                "dag_channel_send_wait_ms",
                "time blocked in channel put (backpressure)",
                boundaries=_WAIT_BOUNDARIES,
                tag_keys=("edge", "dir"),
            ),
            recv_wait=Histogram(
                "dag_channel_recv_wait_ms",
                "time blocked in channel get (starvation; for "
                "compiled-DAG exec loops this INCLUDES idle time "
                "between invocations — see doctor's suspect gating)",
                boundaries=_WAIT_BOUNDARIES,
                tag_keys=("edge", "dir"),
            ),
        )
    return _metrics_cache


from .._private.step_telemetry import add_phase as _phase_add


def _phase(name: str, ms: float) -> None:
    """Bill blocked time into the step-telemetry phase bucket: the
    per-(step, rank) records the doctor/goodput read then attribute
    pipeline bubble the same way they attribute data_wait/h2d.
    Module-level import: this sits on the ~25 us compiled-DAG hop."""
    try:
        _phase_add(name, ms)
    except Exception:
        pass


def _worker_alive() -> bool:
    try:
        from .._private.worker import global_worker

        return global_worker() is not None
    except Exception:
        return False


class Edge:
    """One named, instrumented channel endpoint.

    `name` identifies the edge (e.g. ``"s0->s1:b0"``), `direction`
    the record stream riding it (``"fwd"``/``"grad"`` for pipelines,
    ``"in"``/``"out"`` for compiled-DAG IO). Wire format is pickled
    records — the compiled-DAG protocol tuples ride unchanged.

    ``timed=False`` is the lite mode for latency-critical edges whose
    blocked time is already the caller's own visible latency (the
    compiled-DAG driver's input/output hops, ~25 us each): hop/byte
    counters only, no clocks, no histograms — measured <0.5 us per
    op, vs ~2 us for the fully-timed path. Stage-to-stage edges stay
    fully timed: their ops are milliseconds of compute apart and
    their blocked time IS the pipeline bubble.
    """

    __slots__ = (
        "channel", "name", "direction", "timed",
        "hops_in", "hops_out", "bytes_in", "bytes_out",
        "send_wait_ms", "recv_wait_ms",
        "_unflushed_hops", "_unflushed_bytes", "_last_flush",
        "_op_seq",
    )

    def __init__(self, channel: Any, name: str,
                 direction: str = "fwd", *, timed: bool = True):
        self.channel = channel
        self.name = str(name)
        self.direction = str(direction)
        self.timed = bool(timed)
        self._reset_counters()
        # Export batching state (deltas since last flush).
        self._unflushed_hops = 0
        self._unflushed_bytes = 0
        self._last_flush = time.monotonic()
        self._op_seq = 0

    def _reset_counters(self) -> None:
        self.hops_in = 0
        self.hops_out = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.send_wait_ms = 0.0
        self.recv_wait_ms = 0.0

    # -- channel API, timed -------------------------------------------
    def put(self, record: Any, timeout: Optional[float] = None,
            **kw) -> None:
        payload = _dumps(record)
        if not self.timed:
            self.channel.put_bytes(payload, timeout=timeout, **kw)
        else:
            t0 = _mono()
            try:
                self.channel.put_bytes(
                    payload, timeout=timeout, **kw
                )
            finally:
                # Blocked time bills even when the put times out —
                # that IS the backpressure signal; hop/byte counts
                # only on delivery.
                waited = (_mono() - t0) * 1e3
                self.send_wait_ms += waited
                _phase("send_wait_ms", waited)
                seq = self._op_seq = self._op_seq + 1
                if waited >= _WAIT_ALWAYS_MS or not (
                    seq % _WAIT_SAMPLE
                ):
                    self._observe_wait("send_wait", waited)
        self.hops_out += 1
        nbytes = len(payload)
        self.bytes_out += nbytes
        self._unflushed_bytes += nbytes
        self._unflushed_hops += 1
        if self._unflushed_hops >= _FLUSH_OPS:
            self._flush_metrics()

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self.timed:
            payload = self.channel.get_bytes(timeout=timeout)
        else:
            t0 = _mono()
            try:
                payload = self.channel.get_bytes(timeout=timeout)
            finally:
                waited = (_mono() - t0) * 1e3
                self.recv_wait_ms += waited
                _phase("recv_wait_ms", waited)
                seq = self._op_seq = self._op_seq + 1
                if waited >= _WAIT_ALWAYS_MS or not (
                    seq % _WAIT_SAMPLE
                ):
                    self._observe_wait("recv_wait", waited)
        self.hops_in += 1
        nbytes = len(payload)
        self.bytes_in += nbytes
        self._unflushed_bytes += nbytes
        self._unflushed_hops += 1
        if self._unflushed_hops >= _FLUSH_OPS:
            self._flush_metrics()
        return _loads(payload)

    def put_value(self, value: Any,
                  timeout: Optional[float] = None) -> None:
        """Tagged-record convenience used by the MPMD pipeline:
        ``("v", value)``; peers distinguish data from the
        compiled-DAG-style error/stop records."""
        self.put(("v", value), timeout=timeout)

    def get_value(self, timeout: Optional[float] = None) -> Any:
        tag, payload = self.get(timeout=timeout)
        if tag == "e":
            raise payload if isinstance(
                payload, BaseException
            ) else RuntimeError(str(payload))
        if tag == "s":
            from .channels import ChannelClosedError

            raise ChannelClosedError(f"edge {self.name} stopped")
        return payload

    # -- batched metric export ----------------------------------------
    def _observe_wait(self, which: str, waited_ms: float) -> None:
        """Off the hot path: the caller already sampled (1-in-N of
        sub-ms waits; every wait >= 1 ms). Piggybacks the time-based
        counter flush so idle-but-trickling edges still export."""
        if not _worker_alive():
            return
        try:
            _metrics()[which].observe(
                waited_ms,
                {"edge": self.name, "dir": self.direction},
            )
        except Exception:
            pass
        if time.monotonic() - self._last_flush >= _FLUSH_S:
            self._flush_metrics()

    def _flush_metrics(self) -> None:
        # No runtime session: the deltas can never be exported — drop
        # them (local stats() counters are unaffected) instead of
        # re-attempting on every op.
        if self._unflushed_hops and _worker_alive():
            try:
                m = _metrics()
                tags = {"edge": self.name, "dir": self.direction}
                m["hops"].inc(self._unflushed_hops, tags)
                if self._unflushed_bytes:
                    m["bytes"].inc(self._unflushed_bytes, tags)
            except Exception:
                pass
        self._unflushed_hops = 0
        self._unflushed_bytes = 0
        self._last_flush = time.monotonic()

    # -- passthrough ---------------------------------------------------
    def close(self) -> None:
        self._flush_metrics()
        self.channel.close()

    def unlink(self) -> None:
        unlink = getattr(self.channel, "unlink", None)
        if unlink is not None:
            unlink()

    def stats(self) -> dict:
        """This endpoint's counters since construction (or the last
        `take_stats`)."""
        return {
            "edge": self.name,
            "dir": self.direction,
            "hops_in": self.hops_in,
            "hops_out": self.hops_out,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "send_wait_ms": round(self.send_wait_ms, 3),
            "recv_wait_ms": round(self.recv_wait_ms, 3),
        }

    def take_stats(self) -> dict:
        """stats() then reset — per-step deltas for pipeline
        drivers. The metric-pipe deltas flush on their own cadence."""
        self._flush_metrics()
        out = self.stats()
        self._reset_counters()
        return out

    def __reduce__(self):
        return (
            _rebuild_edge,
            (self.channel, self.name, self.direction, self.timed),
        )


def _rebuild_edge(channel, name, direction, timed=True):
    return Edge(channel, name, direction, timed=timed)
