# Copied from ray_tpu/serve/observability.py (JAX-free): module names read ray_tpu_torch.
"""Serve request-path observability.

Reference: python/ray/serve/_private/metrics_utils.py + the request
context module — every request carries an id, and the proxy, router,
replica and multiplex layers each record their segment of its life
into per-deployment histograms:

  serve_http_request_latency_ms   proxy: end-to-end HTTP time
  serve_router_routing_ms         handle: replica selection time
  serve_queue_wait_ms             replica: send -> execution start
  serve_request_latency_ms        replica: handler execution time
  serve_model_load_ms             multiplex: model swap (load) time
  serve_requests_total            replica: completions by outcome
  serve_http_requests_total       proxy: completions by status class
  serve_replica_executing         replica: currently-executing gauge

All ride the existing metrics pipe (util/metrics) to the head, so
they show up in `metrics_summary()`, the Prometheus endpoint and the
time-series ring with {app, deployment, ...} labels; the flight
recorder additionally keeps the most recent requests per process
(kinds ``serve.http`` / ``serve.handle`` / ``serve.model_load``)
with the request id, so `ray_tpu_torch doctor`'s ring digests show serve
traffic next to RPC traffic.

Request ids: the proxy honors an incoming ``x-request-id`` header or
mints one; bare handle calls mint one per request. The id propagates
proxy -> router -> replica -> multiplex via the request-context dict
the router ships with every replica call, and comes back to HTTP
callers as the ``x-request-id`` response header.

Kill switch: ``RT_serve_request_metrics_enabled=0`` disables every
histogram/counter observation on this process (the request-path
analog of ``RT_flight_recorder_enabled``); request ids still
propagate — they cost one uuid per request and make error logs
correlatable even with metrics off.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from typing import Dict, Optional

__all__ = [
    "REQUEST_ID_HEADER",
    "new_request_id",
    "new_request_context",
    "request_context",
    "current_request_context",
    "get_request_id",
    "reset_request_context",
    "observe_http",
    "observe_routing",
    "observe_queue_wait",
    "observe_handler",
    "observe_model_load",
    "replica_executing",
    "observe_engine_step",
    "observe_engine_prefill",
    "observe_engine_prefix",
    "observe_engine_ttft",
    "observe_engine_finish",
    "observe_engine_weights",
    "observe_engine_policy",
    "deployment_snapshot",
]

REQUEST_ID_HEADER = "x-request-id"

#: Latency bucket boundaries (ms) shared by every serve histogram:
#: sub-ms RPC floors through multi-second model loads.
LATENCY_BUCKETS_MS = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


def _enabled() -> bool:
    raw = os.environ.get("RT_serve_request_metrics_enabled", "1")
    return raw.lower() in ("1", "true", "yes")


_ENABLED = _enabled()

#: Replica-side context of the request being handled; multiplex reads
#: it for model-load attribution, user code may read the request id.
_request_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_request_context", default=None
)


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def new_request_context(
    app: str,
    deployment: str,
    request_id: Optional[str] = None,
    trace: Optional[dict] = None,
) -> dict:
    """The dict the router ships with every replica call: identity +
    the send timestamp the replica turns into queue wait."""
    ctx = {
        "request_id": request_id or new_request_id(),
        "app": app,
        "deployment": deployment,
        "sent_ts": time.time(),
    }
    if trace:
        ctx["trace"] = trace
    return ctx


def request_context(ctx: Optional[dict]):
    """Set the replica-side request context; returns the reset
    token."""
    return _request_ctx.set(ctx)


def reset_request_context(token) -> None:
    _request_ctx.reset(token)


def current_request_context() -> Optional[dict]:
    """Context of the request being handled (replica-side); None
    outside a serve request."""
    return _request_ctx.get()


def get_request_id() -> str:
    """Id of the serve request being handled (usable in user handler
    code for log correlation); "" outside a serve request."""
    ctx = _request_ctx.get()
    return str(ctx.get("request_id", "")) if ctx else ""


# ---------------------------------------------------------------------
# lazy metric singletons (one instance per (name) per process; the
# metrics pipe batches records, so per-request cost is a tuple append)
# ---------------------------------------------------------------------

_metrics_lock = threading.Lock()
_metrics: Dict[str, object] = {}


def _histogram(
    name: str, description: str, tag_keys: tuple, boundaries=None
):
    from ..util.metrics import Histogram

    with _metrics_lock:
        metric = _metrics.get(name)
        if metric is None:
            metric = _metrics[name] = Histogram(
                name,
                description=description,
                boundaries=boundaries or LATENCY_BUCKETS_MS,
                tag_keys=tag_keys,
            )
    return metric


def _counter(name: str, description: str, tag_keys: tuple):
    from ..util.metrics import Counter

    with _metrics_lock:
        metric = _metrics.get(name)
        if metric is None:
            metric = _metrics[name] = Counter(
                name, description=description, tag_keys=tag_keys
            )
    return metric


def _gauge(name: str, description: str, tag_keys: tuple):
    from ..util.metrics import Gauge

    with _metrics_lock:
        metric = _metrics.get(name)
        if metric is None:
            metric = _metrics[name] = Gauge(
                name, description=description, tag_keys=tag_keys
            )
    return metric


def _fr(kind: str, name: str, dur_ms: float, extra: dict) -> None:
    from .._private.flight_recorder import record

    record(kind, name, dur_ms, extra)


# ---------------------------------------------------------------------
# observation hooks (each guarded: observability must never fail a
# request)
# ---------------------------------------------------------------------

def observe_http(
    app: str,
    deployment: str,
    route: str,
    status: int,
    dur_ms: float,
    request_id: str,
) -> None:
    """Proxy: one completed HTTP request (end-to-end, queueing and
    streaming included)."""
    if not _ENABLED:
        return
    try:
        tags = {"app": app, "deployment": deployment}
        _histogram(
            "serve_http_request_latency_ms",
            "End-to-end HTTP request latency at the ingress proxy",
            ("app", "deployment"),
        ).observe(dur_ms, tags=tags)
        _counter(
            "serve_http_requests_total",
            "HTTP requests completed at the ingress proxy",
            ("app", "deployment", "status"),
        ).inc(1.0, tags={**tags, "status": f"{int(status) // 100}xx"})
        _fr(
            "serve.http",
            f"{app}/{deployment}{route}",
            dur_ms,
            {
                "request_id": request_id,
                "status": int(status),
                "error": int(status) >= 500,
            },
        )
    except Exception:
        pass


def observe_routing(app: str, deployment: str, dur_ms: float) -> None:
    """Handle: time spent choosing a replica (includes any wait for
    replica membership to appear)."""
    if not _ENABLED:
        return
    try:
        _histogram(
            "serve_router_routing_ms",
            "Replica selection time in the router",
            ("app", "deployment"),
        ).observe(dur_ms, tags={"app": app, "deployment": deployment})
    except Exception:
        pass


def observe_queue_wait(
    app: str, deployment: str, dur_ms: float
) -> None:
    """Replica: router send -> handler start (actor mailbox + wire
    time; cross-host clock skew makes this approximate off-box)."""
    if not _ENABLED:
        return
    try:
        _histogram(
            "serve_queue_wait_ms",
            "Router-send to handler-start wait per request",
            ("app", "deployment"),
        ).observe(
            max(0.0, dur_ms),
            tags={"app": app, "deployment": deployment},
        )
    except Exception:
        pass


def observe_handler(
    app: str,
    deployment: str,
    method: str,
    dur_ms: float,
    error: bool,
    request_id: str = "",
) -> None:
    """Replica: handler execution time + outcome counter."""
    if not _ENABLED:
        return
    try:
        tags = {"app": app, "deployment": deployment}
        _histogram(
            "serve_request_latency_ms",
            "Handler execution latency per deployment",
            ("app", "deployment"),
        ).observe(dur_ms, tags=tags)
        _counter(
            "serve_requests_total",
            "Requests completed by replicas, by outcome",
            ("app", "deployment", "method", "outcome"),
        ).inc(
            1.0,
            tags={
                **tags,
                "method": method,
                "outcome": "error" if error else "ok",
            },
        )
        _fr(
            "serve.handle",
            f"{app}/{deployment}.{method}",
            dur_ms,
            {"request_id": request_id, "error": bool(error)},
        )
    except Exception:
        pass


def observe_model_load(model_id: str, dur_ms: float) -> None:
    """Multiplex: one model load (LRU miss). Deployment attribution
    comes from the request context the replica set around the call;
    loads outside any request (warmup) land under app=""/deployment=""
    rather than being dropped."""
    if not _ENABLED:
        return
    try:
        ctx = current_request_context() or {}
        app = str(ctx.get("app", ""))
        deployment = str(ctx.get("deployment", ""))
        _histogram(
            "serve_model_load_ms",
            "Multiplexed model load (swap) time per deployment",
            ("app", "deployment"),
        ).observe(dur_ms, tags={"app": app, "deployment": deployment})
        _fr(
            "serve.model_load",
            model_id,
            dur_ms,
            {
                "request_id": str(ctx.get("request_id", "")),
                "deployment": f"{app}/{deployment}",
            },
        )
    except Exception:
        pass


#: Throttle for the executing gauge: one gauge record per replica per
#: change is fine at test scale but pure overhead at bench rates —
#: zero-crossing edges (0 <-> nonzero, both directions) ALWAYS push;
#: same-sign updates are limited to one per period.
_GAUGE_MIN_INTERVAL_S = 0.1
_gauge_last: Dict[tuple, tuple] = {}  # key -> (ts, value)


def replica_executing(
    app: str, deployment: str, replica_id: str, executing: int
) -> None:
    """Replica: currently-executing request count. Tagged by replica
    so concurrent replicas of one deployment don't overwrite each
    other's gauge — consumers sum across the replica label."""
    if not _ENABLED:
        return
    try:
        key = (app, deployment, replica_id)
        now = time.monotonic()
        last_ts, last_value = _gauge_last.get(key, (0.0, -1))
        edge = (executing == 0) != (last_value == 0)
        if not edge and now - last_ts < _GAUGE_MIN_INTERVAL_S:
            return
        _gauge_last[key] = (now, executing)
        _gauge(
            "serve_replica_executing",
            "Requests currently executing on a replica",
            ("app", "deployment", "replica"),
        ).set(
            float(executing),
            tags={
                "app": app,
                "deployment": deployment,
                "replica": replica_id,
            },
        )
    except Exception:
        pass


# ---------------------------------------------------------------------
# continuous-batching engine (ray_tpu_torch/llm): per-iteration decode and
# prefill timing, slot occupancy, token throughput. Tagged by model
# FAMILY on top of app/deployment — one engine per multiplexed family,
# so family series are the per-family slot accounting. Names ride the
# normal metrics pipe: labeled series on /metrics, folded per
# deployment into /api/serve by deployment_snapshot below.
# ---------------------------------------------------------------------

ENGINE_TAGS = ("app", "deployment", "family")

#: Decode-batch-size bucket boundaries (requests per step).
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _engine_histogram(name: str, description: str, boundaries=None):
    return _histogram(
        name, description, ENGINE_TAGS, boundaries=boundaries
    )


def observe_engine_step(
    tags: Dict[str, str],
    step_ms: float,
    batch: int,
    tokens: int,
    slots_used: int,
    slots_total: int,
    waiting: int,
    kv_used: Optional[int] = None,
    kv_total: Optional[int] = None,
    kv_cached: Optional[int] = None,
) -> None:
    """Engine: one decode iteration over the slot batch."""
    if not _ENABLED:
        return
    try:
        _engine_histogram(
            "serve_engine_decode_step_ms",
            "One decode step over the engine's slot batch",
        ).observe(step_ms, tags=tags)
        _engine_histogram(
            "serve_engine_step_batch",
            "Sequences decoded per engine step (batch size)",
            boundaries=BATCH_BUCKETS,
        ).observe(float(batch), tags=tags)
        if tokens:
            _counter(
                "serve_engine_tokens_total",
                "Tokens sampled by the engine's decode loop",
                ENGINE_TAGS,
            ).inc(float(tokens), tags=tags)
        _engine_gauges(
            tags, slots_used, slots_total, waiting,
            kv_used, kv_total, kv_cached,
        )
    except Exception:
        pass


def observe_engine_prefill(
    tags: Dict[str, str], chunk_ms: float, tokens: int
) -> None:
    """Engine: one prefill chunk (interleaved with decode steps)."""
    if not _ENABLED:
        return
    try:
        _engine_histogram(
            "serve_engine_prefill_chunk_ms",
            "One prefill chunk forward in the engine",
        ).observe(chunk_ms, tags=tags)
        _counter(
            "serve_engine_prefill_tokens_total",
            "Prompt tokens prefilled by the engine",
            ENGINE_TAGS,
        ).inc(float(tokens), tags=tags)
    except Exception:
        pass


def observe_engine_prefix(
    tags: Dict[str, str], skip_tokens: int
) -> None:
    """Engine: one admission's prefix-cache outcome. A HIT means the
    request skipped `skip_tokens` of prefill by pinning pooled blocks
    (hit-rate = hits / (hits + misses) over the counters)."""
    if not _ENABLED:
        return
    try:
        name = (
            "serve_engine_prefix_hits_total"
            if skip_tokens
            else "serve_engine_prefix_misses_total"
        )
        _counter(
            name,
            "Engine admissions whose prompt prefix "
            + ("hit" if skip_tokens else "missed")
            + " the paged KV prefix cache",
            ENGINE_TAGS,
        ).inc(1.0, tags=tags)
        if skip_tokens:
            _counter(
                "serve_engine_prefix_tokens_saved_total",
                "Prompt tokens whose prefill was skipped via "
                "prefix-cache hits",
                ENGINE_TAGS,
            ).inc(float(skip_tokens), tags=tags)
    except Exception:
        pass


def observe_engine_ttft(tags: Dict[str, str], ttft_ms: float) -> None:
    """Engine: submit -> first sampled token for one request."""
    if not _ENABLED:
        return
    try:
        _engine_histogram(
            "serve_engine_ttft_ms",
            "Engine-side time to first token per request",
        ).observe(ttft_ms, tags=tags)
    except Exception:
        pass


def observe_engine_finish(tags: Dict[str, str], reason: str) -> None:
    """Engine: one request retired (stop/length/cancelled)."""
    if not _ENABLED:
        return
    try:
        _counter(
            "serve_engine_requests_total",
            "Requests retired by the engine, by outcome",
            ENGINE_TAGS + ("outcome",),
        ).inc(1.0, tags={**tags, "outcome": reason})
    except Exception:
        pass


def observe_engine_weights(
    tags: Dict[str, str], version: int
) -> None:
    """Engine: a drainless weight push installed a new generation —
    the version now served to NEW admissions and policy batches
    (in-flight streams finish on the generation they pinned). The RL
    dataflow pairs this with `rl_weight_version`/`rl_weight_lag` from
    the learner side; the acceptance surface for weight-sync
    visibility on /metrics."""
    if not _ENABLED:
        return
    try:
        _gauge(
            "serve_engine_weight_version",
            "Weight version served to new engine admissions",
            ENGINE_TAGS,
        ).set(float(version), tags=tags)
        _counter(
            "serve_engine_weight_updates_total",
            "Drainless weight pushes installed by the engine",
            ENGINE_TAGS,
        ).inc(1.0, tags=tags)
    except Exception:
        pass


def observe_engine_policy(
    tags: Dict[str, str], batch_ms: float, rows: int, bucket: int
) -> None:
    """Engine: one policy-path batched forward (the non-LLM batch
    program serving RL action requests)."""
    if not _ENABLED:
        return
    try:
        _engine_histogram(
            "serve_engine_policy_batch_ms",
            "One policy batch-program forward in the engine",
        ).observe(batch_ms, tags=tags)
        _engine_histogram(
            "serve_engine_policy_batch_rows",
            "Rows served per policy batch (before bucket padding)",
            boundaries=BATCH_BUCKETS,
        ).observe(float(rows), tags=tags)
        _counter(
            "serve_engine_policy_rows_total",
            "Policy-path rows served by the engine",
            ENGINE_TAGS,
        ).inc(float(rows), tags=tags)
    except Exception:
        pass


def observe_engine_occupancy(
    tags: Dict[str, str],
    slots_used: int,
    slots_total: int,
    waiting: int,
    kv_used: Optional[int] = None,
    kv_total: Optional[int] = None,
    kv_cached: Optional[int] = None,
) -> None:
    """Engine: occupancy push OUTSIDE the decode step — cancellation,
    request retirement, and engine unload all free slots (and unpin
    KV blocks) without a following step, and the gauges must not
    report phantom occupancy until the next request arrives."""
    if not _ENABLED:
        return
    try:
        _engine_gauges(
            tags, slots_used, slots_total, waiting,
            kv_used, kv_total, kv_cached,
        )
    except Exception:
        pass


def _engine_gauges(
    tags: Dict[str, str],
    slots_used: int,
    slots_total: int,
    waiting: int,
    kv_used: Optional[int] = None,
    kv_total: Optional[int] = None,
    kv_cached: Optional[int] = None,
) -> None:
    """Slot-occupancy + KV-block gauges, throttled like
    replica_executing: zero-crossing edges always push, same-sign
    updates at most one per period per engine."""
    key = ("engine", tags.get("app", ""), tags.get("deployment", ""),
           tags.get("family", ""))
    now = time.monotonic()
    last_ts, last_value = _gauge_last.get(key, (0.0, -1))
    edge = (slots_used == 0) != (last_value == 0)
    if not edge and now - last_ts < _GAUGE_MIN_INTERVAL_S:
        return
    _gauge_last[key] = (now, slots_used)
    series = [
        (
            "serve_engine_slots_used",
            "KV slots occupied by decoding sequences",
            slots_used,
        ),
        (
            "serve_engine_slots_total",
            "KV slots provisioned in the engine",
            slots_total,
        ),
        (
            "serve_engine_waiting",
            "Requests queued for a free engine slot",
            waiting,
        ),
    ]
    if kv_used is not None:
        series.append((
            "serve_engine_kv_blocks_used",
            "Paged-KV blocks pinned by live requests",
            kv_used,
        ))
    if kv_total is not None:
        series.append((
            "serve_engine_kv_blocks_total",
            "Paged-KV blocks provisioned in the engine's pool",
            kv_total,
        ))
    if kv_cached is not None:
        series.append((
            "serve_engine_kv_blocks_cached",
            "Refcount-0 paged-KV blocks retained for prefix reuse",
            kv_cached,
        ))
    for name, desc, value in series:
        _gauge(name, desc, ENGINE_TAGS).set(
            float(value), tags=tags
        )


# ---------------------------------------------------------------------
# read side: fold the head's metric table into per-deployment rows
# ---------------------------------------------------------------------

def _tag_dict(flat: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if not flat:
        return out
    for part in flat.split("|"):
        key, _, value = part.partition("=")
        out[key] = value
    return out


def deployment_snapshot(summary: Dict[str, dict]) -> Dict[tuple, dict]:
    """Fold a `metrics_summary()` mapping into {(app, deployment):
    {p50_ms, p99_ms, requests_total, errors_total, executing, ...}} —
    the request-path half of `serve.status()` / `/api/serve`."""
    out: Dict[tuple, dict] = {}

    def row(tags: Dict[str, str]) -> Optional[dict]:
        app = tags.get("app")
        deployment = tags.get("deployment")
        if app is None or deployment is None or not deployment:
            return None
        return out.setdefault(
            (app, deployment),
            {
                "requests_total": 0.0,
                "errors_total": 0.0,
                "executing": 0.0,
            },
        )

    latency = summary.get("serve_request_latency_ms", {})
    for flat, series in (latency.get("by_tags") or {}).items():
        target = row(_tag_dict(flat))
        if target is None:
            continue
        for stat in ("p50", "p99"):
            if stat in series:
                target[f"{stat}_ms"] = series[stat]
        target["mean_ms"] = round(
            series.get("sum", 0.0) / series["count"], 3
        ) if series.get("count") else 0.0

    counts = summary.get("serve_requests_total", {})
    for flat, series in (counts.get("by_tags") or {}).items():
        tags = _tag_dict(flat)
        target = row(tags)
        if target is None:
            continue
        total = float(series.get("total", 0.0) or 0.0)
        target["requests_total"] += total
        if tags.get("outcome") == "error":
            target["errors_total"] += total

    executing = summary.get("serve_replica_executing", {})
    for flat, series in (executing.get("by_tags") or {}).items():
        target = row(_tag_dict(flat))
        if target is None:
            continue
        target["executing"] += float(series.get("value", 0.0) or 0.0)

    queue_wait = summary.get("serve_queue_wait_ms", {})
    for flat, series in (queue_wait.get("by_tags") or {}).items():
        target = row(_tag_dict(flat))
        if target is None or not series.get("count"):
            continue
        target["queue_wait_p50_ms"] = series.get("p50", 0.0)

    model_load = summary.get("serve_model_load_ms", {})
    for flat, series in (model_load.get("by_tags") or {}).items():
        target = row(_tag_dict(flat))
        if target is None or not series.get("count"):
            continue
        target["model_loads"] = series.get("count", 0)
        target["model_load_p50_ms"] = series.get("p50", 0.0)

    _fold_engine(summary, row, out)
    return out


def _fold_engine(summary: Dict[str, dict], row, out) -> None:
    """Continuous-batching engine series -> per-deployment rows: a
    nested per-family breakdown plus summed top-level occupancy (the
    at-a-glance numbers `/api/serve` and `serve.status()` show)."""

    def family_row(tags: Dict[str, str]) -> Optional[dict]:
        target = row(tags)
        if target is None:
            return None
        families = target.setdefault("engine", {})
        return families.setdefault(tags.get("family", "default"), {})

    def fold(metric: str, fn) -> None:
        for flat, series in (
            summary.get(metric, {}).get("by_tags") or {}
        ).items():
            tags = _tag_dict(flat)
            target = family_row(tags)
            if target is not None:
                fn(target, series)

    fold(
        "serve_engine_slots_used",
        lambda t, s: t.__setitem__(
            "slots_used", float(s.get("value", 0.0) or 0.0)
        ),
    )
    fold(
        "serve_engine_slots_total",
        lambda t, s: t.__setitem__(
            "slots_total", float(s.get("value", 0.0) or 0.0)
        ),
    )
    fold(
        "serve_engine_waiting",
        lambda t, s: t.__setitem__(
            "waiting", float(s.get("value", 0.0) or 0.0)
        ),
    )
    fold(
        "serve_engine_tokens_total",
        lambda t, s: t.__setitem__(
            "tokens_total", float(s.get("total", 0.0) or 0.0)
        ),
    )
    fold(
        "serve_engine_kv_blocks_used",
        lambda t, s: t.__setitem__(
            "kv_blocks_used", float(s.get("value", 0.0) or 0.0)
        ),
    )
    fold(
        "serve_engine_kv_blocks_total",
        lambda t, s: t.__setitem__(
            "kv_blocks_total", float(s.get("value", 0.0) or 0.0)
        ),
    )
    fold(
        "serve_engine_prefix_hits_total",
        lambda t, s: t.__setitem__(
            "prefix_hits", float(s.get("total", 0.0) or 0.0)
        ),
    )
    fold(
        "serve_engine_prefix_misses_total",
        lambda t, s: t.__setitem__(
            "prefix_misses", float(s.get("total", 0.0) or 0.0)
        ),
    )

    def histo(target: dict, series: dict, prefix: str) -> None:
        if not series.get("count"):
            return
        target[f"{prefix}_p50"] = series.get("p50", 0.0)
        if "p99" in series:
            target[f"{prefix}_p99"] = series["p99"]

    fold(
        "serve_engine_step_batch",
        lambda t, s: histo(t, s, "batch"),
    )
    fold(
        "serve_engine_decode_step_ms",
        lambda t, s: histo(t, s, "decode_ms"),
    )
    fold(
        "serve_engine_ttft_ms",
        lambda t, s: histo(t, s, "ttft_ms"),
    )

    # Summed top-level occupancy per deployment (families collapse
    # into the at-a-glance columns).
    for target in out.values():
        families = target.get("engine")
        if not families:
            continue
        for key in (
            "slots_used", "slots_total", "waiting", "tokens_total",
            "kv_blocks_used", "kv_blocks_total",
            "prefix_hits", "prefix_misses",
        ):
            target[f"engine_{key}"] = sum(
                f.get(key, 0.0) for f in families.values()
            )
