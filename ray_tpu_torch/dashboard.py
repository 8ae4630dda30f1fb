# Copied from ray_tpu/dashboard.py (JAX-free): module names read ray_tpu_torch.
"""Dashboard-lite: JSON/HTML cluster introspection over HTTP.

Reference: python/ray/dashboard — an aiohttp head serving a React SPA
plus per-node agents. The TPU-native rebuild keeps the data plane (the
state API the SPA consumes) and serves it as JSON endpoints + a
self-contained HTML page + a Prometheus text endpoint, from a stdlib
HTTP thread on the driver or via `python -m ray_tpu_torch dashboard`.

Endpoints: /            — HTML summary page (auto-refreshing)
           /api/summary — state summary
           /api/nodes | /api/actors | /api/tasks | /api/objects
           /api/placement_groups | /api/resources | /api/metrics
           /api/serve   — per-deployment serving stats (p50/p99,
                          in-flight, queue depth)
           /api/memory  — cluster memory ledger (per-job/-owner
                          attribution, leak suspects, verdict.memory)
           /api/transfers — data-plane transfer matrix (per-(job,
                          src, dst) flows, get provenance, locality
                          hit rates, top remote-pulling task classes)
           /api/timeseries?name=...&since=...&limit=...
                        — head snapshot-ring history
           /metrics     — Prometheus exposition text (0.0.4)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

#: Self-contained SPA (no build step, no external assets — the
#: reference ships a React bundle; this serves the same state API from
#: one static page with fetch polling).
_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><meta charset="utf-8">
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f6f7f9;color:#1c2430}
 header{background:#1c2430;color:#fff;padding:10px 20px;display:flex;
   align-items:baseline;gap:16px}
 header h1{font-size:18px;margin:0}
 header span{color:#9fb0c3;font-size:12px}
 nav{display:flex;gap:4px;padding:8px 16px;background:#fff;
   border-bottom:1px solid #dde3ea}
 nav button{border:0;background:none;padding:6px 12px;cursor:pointer;
   border-radius:6px;font-size:13px;color:#44506a}
 nav button.active{background:#e8eefc;color:#1a48c4;font-weight:600}
 main{padding:16px 20px}
 .cards{display:flex;gap:12px;flex-wrap:wrap;margin-bottom:16px}
 .card{background:#fff;border:1px solid #dde3ea;border-radius:8px;
   padding:10px 16px;min-width:110px}
 .card .v{font-size:22px;font-weight:700}
 .card .k{font-size:11px;color:#7a8699;text-transform:uppercase}
 table{border-collapse:collapse;background:#fff;width:100%;font-size:13px}
 td,th{border:1px solid #e3e8ef;padding:6px 10px;text-align:left}
 th{background:#eef1f6;font-weight:600}
 tr:nth-child(even) td{background:#fafbfd}
 #err{color:#b00020;font-size:12px}
 code{font-size:12px}
</style></head><body>
<header><h1>ray_tpu_torch</h1><span id="addr"></span><span id="err"></span></header>
<nav id="tabs"></nav><main>
 <div class="cards" id="cards"></div>
 <div id="view"></div>
</main>
<script>
const TABS = ["nodes","actors","tasks","objects","memory","transfers",
              "placement_groups","resources","metrics","serve",
              "spans","steps","compile","doctor"];
let active = "nodes";
const $ = (id) => document.getElementById(id);
function tabs() {
  $("tabs").innerHTML = TABS.map(t =>
    `<button class="${t===active?"active":""}"
       onclick="active='${t}';tabs();tick()">${t.replace("_"," ")}</button>`
  ).join("");
}
function esc(s) {
  return String(s).replace(/[&<>"']/g, c => ({"&":"&amp;","<":"&lt;",
    ">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
}
function table(rows) {
  if (!Array.isArray(rows)) rows = rows ? [rows] : [];
  if (!rows.length) return "<i>none</i>";
  // Union of keys: rows can be heterogeneous (metrics kinds).
  const keys = [...new Set(rows.flatMap(r => Object.keys(r)))];
  const fmt = v => v === undefined ? ""
    : typeof v === "object" && v !== null
      ? `<code>${esc(JSON.stringify(v))}</code>` : esc(v);
  return "<table><tr>" + keys.map(k=>`<th>${esc(k)}</th>`).join("") +
    "</tr>" + rows.map(r => "<tr>" +
      keys.map(k=>`<td>${fmt(r[k])}</td>`).join("") + "</tr>").join("") +
    "</table>";
}
async function j(path) {
  const resp = await fetch(path);
  if (!resp.ok) throw new Error(path + " -> HTTP " + resp.status);
  return resp.json();
}
async function tick() {
  const tab = active;  // discard stale responses after a tab switch
  try {
    const s = await j("/api/summary");
    const sum = s.summary || s;
    $("cards").innerHTML = [
      ["nodes", sum.alive_nodes], ["actors", sum.actors],
      ["workers", sum.workers], ["queued", sum.queued_tasks],
      ["objects", sum.num_objects],
      ["store", ((sum.used||0)/1048576).toFixed(1)+" / "+
                ((sum.capacity||0)/1048576).toFixed(0)+" MB"],
      ["spilled", ((sum.spilled_bytes||0)/1048576).toFixed(1)+" MB"],
    ].map(([k,v]) =>
      `<div class="card"><div class="v">${esc(v ?? 0)}</div>
       <div class="k">${esc(k)}</div></div>`).join("");
    const data = await j("/api/" + tab);
    if (tab !== active) return;
    if (tab === "memory") {
      // Nested payload (lists inside a dict): one table per section,
      // not the flat spread — spreading an array makes index columns.
      const v = data.verdict || {};
      const problems = ["near_capacity","leak_suspects","spill_thrash"]
        .flatMap(k => (v[k]||[]).map(p => ({kind:k, ...p})));
      $("view").innerHTML =
        "<h3>totals</h3>" + table(
          {...(data.totals||{}), ...(data.disabled?{disabled:true}:{})}) +
        "<h3>jobs</h3>" + table(
          Object.entries(data.jobs||{}).map(([k,r]) => ({job:k, ...r}))) +
        "<h3>owners</h3>" + table(data.owners||[]) +
        "<h3>nodes</h3>" + table((data.nodes||[]).map(n => ({
          node:n.node, arena_used:n.arena_used,
          arena_capacity:n.arena_capacity, objects:n.tracked_objects,
          attributed:n.attributed_bytes, spilled:n.spilled_bytes}))) +
        "<h3>top objects</h3>" + table(data.top_objects||[]) +
        "<h3>verdict</h3>" + table(problems);
    } else if (tab === "transfers") {
      // Same nested-payload shape as memory: section tables, not a
      // flat spread.
      $("view").innerHTML =
        (data.disabled ? "<p><i>transfer instrumentation disabled " +
          "(transfer_report_interval_s or memory_report_interval_s " +
          "&le; 0)</i></p>" : "") +
        "<h3>flows (src &rarr; dst)</h3>" + table(data.flows||[]) +
        "<h3>provenance by job</h3>" + table(
          Object.entries(data.provenance||{}).map(([k,r]) =>
            ({job:k, ...r}))) +
        "<h3>locality</h3>" + table(
          Object.entries(data.locality||{}).map(([k,r]) =>
            ({job:k, ...r}))) +
        "<h3>top remote-pulling task classes</h3>" +
          table(data.tasks||[]) +
        "<h3>spill/restore ops by job</h3>" + table(
          [...new Set([...Object.keys(data.job_spill_ops||{}),
                       ...Object.keys(data.job_restore_ops||{})])]
            .map(k => ({job:k, spills:(data.job_spill_ops||{})[k]||0,
                        restores:(data.job_restore_ops||{})[k]||0})));
    } else $("view").innerHTML = table(
      tab === "resources" || tab === "metrics" || tab === "steps" ||
      tab === "serve" || tab === "compile"
        ? Object.entries(data).map(([k,v]) => ({name:k, ...(
            typeof v === "object" ? v : {value:v})}))
        : data);
    $("err").textContent = "";
  } catch (e) { $("err").textContent = "fetch failed: " + e; }
}
$("addr").textContent = location.host;
tabs(); tick(); setInterval(tick, 2000);
</script></body></html>"""


_UNKNOWN_API = object()


class Dashboard:
    def __init__(self, port: int = 8265):
        from .util import state as state_api

        self._state = state_api
        # Per-INSTANCE doctor cache: a class-level one would survive
        # shutdown/re-init and serve cluster A's verdict as cluster
        # B's health for up to a TTL.
        self._doctor_cache = (0.0, None)
        self._doctor_lock = threading.Lock()
        dashboard = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):
                try:
                    status, payload, ctype = dashboard._route(self.path)
                except Exception as e:  # noqa: BLE001 — 500 surface
                    status = 500
                    payload = json.dumps({"error": repr(e)}).encode()
                    ctype = "application/json"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def _collect(self, kind: str):
        import ray_tpu_torch

        state = self._state
        handlers = {
            "summary": lambda: ray_tpu_torch.state_summary(),
            "nodes": state.list_nodes,
            "actors": state.list_actors,
            "tasks": state.list_tasks,
            "objects": state.list_objects,
            "placement_groups": state.list_placement_groups,
            "resources": lambda: {
                "total": ray_tpu_torch.cluster_resources(),
                "available": ray_tpu_torch.available_resources(),
            },
            "metrics": self._metrics,
            "memory": self._memory,
            "transfers": self._transfers,
            "serve": self._serve,
            "spans": self._spans,
            "steps": self._steps,
            "compile": self._compile,
            "doctor": self._doctor,
        }
        fn = handlers.get(kind)
        if fn is None:
            # Sentinel, not an exception: a KeyError raised INSIDE a
            # handler must stay a 500, not read as "no such api".
            return _UNKNOWN_API
        return fn()

    @staticmethod
    def _metrics():
        from .util.metrics import metrics_summary

        return metrics_summary()

    @staticmethod
    def _memory():
        """/api/memory — the cluster memory ledger: per-job/-owner
        attribution, top objects, per-node reports, verdict.memory
        (see `ray_tpu_torch memory`)."""
        from .util.state import memory_summary

        return memory_summary()

    @staticmethod
    def _transfers():
        """/api/transfers — the cluster transfer matrix: per-(job,
        src_node, dst_node) flows with bytes/pulls/restores/aborts,
        per-job get provenance and locality hit rates, and the top
        remote-pulling task classes (see
        `ray_tpu_torch memory --transfers`)."""
        from .util.state import transfer_summary

        return transfer_summary()

    @staticmethod
    def _serve():
        """Per-deployment serving observability: replica/ingress
        state from the controller merged with the head's request-path
        histograms (p50/p99, counts, in-flight, queue depth). Empty
        when serve was never started — the dashboard must work on
        training-only clusters."""
        from .serve.api import status_detail

        return status_detail()

    @staticmethod
    def _timeseries(query: str):
        """/api/timeseries?name=...&since=...&limit=... — the head's
        bounded snapshot ring (see util.metrics.metrics_timeseries)."""
        from urllib.parse import parse_qs

        from .util.metrics import metrics_timeseries

        params = {
            k: v[0] for k, v in parse_qs(query or "").items()
        }
        return metrics_timeseries(
            name=params.get("name"),
            since=float(params.get("since", 0.0) or 0.0),
            limit=int(params.get("limit", 0) or 0),
        )

    @staticmethod
    def _spans():
        """Most recent tracing spans, newest first (full OTLP export
        via util.tracing.export_otlp)."""
        from ._private.worker import global_worker

        worker = global_worker()
        if worker is None:
            return []
        records = worker.call("list_spans", limit=200)["spans"]
        return [
            {
                "name": r["name"],
                "trace": r["trace_id"][:8],
                "span": r["span_id"][:8],
                "parent": (r.get("parent_span_id") or "")[:8],
                "ms": round((r["end_ns"] - r["start_ns"]) / 1e6, 2),
                "attributes": r.get("attributes") or {},
            }
            for r in reversed(records)
        ]

    @staticmethod
    def _steps():
        """Gang-step telemetry digest: per-worker step-time stats +
        per-step skew, newest-first raw records behind it."""
        from ._private.worker import global_worker

        worker = global_worker()
        if worker is None:
            return {}
        reply = worker.call("step_summary", limit=1000)
        summary = reply["summary"]
        return {
            "max_skew_ms": summary.get("max_skew_ms", 0.0),
            "steps_observed": summary.get("steps_observed", 0),
            # Per-job goodput classification (productive vs
            # data_wait/h2d/ckpt_block/idle) over the same window.
            **{
                f"goodput {job or 'job'}": row
                for job, row in sorted(
                    summary.get("goodput", {}).items()
                )
            },
            **{
                f"rank {rank}": row
                for rank, row in sorted(
                    summary.get("workers", {}).items()
                )
            },
        }

    @staticmethod
    def _compile():
        """/api/compile — the head's XLA compile-watch table: one row
        per registered program (compile count, total ms, distinct
        shape digests) plus the current recompile-storm findings."""
        from ._private.worker import global_worker

        worker = global_worker()
        if worker is None:
            return {}
        summary = worker.call("compile_summary")["compile"]
        out = {
            name: {
                "compiles": row.get("compiles", 0),
                "total_ms": row.get("total_ms", 0.0),
                "distinct_shapes": row.get("distinct_shapes", 0),
            }
            for name, row in sorted(
                summary.get("programs", {}).items()
            )
        }
        for i, storm in enumerate(summary.get("storms", [])):
            out[f"storm {i}"] = {
                "program": storm.get("program"),
                "detail": storm.get("detail"),
            }
        return out

    #: Seconds a doctor verdict is served to polls before refresh:
    #: diagnose fans out per-worker inspect RPCs cluster-wide, far
    #: too heavy for the page's 2-second tick.
    _DOCTOR_TTL_S = 10.0

    def _doctor(self):
        """Stall-doctor verdict (rt.diagnose), cached for
        _DOCTOR_TTL_S. Stacks are skipped: a dashboard poll must not
        trigger cluster-wide profile captures — use `ray_tpu_torch doctor`
        for those. The lock keeps one diagnose in flight no matter
        how many polls stack up behind a slow one (ThreadingHTTPServer
        + a 2 s page tick would otherwise fan out a cluster-wide
        diagnose per poll exactly when the cluster is sick); waiters
        re-check the cache the refresher just filled."""
        import time

        import ray_tpu_torch

        with self._doctor_lock:
            now = time.monotonic()
            cached_at, verdict = self._doctor_cache
            if (
                verdict is None
                or now - cached_at >= self._DOCTOR_TTL_S
            ):
                verdict = ray_tpu_torch.diagnose(capture_stacks=False)
                self._doctor_cache = (time.monotonic(), verdict)
        return verdict

    @staticmethod
    def _profile(query: str):
        """On-demand worker profiling (reference: dashboard reporter
        profile endpoints). /api/profile?pid=N[&kind=cpu|stack|memory]
        [&duration_s=S][&hz=H][&top=K][&node=<node hex>]."""
        from urllib.parse import parse_qs

        from .util.state import profile_worker

        params = {
            k: v[0] for k, v in parse_qs(query or "").items()
        }
        if "pid" not in params:
            raise ValueError("profile requires ?pid=<worker pid>")
        return profile_worker(
            int(params["pid"]),
            kind=params.get("kind", "cpu"),
            duration_s=float(params.get("duration_s", 5.0)),
            hz=float(params.get("hz", 100.0)),
            top=int(params.get("top", 20)),
            node_id=params.get("node"),
        )

    def _route(self, path: str):
        if path.startswith("/api/profile"):
            _, _, query = path.partition("?")
            payload = json.dumps(
                self._profile(query), default=str
            ).encode()
            return 200, payload, "application/json"
        if path.startswith("/api/timeseries"):
            _, _, query = path.partition("?")
            payload = json.dumps(
                self._timeseries(query), default=str
            ).encode()
            return 200, payload, "application/json"
        if path.startswith("/api/"):
            kind = path[len("/api/") :].strip("/")
            data = self._collect(kind)
            if data is _UNKNOWN_API:
                return (
                    404,
                    json.dumps({"error": f"no such api: {kind}"}).encode(),
                    "application/json",
                )
            return (
                200,
                json.dumps(data, default=str).encode(),
                "application/json",
            )
        if path == "/metrics":
            from .util.prometheus import render_prometheus

            return (
                200,
                render_prometheus(self._metrics()).encode(),
                "text/plain; version=0.0.4",
            )
        if path in ("/", "/index.html"):
            return 200, _PAGE.encode(), "text/html"
        return (
            404,
            json.dumps({"error": "not found"}).encode(),
            "application/json",
        )

    def stop(self) -> None:
        self._server.shutdown()


def start_dashboard(port: int = 8265) -> Dashboard:
    """Serve the dashboard from this (driver) process."""
    return Dashboard(port)
