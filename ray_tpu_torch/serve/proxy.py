# Copied from ray_tpu/serve/proxy.py (JAX-free): module names read ray_tpu_torch.
"""HTTP ingress proxy.

Reference: python/ray/serve/_private/proxy.py:1135 — a per-node proxy
actor terminates HTTP and routes by path prefix to the application's
ingress deployment; serve.start() places one proxy on EVERY alive
node (reference: proxy_state.py per-node proxies), and each proxy's
routers prefer replicas on their own node. The reference runs
uvicorn/starlette (ASGI); here a stdlib ThreadingHTTPServer thread
inside the proxy actor serves the same role, and the request surface
handed to the ingress __call__ is a small Request object
(method/path/query/headers/body/json). Route changes arrive by
controller long-poll push (reference: long_poll.py), and generator
ingresses stream out as chunked transfer-encoding — token N is on the
wire while the replica computes token N+1. Admission control bounds
in-flight requests (immediate 503 + Retry-After past the cap) and
live connections (raw 503 before a handler thread spawns);
/-/healthz reports both shed counters.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse


class Request:
    """What the ingress deployment's __call__ receives."""

    def __init__(
        self,
        method: str,
        path: str,
        query_params: Dict[str, str],
        headers: Dict[str, str],
        body: bytes,
    ):
        self.method = method
        self.path = path
        self.query_params = query_params
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body)

    def text(self) -> str:
        return self.body.decode()


class Proxy:
    """Proxy actor body: serves HTTP on `port`, routes to ingress
    handles via longest-prefix match."""

    def __init__(
        self,
        port: int,
        fallback_ephemeral: bool = True,
        host: str = "127.0.0.1",
        grpc_port: int = None,
        max_concurrent_requests: int = 256,
        max_connections: int = 1024,
    ):
        self.port = port
        self._routes: Dict[str, Tuple[str, str]] = {}
        self._routes_ts = 0.0
        self._handles: Dict[Tuple[str, str], Any] = {}
        # Ingress admission control (reference: proxy.py limits in-
        # flight requests per proxy and uvicorn bounds connections;
        # an unbounded thread-per-connection server melts under a
        # connection flood). Saturated REQUESTS shed with 503 +
        # Retry-After (the client can act on it); saturated
        # CONNECTIONS get a raw 503 and a close before a handler
        # thread is ever spawned.
        self._request_slots = threading.BoundedSemaphore(
            max_concurrent_requests
        )
        self._conn_count = 0
        self._conn_lock = threading.Lock()
        self._max_connections = max_connections
        self.shed_requests = 0  # observability: /-/healthz surfaces it
        self.shed_connections = 0
        # SLO admission sheds (router raised DeploymentOverloaded:
        # every candidate replica's outstanding-token estimate is over
        # threshold — see serve/router.py).
        self.shed_slo = 0
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _serve(self):
                # Non-blocking admission: a saturated proxy answers
                # immediately instead of queueing unboundedly (a slow
                # replica would otherwise stack threads until OOM).
                if not proxy._request_slots.acquire(blocking=False):
                    with proxy._conn_lock:
                        proxy.shed_requests += 1
                    payload = json.dumps(
                        {"error": "proxy at max_concurrent_requests"}
                    ).encode()
                    self.send_response(503)
                    self.send_header("Retry-After", "1")
                    # Close rather than drain: the unread request body
                    # would otherwise desynchronize this keep-alive
                    # connection (next "request line" = body bytes),
                    # and draining would let a slow client occupy the
                    # very proxy that is shedding load.
                    self.send_header("Connection", "close")
                    self.close_connection = True
                    self.send_header(
                        "Content-Type", "application/json"
                    )
                    self.send_header(
                        "Content-Length", str(len(payload))
                    )
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                try:
                    try:
                        result = proxy._dispatch(self)
                    except Exception as e:  # noqa: BLE001 — 500
                        result = (
                            500,
                            json.dumps({"error": repr(e)}).encode(),
                            "application/json",
                        )
                    if result is None:
                        return  # response already streamed
                    status, payload, ctype = result
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    request_id = getattr(
                        self, "_rt_request_id", None
                    )
                    if request_id:
                        self.send_header("x-request-id", request_id)
                    retry_after = getattr(
                        self, "_rt_retry_after", None
                    )
                    if retry_after:
                        self.send_header("Retry-After", retry_after)
                    self.send_header(
                        "Content-Length", str(len(payload))
                    )
                    self.end_headers()
                    self.wfile.write(payload)
                finally:
                    proxy._request_slots.release()

            do_GET = do_POST = do_PUT = do_DELETE = _serve

        class BoundedThreadingHTTPServer(ThreadingHTTPServer):
            # Connection cap enforced BEFORE a handler thread spawns:
            # over the cap, write a minimal 503 and close. Keep-alive
            # connections hold a slot for their lifetime (like
            # uvicorn's --limit-concurrency), so the cap bounds proxy
            # thread count.
            def process_request(self, request, client_address):
                with proxy._conn_lock:
                    if proxy._conn_count >= proxy._max_connections:
                        proxy.shed_connections += 1
                        over = True
                    else:
                        proxy._conn_count += 1
                        over = False
                if over:
                    try:
                        request.sendall(
                            b"HTTP/1.1 503 Service Unavailable\r\n"
                            b"Connection: close\r\n"
                            b"Retry-After: 1\r\n"
                            b"Content-Length: 0\r\n\r\n"
                        )
                    except OSError:
                        pass
                    # Close via the BASE implementation: this
                    # connection never incremented the count, so it
                    # must not flow through the decrementing override.
                    ThreadingHTTPServer.shutdown_request(self, request)
                    return
                super().process_request(request, client_address)

            def shutdown_request(self, request):
                # Every admitted connection's close path (handler
                # thread finally, spawn-failure handle_error) lands
                # here exactly once.
                with proxy._conn_lock:
                    if proxy._conn_count > 0:
                        proxy._conn_count -= 1
                super().shutdown_request(request)

        import errno

        try:
            self._server = BoundedThreadingHTTPServer(
                (host, port), Handler
            )
        except OSError as e:
            if not fallback_ephemeral or e.errno != errno.EADDRINUSE:
                raise  # real bind failures must surface to the user
            # In-box multi-daemon clusters share one host: per-node
            # proxies can't all bind the same port there, so extras
            # take an ephemeral one (real multi-host nodes each bind
            # the configured port).
            self._server = BoundedThreadingHTTPServer(
                (host, 0), Handler
            )
        self.port = self._server.server_address[1]  # resolve port=0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        self._listener = threading.Thread(
            target=self._routes_listen_loop, daemon=True,
            name="serve-proxy-longpoll",
        )
        self._listener.start()
        # Optional gRPC ingress on the same proxy (reference:
        # proxy.py:431 gRPCProxy lives beside the HTTP proxy); routes
        # by `application` call metadata.
        self._grpc = None
        self.grpc_port = None
        if grpc_port is not None:
            from .grpc_ingress import GrpcIngress

            try:
                self._grpc = GrpcIngress(
                    grpc_port, self._grpc_handle_for,
                    self._grpc_app_names, host=host,
                )
            except OSError:
                if not fallback_ephemeral:
                    raise
                self._grpc = GrpcIngress(
                    0, self._grpc_handle_for,
                    self._grpc_app_names, host=host,
                )
            self.grpc_port = self._grpc.port

    # -- gRPC routing --------------------------------------------------
    def _grpc_handle_for(self, app: str):
        from .router import DeploymentHandle

        self._refresh_routes()
        targets = {
            a: (a, ingress)
            for _prefix, (a, ingress) in self._routes.items()
        }
        if app not in targets:
            self._refresh_routes(force=True)
            targets = {
                a: (a, ingress)
                for _prefix, (a, ingress) in self._routes.items()
            }
        key = targets.get(app)
        if key is None:
            return None
        if key not in self._handles:
            self._handles[key] = DeploymentHandle(*key)
        return self._handles[key]

    def _grpc_app_names(self) -> list:
        self._refresh_routes(force=True)
        return sorted({a for (a, _d) in self._routes.values()})

    # -- routing -------------------------------------------------------
    def _refresh_routes(self, force: bool = False) -> None:
        import ray_tpu_torch as rt

        from .controller import CONTROLLER_NAME

        if self._routes_ts and not force:
            return
        controller = rt.get_actor(CONTROLLER_NAME, namespace="serve")
        self._routes = rt.get(
            controller.get_routes.remote(), timeout=30
        )
        self._routes_ts = time.time()

    def _routes_listen_loop(self) -> None:
        """Route-table push (reference: proxy long-polls route_table
        through long_poll.py)."""
        import ray_tpu_torch as rt

        from .controller import CONTROLLER_NAME

        keys = {"routes": 0}
        while True:
            try:
                controller = rt.get_actor(
                    CONTROLLER_NAME, namespace="serve"
                )
                changed = rt.get(
                    controller.listen_for_change.remote(dict(keys)),
                    timeout=60,
                )
            except Exception:
                time.sleep(0.2)
                continue
            if not changed:
                continue
            update = changed.get("routes")
            if update is not None:
                keys["routes"] = update["snapshot_id"]
                self._routes = update["value"] or {}
                self._routes_ts = time.time()

    def _match(self, path: str):
        best = None
        for prefix, target in self._routes.items():
            if path == prefix or path.startswith(
                prefix.rstrip("/") + "/"
            ) or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, target)
        return best

    def _dispatch(self, handler) -> Tuple[int, bytes, str]:
        # The Handler instance persists across keep-alive requests:
        # clear per-request state up front so no response (healthz
        # included) can echo a PREVIOUS request's id or Retry-After.
        handler._rt_request_id = None
        handler._rt_retry_after = None
        parsed = urlparse(handler.path)
        if parsed.path == "/-/healthz":
            return self._healthz(handler)
        return self._dispatch_observed(handler, parsed)

    def _healthz(self, handler) -> Tuple[int, bytes, str]:
        # Drain any body so the keep-alive stream stays in sync.
        length = int(handler.headers.get("Content-Length") or 0)
        if length:
            handler.rfile.read(length)
        return (
            200,
            json.dumps({
                "status": "ok",
                "connections": self._conn_count,
                "shed_requests": self.shed_requests,
                "shed_connections": self.shed_connections,
                "shed_slo": self.shed_slo,
            }).encode(),
            "application/json",
        )

    def _dispatch_observed(self, handler, parsed):
        """Route + call the ingress, wrapped in the request-path
        observability layer: a request id (client ``x-request-id``
        honored, minted otherwise) that propagates router -> replica
        -> multiplex and returns as a response header, an ingress
        span, and per-deployment HTTP latency/status metrics."""
        from ..util.tracing import span

        from .observability import (
            REQUEST_ID_HEADER,
            new_request_id,
            observe_http,
        )

        request_id = (
            handler.headers.get(REQUEST_ID_HEADER) or new_request_id()
        )
        # Set for EVERY request, before routing: the handler instance
        # persists across keep-alive requests, so a late assignment
        # would echo request A's id on request B's 404/error response.
        handler._rt_request_id = request_id
        t0 = time.perf_counter()
        # Filled by _route_request with the route that actually
        # served the request — re-matching in the finally would both
        # rescan the table and misattribute across a mid-request
        # route-table refresh.
        target = {"app": "", "deployment": ""}
        status = 500
        try:
            with span(
                "serve.http",
                request_id=request_id,
                path=parsed.path,
            ):
                result = self._route_request(
                    handler, parsed, request_id, target
                )
            if result is None:
                # Streamed: the 200 header is already on the wire.
                status = 200
                return None
            status, payload, ctype = result
            return status, payload, ctype
        except Exception:
            status = 500
            raise
        finally:
            observe_http(
                target["app"],
                target["deployment"],
                parsed.path,
                status,
                (time.perf_counter() - t0) * 1e3,
                request_id,
            )

    def _route_request(self, handler, parsed, request_id, target):
        from .router import DeploymentHandle, DeploymentOverloaded

        self._refresh_routes()
        match = self._match(parsed.path)
        if match is None:
            self._refresh_routes(force=True)
            match = self._match(parsed.path)
        if match is None:
            return (
                404,
                json.dumps({"error": "no route"}).encode(),
                "application/json",
            )
        prefix, (app, ingress) = match
        target["app"], target["deployment"] = app, ingress
        key = (app, ingress)
        if key not in self._handles:
            self._handles[key] = DeploymentHandle(app, ingress)
        length = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(length) if length else b""
        request = Request(
            method=handler.command,
            path=parsed.path[len(prefix.rstrip("/")) :] or "/",
            query_params={
                k: v[0] for k, v in parse_qs(parsed.query).items()
            },
            headers=dict(handler.headers.items()),
            body=body,
        )
        handle = self._handles[key]
        handle._refresh()
        # Reference header: requests carry the model they need and the
        # router prefers replicas already holding it (multiplex.py).
        model_id = handler.headers.get(
            "serve_multiplexed_model_id", ""
        )
        with handle._lock:
            streaming = bool(
                (handle._state["spec"] or {}).get("ingress_streaming")
            )
        try:
            if streaming:
                chunks = handle.options(
                    stream=True,
                    multiplexed_model_id=model_id,
                    request_id=request_id,
                ).remote(request)
                self._stream_response(handler, chunks)
                return None
            handle = handle.options(
                multiplexed_model_id=model_id, request_id=request_id
            )
            response = handle.remote(request)
        except DeploymentOverloaded as e:
            # SLO admission shed: every candidate replica's queue is
            # already past the latency budget — a fast 503 the client
            # can back off on beats joining a queue whose TTFT has
            # collapsed (the raise happens BEFORE any streaming
            # header, so the connection stays clean).
            with self._conn_lock:
                self.shed_slo += 1
            retry_after = max(1, int(round(e.retry_after_s)))
            handler._rt_retry_after = str(retry_after)
            return (
                503,
                json.dumps({
                    "error": str(e),
                    "retry_after_s": retry_after,
                }).encode(),
                "application/json",
            )
        value = response.result(timeout=60)
        if isinstance(value, bytes):
            return 200, value, "application/octet-stream"
        if isinstance(value, str):
            return 200, value.encode(), "text/plain"
        return (
            200,
            json.dumps(value, default=str).encode(),
            "application/json",
        )

    def _stream_response(self, handler, chunks) -> None:
        """Chunked transfer-encoding: each replica yield goes on the
        wire immediately (reference: proxy.py streaming ASGI
        responses for generator deployments — LLM token output)."""
        handler.send_response(200)
        handler.send_header("Content-Type", "text/plain; charset=utf-8")
        # Streaming clients need the id MOST (runbook: grep a slow
        # stream's id into the flight-recorder rings).
        request_id = getattr(handler, "_rt_request_id", None)
        if request_id:
            handler.send_header("x-request-id", request_id)
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        # Once the 200 header is out, NOTHING may escape this method:
        # a propagated exception would make the outer handler write a
        # second (500) response onto the same keep-alive connection,
        # desynchronizing the next request. The 0-length terminator is
        # written ONLY on clean completion — a replica error mid-stream
        # aborts the socket so the client observes a truncated chunked
        # body (a detectable failure) instead of a well-formed 200 with
        # silently missing content.
        clean = False
        try:
            try:
                for chunk in chunks:
                    data = (
                        chunk
                        if isinstance(chunk, bytes)
                        else str(chunk).encode()
                    )
                    if not data:
                        continue
                    handler.wfile.write(
                        f"{len(data):X}\r\n".encode() + data + b"\r\n"
                    )
                    handler.wfile.flush()
                clean = True
            finally:
                # Releases the router's ongoing-count slot even when
                # the client disconnected mid-stream.
                close = getattr(chunks, "close", None)
                if close is not None:
                    close()
                if clean:
                    handler.wfile.write(b"0\r\n\r\n")
                else:
                    handler.close_connection = True
                    try:
                        handler.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
        except Exception:
            handler.close_connection = True

    def ready(self) -> int:
        return self.port

    def grpc_ready(self):
        return self.grpc_port

    def stop(self) -> bool:
        if self._grpc is not None:
            self._grpc.stop()
        self._server.shutdown()
        return True
