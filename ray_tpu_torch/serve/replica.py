# Copied from ray_tpu/serve/replica.py (JAX-free): module names read ray_tpu_torch.
"""Replica actor body.

Reference: python/ray/serve/_private/replica.py:750,998 — a replica
wraps the user callable; requests arrive as (method, args, kwargs);
handle-typed init args are materialized into live DeploymentHandles so
composed models call downstream deployments through the router.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any


class HandleRef:
    """Placeholder for a DeploymentHandle in pickled init args."""

    def __init__(self, app_name: str, deployment_name: str):
        self.app_name = app_name
        self.deployment_name = deployment_name


class Replica:
    def __init__(
        self,
        cls,
        init_args: tuple,
        init_kwargs: dict,
        replica_id: str,
        app_name: str = "",
        deployment_name: str = "",
    ):
        from .router import DeploymentHandle

        def materialize(value: Any) -> Any:
            if isinstance(value, HandleRef):
                return DeploymentHandle(
                    value.app_name, value.deployment_name
                )
            return value

        args = tuple(materialize(a) for a in init_args)
        kwargs = {k: materialize(v) for k, v in init_kwargs.items()}
        self._instance = cls(*args, **kwargs)
        # Multiplex LRU changes report this replica's loaded model set
        # to the controller, which long-poll-pushes it to routers
        # (multiplex.py reads this hook when it lazily builds the
        # wrapper on the first get_model call — after __init__, so
        # installing it here is early enough).
        if app_name and deployment_name:
            def _report_models(model_ids, _self=self):
                try:
                    import ray_tpu_torch as rt

                    from .controller import CONTROLLER_NAME

                    # get_actor directly: replicas run inside worker
                    # processes where api._rt()'s driver-style init
                    # path doesn't apply.
                    controller = rt.get_actor(
                        CONTROLLER_NAME, namespace="serve"
                    )
                    controller.record_multiplexed.remote(
                        app_name,
                        deployment_name,
                        replica_id,
                        list(model_ids),
                    )
                except Exception:
                    pass

            try:
                self._instance.__serve_multiplex_report__ = (
                    _report_models
                )
            except Exception:
                pass  # __slots__ classes: no router warmth hints
        self.replica_id = replica_id
        self._app_name = app_name
        self._deployment_name = deployment_name
        self._served = 0
        self._executing = 0
        # Replicas run with max_concurrency > 1 (controller wires
        # max_ongoing_requests through actor concurrency), so replica
        # bookkeeping must be thread-safe; the USER instance is
        # responsible for its own state under concurrent methods, as
        # in the reference's async replicas.
        self._served_lock = threading.Lock()
        self._started = time.time()

    def _begin_request(self, ctx: dict) -> None:
        """Request-entry bookkeeping: queue wait (router send -> here)
        and the executing gauge routers/`/api/serve` subtract from
        in-flight to derive queue depth."""
        from .observability import (
            observe_queue_wait,
            replica_executing,
        )

        with self._served_lock:
            self._served += 1
            self._executing += 1
            executing = self._executing
        sent = ctx.get("sent_ts")
        if sent is not None:
            observe_queue_wait(
                self._app_name,
                self._deployment_name,
                (time.time() - float(sent)) * 1e3,
            )
        replica_executing(
            self._app_name,
            self._deployment_name,
            self.replica_id,
            executing,
        )

    def _end_request(self) -> None:
        from .observability import replica_executing

        with self._served_lock:
            self._executing = max(0, self._executing - 1)
            executing = self._executing
        replica_executing(
            self._app_name,
            self._deployment_name,
            self.replica_id,
            executing,
        )

    def handle_request(
        self,
        method: str,
        args: tuple,
        kwargs: dict,
        model_id: str = "",
        ctx: dict = None,
    ):
        from ..util.tracing import remote_parent, span

        from .multiplex import _model_id_ctx, _set_request_model_id
        from .observability import (
            observe_handler,
            request_context,
            reset_request_context,
        )

        ctx = ctx or {}
        self._begin_request(ctx)
        target = (
            self._instance
            if method == "__call__"
            else getattr(self._instance, method)
        )
        token = _set_request_model_id(model_id)
        ctx_token = request_context(ctx)
        request_id = str(ctx.get("request_id", ""))
        t0 = time.perf_counter()
        error = False
        try:
            with remote_parent(ctx.get("trace")):
                with span(
                    "serve.handle",
                    request_id=request_id,
                    deployment=(
                        f"{self._app_name}/{self._deployment_name}"
                    ),
                ):
                    return target(*args, **kwargs)
        except BaseException:
            error = True
            raise
        finally:
            observe_handler(
                self._app_name,
                self._deployment_name,
                method,
                (time.perf_counter() - t0) * 1e3,
                error,
                request_id=request_id,
            )
            self._end_request()
            reset_request_context(ctx_token)
            _model_id_ctx.reset(token)

    def handle_request_streaming(
        self,
        method: str,
        args: tuple,
        kwargs: dict,
        model_id: str = "",
        ctx: dict = None,
    ):
        """Generator variant: the user method must yield chunks; each
        yield ships to the caller immediately over the runtime's
        streaming-generator transport (reference: replica.py
        handle_request_streaming + StreamingObjectRefGenerator).
        Called with num_returns='streaming' by the router. Latency is
        recorded over the WHOLE stream (first yield to exhaustion) —
        the number a token-streaming client experiences."""
        from .multiplex import _model_id_ctx, _set_request_model_id
        from .observability import (
            observe_handler,
            request_context,
            reset_request_context,
        )

        ctx = ctx or {}
        self._begin_request(ctx)
        target = (
            self._instance
            if method == "__call__"
            else getattr(self._instance, method)
        )
        token = _set_request_model_id(model_id)
        ctx_token = request_context(ctx)
        request_id = str(ctx.get("request_id", ""))
        t0 = time.perf_counter()
        error = False
        try:
            yield from target(*args, **kwargs)
        except BaseException:
            error = True
            raise
        finally:
            observe_handler(
                self._app_name,
                self._deployment_name,
                method,
                (time.perf_counter() - t0) * 1e3,
                error,
                request_id=request_id,
            )
            self._end_request()
            reset_request_context(ctx_token)
            _model_id_ctx.reset(token)

    def cancel_stream(self, request_id: str) -> bool:
        """Best-effort cancel of an in-flight streaming request: the
        consumer abandoned the stream (client disconnect,
        DeploymentResponseGenerator.close()), so a user callable that
        can stop producing should (the LLM engine frees the request's
        KV slot mid-decode). Instances opt in by implementing
        ``__serve_cancel_stream__(request_id) -> bool``; without the
        hook the stream simply runs to completion as before."""
        hook = getattr(
            self._instance, "__serve_cancel_stream__", None
        )
        if not callable(hook):
            return False
        try:
            return bool(hook(request_id))
        except Exception:
            return False

    def node_id(self) -> str:
        """This replica's node (routers prefer local replicas)."""
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()

    def handle_batch(
        self, method: str, batched_args: list, ctx: dict = None
    ):
        """One call carrying many requests; the user method receives
        the list (reference: serve/batching.py _BatchQueue). The whole
        batch shares one request context; per-item latency is the
        batch's (that is what each caller experienced)."""
        from .observability import (
            observe_handler,
            request_context,
            reset_request_context,
        )

        ctx = ctx or {}
        self._begin_request(ctx)
        with self._served_lock:
            self._served += len(batched_args) - 1
        target = getattr(self._instance, method)
        ctx_token = request_context(ctx)
        t0 = time.perf_counter()
        error = False
        try:
            return target(
                [a[0] if len(a) == 1 else a for a in batched_args]
            )
        except BaseException:
            error = True
            raise
        finally:
            dur_ms = (time.perf_counter() - t0) * 1e3
            for _ in batched_args:
                observe_handler(
                    self._app_name,
                    self._deployment_name,
                    method,
                    dur_ms,
                    error,
                    request_id=str(ctx.get("request_id", "")),
                )
            self._end_request()
            reset_request_context(ctx_token)

    def stats(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "pid": os.getpid(),
            "served": self._served,
            "executing": self._executing,
            "uptime_s": time.time() - self._started,
        }

    def reconfigure(self, user_config: Any) -> None:
        if hasattr(self._instance, "reconfigure"):
            self._instance.reconfigure(user_config)

    def ping(self) -> bool:
        return True
