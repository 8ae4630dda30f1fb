# Copied from ray_tpu/serve/grpc_ingress.py (JAX-free): module names read ray_tpu_torch.
"""gRPC ingress for serve proxies.

Reference: python/ray/serve/_private/proxy.py:431 (gRPCProxy: the
per-node proxy terminates gRPC alongside HTTP) + grpc_util/ — requests
route by application name carried in call metadata, the same model the
reference uses (`application` metadata key), plus the built-in
RayServeAPIService surface (Healthz / ListApplications).

Implementation notes: the service is registered with grpc's GENERIC
handler API and bytes-identity (de)serializers, so no generated stubs
are required on either side — any grpc client (any language) calls
`/ray.serve.RayServeAPIService/...` with bytes payloads. Request
payloads are passed to the ingress deployment as-is (bytes); replies
are the deployment's return value (bytes passed through, str utf-8,
everything else JSON). `multiplexed_model_id` metadata maps to the
router's model-aware replica ranking exactly like the HTTP header.
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Any, Callable, Dict, Optional

SERVICE = "ray.serve.RayServeAPIService"


def _encode_reply(value: Any) -> bytes:
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode()
    return json.dumps(value, default=str).encode()


class GrpcIngress:
    """A grpc.Server routing Predict calls to application handles.

    `handle_for(app_name)` -> DeploymentHandle (or None), provided by
    the owning proxy; `app_names()` lists live applications.
    """

    def __init__(
        self,
        port: int,
        handle_for: Callable[[str], Optional[Any]],
        app_names: Callable[[], list],
        host: str = "127.0.0.1",
    ):
        import grpc

        self._handle_for = handle_for
        self._app_names = app_names

        def predict(request: bytes, context) -> bytes:
            metadata = dict(context.invocation_metadata())
            app = metadata.get("application", "")
            model_id = metadata.get("multiplexed_model_id", "")
            handle = self._handle_for(app)
            if handle is None:
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"no serve application {app!r}",
                )
            if model_id:
                handle = handle.options(
                    multiplexed_model_id=model_id
                )
            value = handle.remote(request).result(timeout=60)
            return _encode_reply(value)

        def healthz(request: bytes, context) -> bytes:
            return b"success"

        def list_applications(request: bytes, context) -> bytes:
            return json.dumps(sorted(self._app_names())).encode()

        rpcs = {
            "Predict": predict,
            "Healthz": healthz,
            "ListApplications": list_applications,
        }
        identity = lambda b: b  # noqa: E731 — bytes on the wire

        method_handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=identity,
                response_serializer=identity,
            )
            for name, fn in rpcs.items()
        }
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8)
        )
        self._server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    SERVICE, method_handlers
                ),
            )
        )
        bound = self._server.add_insecure_port(f"{host}:{port}")
        if bound == 0:
            raise OSError(f"could not bind gRPC ingress on {port}")
        self.port = bound
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=0.5)


def grpc_methods(channel):
    """Client-side callables for the ingress service over an existing
    grpc channel — bytes in / bytes out, no generated stubs needed::

        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        predict, healthz, list_apps = grpc_methods(channel)
        reply = predict(b"payload",
                        metadata=[("application", "myapp")])
    """
    identity = lambda b: b  # noqa: E731

    def unary(name):
        return channel.unary_unary(
            f"/{SERVICE}/{name}",
            request_serializer=identity,
            response_deserializer=identity,
        )

    return (
        unary("Predict"),
        unary("Healthz"),
        unary("ListApplications"),
    )
