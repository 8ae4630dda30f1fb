# Copied from ray_tpu/serve/api.py (JAX-free): module names read ray_tpu_torch.
"""Serve public API.

Reference: python/ray/serve/api.py — serve.run(app) deploys through
the controller and returns the ingress handle (:492); serve.start
brings up HTTP ingress; status/delete/shutdown manage lifecycle.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Optional

import cloudpickle

from .controller import CONTROLLER_NAME, ServeController
from .deployment import Application, AutoscalingConfig, Deployment
from .proxy import Proxy
from .replica import HandleRef
from .router import DeploymentHandle

PROXY_NAME = "SERVE_PROXY"


def _proxy_name(node_id: str) -> str:
    """Deterministic per-node proxy actor name. Keyed ONLY on the
    node id — never on which driver called start() — so any driver on
    any node resolves (and shuts down) every proxy (reference:
    proxy_state.py names proxies by node id for the same reason)."""
    return f"{PROXY_NAME}:{node_id[:12]}"
_NAMESPACE = "serve"


def _rt():
    import ray_tpu_torch as rt

    if not rt.is_initialized():
        rt.init(ignore_reinit_error=True)
    return rt


def _get_or_create_controller():
    rt = _rt()
    try:
        return rt.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)
    except ValueError:
        pass
    # Long-poll listeners (one per router/proxy) BLOCK inside
    # listen_for_change; the controller must run them on a wide
    # thread pool or one parked listener starves every control call
    # (reference: the controller is an async actor).
    actor_cls = rt.remote(
        num_cpus=0,
        name=CONTROLLER_NAME,
        namespace=_NAMESPACE,
        max_concurrency=64,
    )(ServeController)
    handle = actor_cls.remote()
    # Touch it so creation completed before anyone races lookups.
    rt.get(handle.status.remote(), timeout=60)
    return handle


def _build_specs(app: Application, app_name: str):
    """Flatten the bound graph into deployment specs; nested bound
    deployments become HandleRefs materialized in the replica
    (reference: build_app + handle injection)."""
    flat = app.flatten()
    specs = []
    for bound in flat:
        dep: Deployment = bound.deployment

        def convert(value):
            if isinstance(value, Application):
                return HandleRef(app_name, value.deployment.name)
            return value

        batched = {}
        for attr_name in dir(dep.underlying):
            attr = getattr(dep.underlying, attr_name, None)
            cfg = getattr(attr, "__rt_serve_batch__", None)
            if cfg:
                batched[attr_name] = cfg
        specs.append(
            {
                "name": dep.name,
                "cls_blob": cloudpickle.dumps(dep.underlying),
                "init_args": tuple(convert(a) for a in bound.args),
                "init_kwargs": {
                    k: convert(v) for k, v in bound.kwargs.items()
                },
                "num_replicas": dep.num_replicas,
                "actor_options": dep.ray_actor_options,
                "autoscaling": dataclasses.asdict(dep.autoscaling_config)
                if dep.autoscaling_config
                else None,
                "max_ongoing_requests": dep.max_ongoing_requests,
                "version": dep.version,
                "batched_methods": batched,
                "ingress": bound is flat[-1],
                # Generator __call__ => the proxy streams the response
                # out as chunked transfer-encoding (reference: serve
                # supports generator deployments for streaming).
                "ingress_streaming": inspect.isgeneratorfunction(
                    getattr(dep.underlying, "__call__", None)
                ),
            }
        )
    return specs


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = "/",
) -> DeploymentHandle:
    rt = _rt()
    controller = _get_or_create_controller()
    specs = _build_specs(app, name)
    rt.get(
        controller.deploy_app.remote(name, route_prefix, specs),
        timeout=120,
    )
    return DeploymentHandle(name, app.deployment.name)


def start(
    http_port: int = 8000,
    per_node: bool = True,
    http_host: str = "127.0.0.1",
    grpc_port: Optional[int] = None,
) -> int:
    """Start HTTP proxies — one per alive node, each pinned with node
    affinity and routing to LOCAL replicas first (reference:
    serve.start + proxy_state.py per-node ProxyActors). Returns the
    port of this node's proxy. Pass http_host="0.0.0.0" on a real
    multi-host cluster so every node's proxy is reachable from
    outside its host. On in-box test clusters (all daemons on one
    host) the extra proxies take ephemeral ports when http_port is
    already bound; query them via `proxy_ports()`. The LOCAL proxy
    never silently rebinds — a port conflict on this node raises."""
    from ..util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    rt = _rt()
    _get_or_create_controller()
    local_node = rt.get_runtime_context().get_node_id()
    node_ids = (
        [n["node_id"] for n in rt.nodes() if n.get("alive")]
        if per_node
        else [local_node]
    )
    local_port = None
    for node_id in node_ids:
        name = _proxy_name(node_id)
        try:
            proxy = rt.get_actor(name, namespace=_NAMESPACE)
        except ValueError:
            actor_cls = rt.remote(
                num_cpus=0,
                name=name,
                namespace=_NAMESPACE,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node_id
                ),
            )(Proxy)
            proxy = actor_cls.remote(
                http_port,
                node_id != local_node,  # extras may take ephemeral
                http_host,
                grpc_port,
            )
        port = rt.get(proxy.ready.remote(), timeout=60)
        if node_id == local_node:
            local_port = port
    return local_port if local_port is not None else http_port


def local_grpc_port() -> Optional[int]:
    """Bound gRPC ingress port of this node's proxy (None when
    serve.start ran without grpc_port)."""
    rt = _rt()
    node_id = rt.get_runtime_context().get_node_id()
    try:
        proxy = rt.get_actor(_proxy_name(node_id), namespace=_NAMESPACE)
        return rt.get(proxy.grpc_ready.remote(), timeout=30)
    except Exception:
        return None


def proxy_ports() -> Dict[str, int]:
    """node_id -> bound proxy port for every running proxy."""
    rt = _rt()
    out: Dict[str, int] = {}
    for node in rt.nodes():
        node_id = node["node_id"]
        name = _proxy_name(node_id)
        try:
            proxy = rt.get_actor(name, namespace=_NAMESPACE)
            out[node_id] = rt.get(proxy.ready.remote(), timeout=30)
        except Exception:
            continue
    return out


def status() -> Dict[str, Any]:
    """Live per-app state: route prefix plus, per deployment, replica
    count, version, in-flight request count (router-reported), and —
    when request-path metrics have reached the head — p50/p99 handler
    latency, request/error totals and derived queue depth. The raw
    shape under ``{app: {"deployments": {name: {...}}}}`` is stable;
    metric keys appear once traffic has flowed."""
    rt = _rt()
    controller = _get_or_create_controller()
    base = rt.get(controller.status.remote(), timeout=30)
    return _merge_request_metrics(base)


def _merge_request_metrics(base: Dict[str, Any]) -> Dict[str, Any]:
    """Fold the head's serve histograms (observability.py) into the
    controller's structural status. Best-effort: a head that has seen
    no serve metrics yet (or an uninitialized summary read) leaves the
    structural status intact."""
    from .observability import deployment_snapshot

    try:
        from ..util.metrics import metrics_summary

        snapshot = deployment_snapshot(metrics_summary())
    except Exception:
        return base
    for app, state in base.items():
        for name, dep in (state.get("deployments") or {}).items():
            row = snapshot.get((app, name))
            if not row:
                continue
            dep.update(row)
            # Queue depth = routed-but-not-yet-executing: requests a
            # router has sent that no replica is running yet (actor
            # mailbox + wire). Derived, so the proxy/router never pays
            # a queue-tracking RPC.
            dep["queue_depth"] = max(
                0.0,
                float(dep.get("in_flight", 0.0))
                - float(row.get("executing", 0.0)),
            )
    return base


def status_detail() -> Dict[str, Any]:
    """`/api/serve` payload: `status()` flattened to one row per
    deployment (app/deployment in the row), empty when serve was
    never started on this cluster."""
    import ray_tpu_torch as rt

    try:
        rt.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)
    except Exception:
        return {}
    out: Dict[str, Any] = {}
    for app, state in status().items():
        for name, dep in (state.get("deployments") or {}).items():
            out[f"{app}/{name}"] = {
                "route_prefix": state.get("route_prefix"),
                **dep,
            }
    # Per-family engine compile counts from the head's compile-watch
    # table (ISSUE 15): the engine registers its jitted programs as
    # engine.<kind>[<family>], so the cluster-folded counts are
    # already on the head — no per-replica RPC. A count that moves
    # under steady traffic is a mid-traffic recompile, i.e. an
    # engine bug, now visible next to the deployment rows.
    try:
        from ..util.state import compile_summary

        for prog, row in sorted(
            compile_summary().get("programs", {}).items()
        ):
            if not prog.startswith("engine."):
                continue
            kind, _, family = prog[len("engine."):].partition("[")
            family = family.rstrip("]") or "default"
            entry = out.setdefault(
                f"engine:{family}", {"family": family}
            )
            entry[f"{kind}_compiles"] = row.get("compiles", 0)
            entry[f"{kind}_shapes"] = row.get("distinct_shapes", 0)
    except Exception:  # noqa: BLE001 — status must not need compiles
        pass
    return out


def get_app_handle(name: str = "default") -> DeploymentHandle:
    rt = _rt()
    controller = _get_or_create_controller()
    state = rt.get(controller.status.remote(), timeout=30)
    if name not in state:
        raise ValueError(f"no application {name!r}")
    routes = rt.get(controller.get_routes.remote(), timeout=30)
    for _, (app, ingress) in routes.items():
        if app == name:
            return DeploymentHandle(name, ingress)
    # Route-less app: find its ingress via status order.
    raise ValueError(f"application {name!r} has no ingress route")


def delete(name: str) -> None:
    rt = _rt()
    controller = _get_or_create_controller()
    rt.get(controller.delete_app.remote(name), timeout=60)


def shutdown() -> None:
    from . import router as _router

    rt = _rt()
    # Stop this process's long-poll listener threads (new handles
    # created by a later deploy start fresh listeners).
    _router.notify_shutdown()
    try:
        controller = rt.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)
    except ValueError:
        return
    try:
        rt.get(controller.shutdown_all.remote(), timeout=60)
    except Exception:
        pass
    # Kill every per-node proxy (names are node-id-keyed, so any
    # driver — not just the one that called start() — finds them all).
    names = []
    try:
        names = [_proxy_name(n["node_id"]) for n in rt.nodes()]
    except Exception:
        pass
    for name in names:
        try:
            proxy = rt.get_actor(name, namespace=_NAMESPACE)
            rt.get(proxy.stop.remote(), timeout=10)
            rt.kill(proxy)
        except Exception:
            continue
    try:
        rt.kill(controller)
    except Exception:
        pass
