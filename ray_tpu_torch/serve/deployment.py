# Copied from ray_tpu/serve/deployment.py (JAX-free): module names read ray_tpu_torch.
"""Deployment definitions.

Reference: python/ray/serve/deployment.py — @serve.deployment wraps a
class into a Deployment; .bind(*args) produces an Application whose
arguments may themselves be bound deployments (model composition,
reference: serve/handle.py DeploymentHandle passed to the replica at
init).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    """(reference: serve/config.py AutoscalingConfig — scale on ongoing
    requests per replica)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 3.0


class Deployment:
    def __init__(
        self,
        cls: type,
        name: str,
        *,
        num_replicas: int = 1,
        ray_actor_options: Optional[dict] = None,
        autoscaling_config: Optional[AutoscalingConfig] = None,
        max_ongoing_requests: int = 8,
        version: str = "1",
    ):
        self._cls = cls
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = ray_actor_options or {}
        self.autoscaling_config = autoscaling_config
        self.max_ongoing_requests = max_ongoing_requests
        self.version = version

    def options(self, **overrides) -> "Deployment":
        merged = {
            "num_replicas": self.num_replicas,
            "ray_actor_options": self.ray_actor_options,
            "autoscaling_config": self.autoscaling_config,
            "max_ongoing_requests": self.max_ongoing_requests,
            "version": self.version,
        }
        name = overrides.pop("name", self.name)
        merged.update(overrides)
        return Deployment(self._cls, name, **merged)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    @property
    def underlying(self) -> type:
        return self._cls


class Application:
    """A bound deployment graph rooted at the ingress (reference:
    serve/built_application.py)."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def flatten(self) -> List["Application"]:
        """All bound deployments, dependencies first."""
        seen: Dict[int, Application] = {}
        order: List[Application] = []

        def visit(app: "Application"):
            if id(app) in seen:
                return
            seen[id(app)] = app
            for arg in list(app.args) + list(app.kwargs.values()):
                if isinstance(arg, Application):
                    visit(arg)
            order.append(app)

        visit(self)
        return order


def deployment(
    cls: Optional[type] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    ray_actor_options: Optional[dict] = None,
    autoscaling_config: Optional[AutoscalingConfig | dict] = None,
    max_ongoing_requests: int = 8,
    version: str = "1",
):
    """@serve.deployment decorator (reference: serve/api.py:deployment)."""

    def wrap(target: type) -> Deployment:
        if isinstance(autoscaling_config, dict):
            autoscale = AutoscalingConfig(**autoscaling_config)
        else:
            autoscale = autoscaling_config
        return Deployment(
            target,
            name or target.__name__,
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options,
            autoscaling_config=autoscale,
            max_ongoing_requests=max_ongoing_requests,
            version=version,
        )

    if cls is not None:
        return wrap(cls)
    return wrap


def batch(
    _fn=None, *, max_batch_size: int = 8, batch_wait_timeout_s: float = 0.01
):
    """@serve.batch — marks a method as batched: the router groups
    concurrent calls and the method receives a list of inputs,
    returning a list of outputs (reference: serve/batching.py)."""

    def wrap(fn):
        fn.__rt_serve_batch__ = {
            "max_batch_size": max_batch_size,
            "batch_wait_timeout_s": batch_wait_timeout_s,
        }
        return fn

    if _fn is not None:
        return wrap(_fn)
    return wrap
