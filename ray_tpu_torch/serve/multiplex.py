# Copied from ray_tpu/serve/multiplex.py (JAX-free): module names read ray_tpu_torch.
"""Model multiplexing: many models per deployment, LRU per replica.

Reference: python/ray/serve/multiplex.py (_ModelMultiplexWrapper) +
api.py:559 (@serve.multiplexed) + the router's model-aware replica
ranking — one deployment serves N models (multi-LoRA on TPU being the
canonical case), each replica holds at most `max_num_models_per_
replica` loaded, and the router prefers replicas that already hold a
request's model so loads amortize.

Flow:
    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str): return load(model_id)
        def __call__(self, request):
            model = self.get_model(serve.get_multiplexed_model_id())
            return model(request)

    handle.options(multiplexed_model_id="m1").remote(...)

The model id rides request metadata; the replica sets it into a
context variable around the call (get_multiplexed_model_id reads it),
and reports its loaded set to the controller, which pushes it to
routers over the existing long-poll channel.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """Model id of the request being handled (reference:
    serve.get_multiplexed_model_id)."""
    return _model_id_ctx.get()


def _set_request_model_id(model_id: str):
    return _model_id_ctx.set(model_id)


class _ModelMultiplexWrapper:
    """Per-replica LRU of model_id -> loaded model (reference:
    multiplex.py _ModelMultiplexWrapper). Thread-safe: replicas run
    concurrent requests; a model loading twice concurrently is
    wasteful, so loads of the SAME id serialize on a per-id event."""

    def __init__(
        self,
        load_fn: Callable[[Any, str], Any],
        owner: Any,
        max_models: int,
        on_change: Optional[Callable[[List[str]], None]] = None,
    ):
        self._load_fn = load_fn
        self._owner = owner
        self._max = max(1, max_models)
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._loading: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self._on_change = on_change

    def model_ids(self) -> List[str]:
        with self._lock:
            return list(self._models)

    def models(self) -> Dict[str, Any]:
        """Snapshot of the loaded {model_id: model} set (stable public
        accessor — e.g. LLMServer.engine_stats reads per-family engine
        health through it)."""
        with self._lock:
            return dict(self._models)

    def load(self, model_id: str) -> Any:
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                pending = self._loading.get(model_id)
                if pending is None:
                    self._loading[model_id] = threading.Event()
                    break
            pending.wait(timeout=600)
        try:
            # The swap cost a cold-model request pays before its
            # handler runs — per-deployment histogram + flight-recorder
            # event, attributed to the request that triggered the load
            # (observability.current_request_context).
            from .observability import observe_model_load

            t0 = time.perf_counter()
            model = self._load_fn(self._owner, model_id)
            observe_model_load(
                model_id, (time.perf_counter() - t0) * 1e3
            )
            evicted = None
            with self._lock:
                if len(self._models) >= self._max:
                    _evicted_id, evicted = self._models.popitem(
                        last=False
                    )
                self._models[model_id] = model
                ids = list(self._models)
            # Teardown outside the lock; models with a close/del hook
            # release accelerator memory promptly (reference: the
            # wrapper awaits __del__ on eviction).
            if evicted is not None:
                for hook in ("__serve_unload__", "close"):
                    fn = getattr(evicted, hook, None)
                    if callable(fn):
                        try:
                            fn()
                        except Exception:
                            pass
                        break
            if self._on_change is not None:
                try:
                    self._on_change(ids)
                except Exception:
                    pass
            return model
        finally:
            with self._lock:
                event = self._loading.pop(model_id, None)
            if event is not None:
                event.set()


class _MultiplexedMethod:
    """Descriptor produced by @serve.multiplexed: binds one wrapper
    per instance (per replica process)."""

    def __init__(self, func: Callable, max_models: int):
        self._func = func
        self.max_num_models_per_replica = max_models
        self._attr = f"__serve_multiplex_{func.__name__}"

    def __set_name__(self, owner, name):
        self._name = name

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        wrapper = getattr(instance, self._attr, None)
        if wrapper is None:
            on_change = getattr(
                instance, "__serve_multiplex_report__", None
            )
            wrapper = _ModelMultiplexWrapper(
                self._func, instance, self.max_num_models_per_replica,
                on_change=on_change,
            )
            setattr(instance, self._attr, wrapper)
        return wrapper.load


def multiplexed(
    func: Optional[Callable] = None,
    *,
    max_num_models_per_replica: int = 3,
):
    """Mark a model-loader method for multiplexing (reference:
    serve/api.py:559 @serve.multiplexed)."""

    def wrap(f: Callable) -> _MultiplexedMethod:
        return _MultiplexedMethod(f, max_num_models_per_replica)

    if func is not None:
        return wrap(func)
    return wrap
