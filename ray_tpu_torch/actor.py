# Copied from ray_tpu/actor.py (JAX-free): module names read ray_tpu_torch.
"""Actor classes and handles (reference: python/ray/actor.py —
ActorClass._remote:890 registers with the control plane and submits the
creation task; ActorMethod._remote:314 submits ordered actor tasks;
handles are serializable and resolve through the actor table)."""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ._private.ids import ActorID


class ActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        from ._private.options import validate_options

        self._cls = cls
        self._options = dict(options or {})
        # Decorator and .options() clones both construct through here:
        # unknown keys raise with the valid key set instead of being
        # silently merged (the RT102 bug class, enforced at runtime).
        validate_options("actor", self._options)
        self._exported_key: Optional[str] = None
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actors cannot be instantiated directly; use "
            f"{self._cls.__name__}.remote()."
        )

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._options)
        merged.update(overrides)
        clone = ActorClass(self._cls, merged)
        clone._exported_key = self._exported_key
        return clone

    def remote(self, *args, **kwargs) -> "ActorHandle":
        from ._private.api_internal import create_actor

        return create_actor(self, args, kwargs)

    @property
    def underlying(self) -> type:
        return self._cls

    @property
    def actor_options(self) -> Dict[str, Any]:
        return self._options

    def method_names(self) -> list:
        return [
            name
            for name in dir(self._cls)
            if callable(getattr(self._cls, name)) and not name.startswith("__")
        ]


def method(**options):
    """Per-method default options, applied at class-definition time
    (reference: python/ray/actor.py ray.method — num_returns and
    concurrency_group annotations)::

        @rt.remote(concurrency_groups={"io": 2})
        class A:
            @rt.method(concurrency_group="io")
            def fetch(self): ...
    """
    allowed = {"num_returns", "concurrency_group"}
    unknown = set(options) - allowed
    if unknown:
        raise ValueError(f"unknown method options: {sorted(unknown)}")

    def decorator(fn):
        fn.__rt_method_options__ = options
        return fn

    return decorator


class ActorMethod:
    def __init__(
        self,
        handle: "ActorHandle",
        name: str,
        num_returns: int = 1,
        concurrency_group: Optional[str] = None,
    ):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(
        self,
        num_returns: Optional[int] = None,
        concurrency_group: Optional[str] = None,
        **_ignored,
    ) -> "ActorMethod":
        # None = keep this method's current value (which may carry an
        # @rt.method definition-time default) — overriding one option
        # must not silently reset the other.
        return ActorMethod(
            self._handle,
            self._name,
            self._num_returns if num_returns is None else num_returns,
            concurrency_group
            if concurrency_group is not None
            else self._concurrency_group,
        )

    def remote(self, *args, **kwargs):
        from ._private.api_internal import submit_actor_method

        return submit_actor_method(
            self._handle,
            self._name,
            args,
            kwargs,
            self._num_returns,
            concurrency_group=self._concurrency_group,
        )

    def bind(self, *args, **kwargs):
        """Lazy DAG node for this method call (reference:
        python/ray/dag/class_node.py)."""
        from .dag.dag_node import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    """Serializable reference to a live actor."""

    def __init__(self, actor_id: ActorID, meta: Dict[str, Any]):
        self._actor_id = actor_id
        self._meta = meta  # {"class_name", "methods": [...]}

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        methods = self._meta.get("methods")
        if methods is not None and name not in methods:
            raise AttributeError(
                f"Actor {self._meta.get('class_name', '?')} has no "
                f"method {name!r}"
            )
        defaults = (self._meta.get("method_defaults") or {}).get(name, {})
        return ActorMethod(
            self,
            name,
            num_returns=defaults.get("num_returns", 1),
            concurrency_group=defaults.get("concurrency_group"),
        )

    def __repr__(self):
        return (
            f"ActorHandle({self._meta.get('class_name', '?')}, "
            f"{self._actor_id.hex()})"
        )

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._meta))
