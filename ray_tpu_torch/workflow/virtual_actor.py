# Copied from ray_tpu/workflow/virtual_actor.py (JAX-free): module names read ray_tpu_torch.
"""Durable virtual actors.

Reference: Ray workflow's virtual actors — an actor whose state lives
in workflow storage rather than process memory: `get_or_create`
materializes it anywhere, every method call is a durable step (state
persisted with the return value before the call "happened"), and a
crashed host loses nothing past the last completed call.

TPU-native framing: state is pickled to the workflow store under the
actor id; each call appends a numbered step record
(`call-<n>-<method>`) holding (state_after, return_value) atomically
in one file, and the state snapshot advances only together with its
call record — a crash between the two re-runs at most the one
uncommitted call. Methods marked `@readonly` skip the commit
entirely.

The method body executes as a task on the cluster (so heavy state
transitions can run on any node); the actor object itself is just a
client handle over storage.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import pickle
import re
from typing import Any, Dict, Optional

from . import _WorkflowStorage, _root


def readonly(method):
    """Mark a virtual-actor method as not mutating state: the call
    runs against the latest snapshot and commits nothing."""
    method.__rt_workflow_readonly__ = True
    return method


class _VirtualActorHandle:
    def __init__(self, cls, actor_id: str, storage_root: str):
        self._cls = cls
        self._actor_id = actor_id
        self._store = _WorkflowStorage(
            storage_root, f"va-{actor_id}"
        )

    # -- durable state ------------------------------------------------
    @contextlib.contextmanager
    def _exclusive(self):
        """Per-actor advisory lock (POSIX flock on a lockfile in the
        actor's storage dir). Serializes the read-state -> run ->
        commit window across handles and processes so two concurrent
        calls can't compute the same call number and overwrite each
        other's committed record. Scope: hosts sharing the storage
        path via a lock-honoring filesystem (local disk, most NFSv4)."""
        lock_path = os.path.join(self._store.dir, ".lock")
        with open(lock_path, "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)

    def _state_path(self) -> str:
        return os.path.join(self._store.dir, "state.pkl")

    def _load_state(self):
        """Current state = the latest committed call's state-after;
        the init snapshot only seeds an actor with no calls yet. One
        atomic file per call means there is no window where a call's
        result is visible without its state change."""
        latest_n, latest_id = -1, None
        for fname in os.listdir(self._store.dir):
            m = re.match(r"step-(call-(\d+)-\w+)\.pkl$", fname)
            if m and int(m.group(2)) > latest_n:
                latest_n, latest_id = int(m.group(2)), m.group(1)
        if latest_id is not None:
            return self._store.load_step(latest_id)["state"]
        with open(self._state_path(), "rb") as f:
            return pickle.load(f)

    def _save_state(self, state) -> None:
        tmp = self._state_path() + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, self._state_path())

    def _next_call_number(self) -> int:
        numbers = [
            int(m.group(1))
            for name in os.listdir(self._store.dir)
            if (m := re.match(r"step-call-(\d+)-", name))
        ]
        return max(numbers, default=-1) + 1

    # -- calls --------------------------------------------------------
    def _call(self, method_name: str, args, kwargs) -> Any:
        import ray_tpu_torch as rt

        method = getattr(self._cls, method_name)
        is_readonly = getattr(
            method, "__rt_workflow_readonly__", False
        )
        cls = self._cls

        def _run_method(state_dict, m_args, m_kwargs):
            obj = cls.__new__(cls)
            obj.__dict__.update(state_dict)
            result = getattr(obj, method_name)(*m_args, **m_kwargs)
            return obj.__dict__, result

        runner = rt.remote(_run_method)

        if is_readonly:
            state = self._load_state()
            _, result = rt.get(
                runner.remote(state, list(args), dict(kwargs)),
                timeout=600,
            )
            return result

        # Mutating calls hold the actor lock across the whole
        # read -> run -> commit window: concurrent handles serialize,
        # each sees the previous call's state, and call numbers can't
        # collide/overwrite.
        with self._exclusive():
            state = self._load_state()
            new_state, result = rt.get(
                runner.remote(state, list(args), dict(kwargs)),
                timeout=600,
            )
            call_id = (
                f"call-{self._next_call_number():06d}-{method_name}"
            )
            # One atomic commit: state_after + return value.
            self._store.save_step(
                call_id, {"state": new_state, "result": result}
            )
        return result

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if not callable(getattr(self._cls, name, None)):
            raise AttributeError(
                f"{self._cls.__name__} has no method {name!r}"
            )

        class _Method:
            def __init__(self, handle):
                self._handle = handle

            def run(self, *args, **kwargs):
                return self._handle._call(name, args, kwargs)

        return _Method(self)

    # -- introspection ------------------------------------------------
    def call_log(self) -> list:
        """Committed calls, in order: [{call, method, result}]."""
        entries = []
        for fname in sorted(os.listdir(self._store.dir)):
            m = re.match(r"step-(call-(\d+)-(\w+))\.pkl$", fname)
            if not m:
                continue
            record = self._store.load_step(m.group(1))
            entries.append(
                {
                    "call": int(m.group(2)),
                    "method": m.group(3),
                    "result": record["result"],
                }
            )
        return entries


class VirtualActorClass:
    def __init__(self, cls):
        self._cls = cls

    def get_or_create(
        self,
        actor_id: str,
        *init_args,
        storage: Optional[str] = None,
        **init_kwargs,
    ) -> _VirtualActorHandle:
        root = _root(storage)
        handle = _VirtualActorHandle(self._cls, actor_id, root)
        with handle._exclusive():
            if not os.path.exists(handle._state_path()):
                obj = self._cls(*init_args, **init_kwargs)
                handle._save_state(dict(obj.__dict__))
                handle._store.save_meta(
                    {
                        "workflow_id": f"va-{actor_id}",
                        "status": "VIRTUAL_ACTOR",
                        "class": self._cls.__name__,
                    }
                )
        return handle


#: Registry so get_actor can resolve classes by name within a process.
_CLASSES: Dict[str, VirtualActorClass] = {}


def virtual_actor(cls) -> VirtualActorClass:
    """Class decorator: `@workflow.virtual_actor`."""
    wrapped = VirtualActorClass(cls)
    _CLASSES[cls.__name__] = wrapped
    return wrapped


def get_actor(
    actor_id: str, *, storage: Optional[str] = None
) -> _VirtualActorHandle:
    """Reattach to an existing virtual actor by id (reference:
    workflow.get_actor). The class must be imported (decorated) in
    this process."""
    root = _root(storage)
    store = _WorkflowStorage(root, f"va-{actor_id}")
    meta = store.load_meta()
    if meta is None:
        raise ValueError(f"no virtual actor {actor_id!r}")
    wrapped = _CLASSES.get(meta.get("class", ""))
    if wrapped is None:
        raise ValueError(
            f"virtual actor class {meta.get('class')!r} not "
            f"registered in this process"
        )
    return _VirtualActorHandle(wrapped._cls, actor_id, root)
