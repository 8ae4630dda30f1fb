# Copied from ray_tpu/workflow/__init__.py (JAX-free), with step values' tensors pickled to reload where no card is:
# module names read ray_tpu_torch.
"""Durable workflows (reference: python/ray/workflow).

workflow.run(dag) executes a task DAG with every step's result
persisted to storage before the workflow advances (reference:
workflow/api.py:123 run, workflow_executor.py:32, workflow_storage.py).
A crashed or failed workflow resumes from storage: finished steps are
loaded, only missing/failed steps re-execute. Step identity is the
node's position in the deterministic topological order plus its
function name — stable across resubmissions of the same DAG shape.

Dynamic continuations (reference: workflow/api.py continuation — a
step returns `workflow.continuation(sub_dag)` and the workflow keeps
executing the returned DAG durably, sub-steps namespaced under the
parent step) and durable virtual actors (reference:
workflow/virtual_actor semantics: per-actor persistent state, each
method call a durable step) are implemented on the same storage: see
`continuation` below and `workflow.virtual_actor`.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

from ..dag.dag_node import (
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
)

_DEFAULT_ROOT = os.path.join(
    tempfile.gettempdir(), "rt_workflows"
)

STATUS_RUNNING = "RUNNING"
STATUS_SUCCESSFUL = "SUCCESSFUL"
STATUS_FAILED = "FAILED"


def _root(storage: Optional[str]) -> str:
    root = storage or os.environ.get("RT_WORKFLOW_STORAGE", _DEFAULT_ROOT)
    os.makedirs(root, exist_ok=True)
    return root


class _StepPickler(pickle.Pickler):
    """Pickles a step's value with each tensor that is off the CPU
    stored on the CPU beside its device: a resume in a process without
    a card reloads the committed value there, on the CPU, as a JAX
    array reloads anywhere; one with a card, on its device."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and isinstance(obj, torch.Tensor)
                and obj.device.type != "cpu"):
            host = obj.detach().cpu().requires_grad_(obj.requires_grad)
            return _on_device, (host, str(obj.device))
        return NotImplemented


def _on_device(tensor, device: str):
    import torch

    return tensor.to(device) if torch.cuda.is_available() else tensor


class _WorkflowStorage:
    """(reference: workflow/workflow_storage.py — step results +
    workflow metadata under a per-workflow prefix)."""

    def __init__(self, root: str, workflow_id: str):
        self.dir = os.path.join(root, workflow_id)
        os.makedirs(self.dir, exist_ok=True)
        self._meta_path = os.path.join(self.dir, "meta.json")

    def save_meta(self, meta: dict) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path)

    def load_meta(self) -> Optional[dict]:
        try:
            with open(self._meta_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    @staticmethod
    def _fs_name(step_id: str) -> str:
        """Deep continuation prefixes grow linearly with depth; past
        the filename limit, collapse deterministically to a digest +
        readable tail (same step_id -> same file across resumes)."""
        if len(step_id) <= 150:
            return step_id
        import hashlib

        digest = hashlib.sha1(step_id.encode()).hexdigest()[:16]
        return f"{digest}-{step_id[-60:]}"

    def step_path(self, step_id: str) -> str:
        return os.path.join(
            self.dir, f"step-{self._fs_name(step_id)}.pkl"
        )

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self.step_path(step_id))

    def save_step(self, step_id: str, value: Any) -> None:
        tmp = self.step_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            _StepPickler(f).dump(value)
        os.replace(tmp, self.step_path(step_id))

    def load_step(self, step_id: str) -> Any:
        with open(self.step_path(step_id), "rb") as f:
            return pickle.load(f)

    def cont_path(self, step_id: str) -> str:
        return os.path.join(
            self.dir, f"cont-{self._fs_name(step_id)}.pkl"
        )

    def has_continuation(self, step_id: str) -> bool:
        return os.path.exists(self.cont_path(step_id))

    def save_continuation(
        self, step_id: str, dag: DAGNode, input_value: Any
    ) -> None:
        import cloudpickle

        tmp = self.cont_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump({"dag": dag, "input": input_value}, f)
        os.replace(tmp, self.cont_path(step_id))

    def load_continuation(self, step_id: str):
        with open(self.cont_path(step_id), "rb") as f:
            state = pickle.load(f)
        return state["dag"], state["input"]

    def save_dag(self, dag: DAGNode, input_value: Any) -> None:
        import cloudpickle

        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            cloudpickle.dump({"dag": dag, "input": input_value}, f)

    def load_dag(self):
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            state = pickle.load(f)
        return state["dag"], state["input"]


class Continuation:
    """A step's request to keep the workflow going with a new DAG
    (reference: ray.workflow.continuation — the dynamic-workflow
    primitive: recursion/loops whose every iteration is durable)."""

    def __init__(self, dag: DAGNode, input_value: Any = None):
        if not isinstance(dag, DAGNode):
            raise TypeError(
                f"continuation() takes a DAG node, got "
                f"{type(dag).__name__}"
            )
        self.dag = dag
        self.input_value = input_value


def continuation(dag: DAGNode, input_value: Any = None) -> Continuation:
    """Return this from a workflow step to splice `dag` in as the
    step's durable continuation; the step's final value becomes the
    continuation DAG's final value."""
    return Continuation(dag, input_value)


def _step_ids(dag: DAGNode, prefix: str = "") -> Dict[int, str]:
    """Deterministic ids keyed by node identity."""
    ids: Dict[int, str] = {}
    for index, node in enumerate(dag.topological_order()):
        if isinstance(node, FunctionNode):
            name = node._rf.underlying.__name__
        else:
            name = type(node).__name__.lower()
        ids[id(node)] = f"{prefix}{index:03d}-{name}"
    return ids


#: Continuation depth guard: each level is durable AND the walk below
#: is an iterative trampoline (no Python recursion — a recursive
#: implementation would hit the interpreter's ~1000-frame limit around
#: depth ~300 and, worse, crash identically on every resume). The
#: guard only stops runaway non-terminating loops.
_MAX_CONTINUATION_DEPTH = 10_000


class _Frame:
    """One DAG being walked; continuations push child frames."""

    __slots__ = ("dag", "order", "ids", "cache", "input_value", "idx")

    def __init__(self, dag: DAGNode, input_value: Any, prefix: str):
        self.dag = dag
        self.order = list(dag.topological_order())
        self.ids = _step_ids(dag, prefix)
        self.cache: Dict[int, Any] = {}
        self.input_value = input_value
        self.idx = 0


def _execute(
    dag: DAGNode,
    input_value: Any,
    storage: _WorkflowStorage,
) -> Any:
    """Walk the DAG; each step's result is durable before dependents
    run (reference: workflow_executor commit-before-advance). A step
    returning a Continuation pushes a child frame: the sub-DAG is
    persisted first (so resume never re-runs the generating step) and
    executed with sub-steps namespaced under the parent id."""
    import ray_tpu_torch as rt

    stack = [_Frame(dag, input_value, "")]

    def push(sub_dag, sub_input, parent_step_id):
        if len(stack) >= _MAX_CONTINUATION_DEPTH:
            raise RecursionError(
                f"workflow continuation depth exceeded "
                f"{_MAX_CONTINUATION_DEPTH}"
            )
        stack.append(
            _Frame(sub_dag, sub_input, f"{parent_step_id}.")
        )

    while True:
        frame = stack[-1]
        if frame.idx >= len(frame.order):
            # Frame done: its dag's value either IS the workflow
            # output or resolves the parent's pending continuation.
            result = frame.cache[id(frame.dag)]
            stack.pop()
            if not stack:
                return result
            parent = stack[-1]
            node = parent.order[parent.idx]
            step_id = parent.ids[id(node)]
            storage.save_step(step_id, result)
            parent.cache[id(node)] = result
            parent.idx += 1
            continue
        node = frame.order[frame.idx]
        step_id = frame.ids[id(node)]
        if isinstance(node, InputNode):
            frame.cache[id(node)] = frame.input_value
            frame.idx += 1
            continue
        if isinstance(node, InputAttributeNode):
            # inp["key"] projection — the InputNode child resolved in
            # an earlier topological slot.
            frame.cache[id(node)] = frame.cache[id(node.input_node)][
                node.key
            ]
            frame.idx += 1
            continue
        if storage.has_step(step_id):
            frame.cache[id(node)] = storage.load_step(step_id)
            frame.idx += 1
            continue
        if not isinstance(node, FunctionNode):
            raise TypeError(
                f"workflows support task nodes only, got "
                f"{type(node).__name__}"
            )
        if storage.has_continuation(step_id):
            # Crashed mid-continuation: resume the sub-DAG without
            # re-running the (already committed) generating step.
            sub_dag, sub_input = storage.load_continuation(step_id)
            push(sub_dag, sub_input, step_id)
            continue
        args = [
            frame.cache[id(a)] if isinstance(a, DAGNode) else a
            for a in node._bound_args
        ]
        kwargs = {
            k: frame.cache[id(v)] if isinstance(v, DAGNode) else v
            for k, v in node._bound_kwargs.items()
        }
        ref = node._rf.remote(*args, **kwargs)
        value = rt.get(ref, timeout=600)
        if isinstance(value, Continuation):
            # Durable before running: resume re-enters the sub-DAG.
            storage.save_continuation(
                step_id, value.dag, value.input_value
            )
            push(value.dag, value.input_value, step_id)
            continue
        storage.save_step(step_id, value)
        frame.cache[id(node)] = value
        frame.idx += 1


def run(
    dag: DAGNode,
    *,
    workflow_id: Optional[str] = None,
    input_value: Any = None,
    storage: Optional[str] = None,
) -> Any:
    """Execute (or continue) a workflow to completion and return the
    final result (reference: workflow.run, api.py:123)."""
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000):x}"  # rt: noqa[RT003] — id minted once at submission, never replayed
    store = _WorkflowStorage(_root(storage), workflow_id)
    store.save_dag(dag, input_value)
    store.save_meta(
        {"workflow_id": workflow_id, "status": STATUS_RUNNING}
    )
    try:
        result = _execute(dag, input_value, store)
    except BaseException as e:
        store.save_meta(
            {
                "workflow_id": workflow_id,
                "status": STATUS_FAILED,
                "error": repr(e),
            }
        )
        raise
    store.save_step("__output__", result)
    store.save_meta(
        {"workflow_id": workflow_id, "status": STATUS_SUCCESSFUL}
    )
    return result


def resume(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    """Re-drive an interrupted/failed workflow; completed steps load
    from storage (reference: workflow.resume)."""
    store = _WorkflowStorage(_root(storage), workflow_id)
    meta = store.load_meta()
    if meta is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    if meta["status"] == STATUS_SUCCESSFUL:
        return store.load_step("__output__")
    dag, input_value = store.load_dag()
    return run(
        dag,
        workflow_id=workflow_id,
        input_value=input_value,
        storage=storage,
    )


def get_status(
    workflow_id: str, *, storage: Optional[str] = None
) -> Optional[str]:
    meta = _WorkflowStorage(_root(storage), workflow_id).load_meta()
    return meta["status"] if meta else None


def get_output(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    store = _WorkflowStorage(_root(storage), workflow_id)
    meta = store.load_meta()
    if meta is None or meta["status"] != STATUS_SUCCESSFUL:
        raise ValueError(
            f"workflow {workflow_id!r} has no output "
            f"(status={meta and meta['status']})"
        )
    return store.load_step("__output__")


def list_all(*, storage: Optional[str] = None) -> List[dict]:
    root = _root(storage)
    out = []
    for entry in sorted(os.listdir(root)):
        meta = _WorkflowStorage(root, entry).load_meta()
        if meta:
            out.append(meta)
    return out


from .virtual_actor import (  # noqa: E402
    VirtualActorClass,
    get_actor,
    readonly as virtual_actor_readonly,
    virtual_actor,
)

__all__ = [
    "run",
    "resume",
    "continuation",
    "Continuation",
    "virtual_actor",
    "virtual_actor_readonly",
    "get_actor",
    "VirtualActorClass",
    "get_status",
    "get_output",
    "list_all",
    "STATUS_RUNNING",
    "STATUS_SUCCESSFUL",
    "STATUS_FAILED",
]
