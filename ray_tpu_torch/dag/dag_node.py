# Copied from ray_tpu/dag/dag_node.py (JAX-free): module names read ray_tpu_torch.
"""Lazy DAG node types.

Reference: python/ray/dag/dag_node.py + class_node.py /
function_node.py — `.bind()` builds a lazy graph of task / actor-method
invocations; `InputNode` marks the runtime argument;
`MultiOutputNode` fans multiple leaves out to the caller. `execute()`
walks the graph submitting ordinary remote calls; `experimental_compile`
lowers it to persistent per-actor loops over channels (compiled.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """One vertex: an operation plus bound (possibly nested) args."""

    def __init__(self, bound_args: Tuple[Any, ...], bound_kwargs: dict):
        self._bound_args = bound_args
        self._bound_kwargs = bound_kwargs

    # -- traversal -----------------------------------------------------
    def _children(self) -> List["DAGNode"]:
        out = []
        for arg in list(self._bound_args) + list(
            self._bound_kwargs.values()
        ):
            if isinstance(arg, DAGNode):
                out.append(arg)
        return out

    def topological_order(self) -> List["DAGNode"]:
        """Children-before-parents order over the reachable graph."""
        seen: Dict[int, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for child in node._children():
                visit(child)
            order.append(node)

        visit(self)
        return order

    # -- interpreted execution ----------------------------------------
    def execute(self, *input_values):
        """Walk the DAG submitting ordinary remote calls; returns the
        root's ObjectRef (or a list for MultiOutputNode)."""
        cache: Dict[int, Any] = {}
        order = self.topological_order()
        for node in order:
            cache[id(node)] = node._apply(
                [
                    cache[id(a)] if isinstance(a, DAGNode) else a
                    for a in node._bound_args
                ],
                {
                    k: cache[id(v)] if isinstance(v, DAGNode) else v
                    for k, v in node._bound_kwargs.items()
                },
                input_values,
            )
        return cache[id(self)]

    def _apply(self, args, kwargs, input_values):
        raise NotImplementedError

    def experimental_compile(
        self, buffer_size_bytes: int = 4 * 2**20
    ):
        """Lower this actor DAG to persistent per-actor loops over
        shared-memory channels (reference:
        dag_node.experimental_compile -> CompiledDAG)."""
        return experimental_compile(self, buffer_size_bytes)


class InputNode(DAGNode):
    """Placeholder for the value passed to `execute()` /
    `compiled.execute()` (reference: python/ray/dag/input_node.py)."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _apply(self, args, kwargs, input_values):
        if len(input_values) != 1:
            raise ValueError(
                f"DAG has one InputNode; execute() takes exactly one "
                f"argument (got {len(input_values)})"
            )
        return input_values[0]

    def __getitem__(self, key) -> "InputAttributeNode":
        """`inp[0]` / `inp["x"]` — bind a projection of the runtime
        input (reference: python/ray/dag/input_node.py
        InputAttributeNode), so one execute() value fans different
        fields out to different nodes."""
        return InputAttributeNode(self, key)

    def __iter__(self):
        # __getitem__ would otherwise make this "iterable" via the
        # legacy protocol — an infinite stream of projection nodes
        # (`for x in inp:` / `a, b = inp` would hang or mislead).
        raise TypeError(
            "InputNode is not iterable; bind explicit projections "
            "(inp[0], inp[1], ...) instead"
        )


class InputAttributeNode(DAGNode):
    """A key/index projection of the InputNode's runtime value."""

    def __init__(self, input_node: InputNode, key):
        super().__init__((input_node,), {})
        self.key = key

    @property
    def input_node(self) -> InputNode:
        return self._bound_args[0]

    def _apply(self, args, kwargs, input_values):
        # args[0] is the InputNode's applied value (the raw input).
        return args[0][self.key]


class FunctionNode(DAGNode):
    """`remote_fn.bind(...)` — a task invocation."""

    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self._rf = remote_function

    def _apply(self, args, kwargs, input_values):
        return self._rf.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    """`actor.method.bind(...)` — an actor-method invocation."""

    def __init__(self, actor_handle, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._handle = actor_handle
        self._method = method_name

    @property
    def actor_handle(self):
        return self._handle

    @property
    def method_name(self) -> str:
        return self._method

    def _apply(self, args, kwargs, input_values):
        method = getattr(self._handle, self._method)
        return method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Fans N leaves out to the caller (reference:
    python/ray/dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _apply(self, args, kwargs, input_values):
        return list(args)


def experimental_compile(dag: DAGNode, buffer_size_bytes: int = 4 * 2**20):
    from .compiled import CompiledDAG

    return CompiledDAG(dag, buffer_size_bytes=buffer_size_bytes)
