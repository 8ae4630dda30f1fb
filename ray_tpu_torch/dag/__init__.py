# Copied from ray_tpu/dag/__init__.py (JAX-free): module names read ray_tpu_torch.
"""Lazy + compiled DAG API (reference: python/ray/dag/)."""

from .channels import ShmChannel
from .compiled import CompiledDAG, CompiledDAGRef
from .edges import Edge
from .dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    experimental_compile,
)

__all__ = [
    "DAGNode",
    "InputNode",
    "InputAttributeNode",
    "MultiOutputNode",
    "FunctionNode",
    "ClassMethodNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "ShmChannel",
    "Edge",
    "experimental_compile",
]
