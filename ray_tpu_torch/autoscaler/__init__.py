# Copied from ray_tpu/autoscaler/__init__.py (JAX-free), without the TPU slice cluster:
# module names read ray_tpu_torch.
"""Autoscaling (reference: python/ray/autoscaler)."""

from .autoscaler import Monitor, NodeTypeConfig, StandardAutoscaler
from .cluster import AutoscalingCluster
from .node_provider import FakeMultiNodeProvider, NodeProvider
from .sdk import request_resources

__all__ = [
    "StandardAutoscaler",
    "Monitor",
    "NodeTypeConfig",
    "NodeProvider",
    "FakeMultiNodeProvider",
    "AutoscalingCluster",
    "request_resources",
]
