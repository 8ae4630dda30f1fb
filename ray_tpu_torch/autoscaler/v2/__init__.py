# Copied from ray_tpu/autoscaler/v2/__init__.py (JAX-free): module names read ray_tpu_torch.
"""Autoscaler v2: instance-manager redesign.

Reference: python/ray/autoscaler/v2/ — v1 counts provider nodes and
reacts; v2 tracks every cloud instance through an explicit lifecycle
state machine (instance_manager/common.py InstanceUtil transition
table), stores versioned instance records (instance_storage.py), and
drives everything from one declarative `Reconciler.reconcile()` pass
(instance_manager/reconciler.py) that diffs desired state against the
cloud provider's and the cluster's reported reality.
"""

from .autoscaler import AutoscalerV2, AutoscalingClusterV2, MonitorV2
from .instance import Instance, InstanceStatus
from .instance_manager import InstanceManager
from .reconciler import Reconciler

__all__ = [
    "AutoscalerV2",
    "AutoscalingClusterV2",
    "MonitorV2",
    "Instance",
    "InstanceStatus",
    "InstanceManager",
    "Reconciler",
]
