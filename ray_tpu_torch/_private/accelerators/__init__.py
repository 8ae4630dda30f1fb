# Copied from ray_tpu/_private/accelerators/__init__.py (JAX-free), with
# the NVIDIA GPU manager as its only family.
"""Pluggable accelerator managers.

Reference: python/ray/_private/accelerators/ — one AcceleratorManager
per accelerator family, consulted at node start for resource detection
and at worker spawn for visibility scoping. The port's one family is
the NVIDIA GPU (the JAX package's TPU manager is not copied).
"""

from __future__ import annotations

from typing import Dict, Tuple

from .base import AcceleratorManager
from .nvidia_gpu import NvidiaGPUAcceleratorManager

_MANAGERS = {
    "GPU": NvidiaGPUAcceleratorManager,
}


def get_accelerator_manager(resource_name: str) -> AcceleratorManager:
    try:
        return _MANAGERS[resource_name]()
    except KeyError:
        raise ValueError(
            f"no accelerator manager for resource {resource_name!r}"
        ) from None


def detect_accelerators(
    overrides: Dict[str, float] = None,
) -> Tuple[Dict[str, float], Dict[str, str]]:
    """Detect every accelerator on this host.

    Returns (resources, labels) to merge into the node's pool —
    `overrides` replaces detection per resource name; an override of 0
    hides the accelerator entirely (no count, no extra resources or
    labels).
    """
    overrides = overrides or {}
    resources: Dict[str, float] = {}
    labels: Dict[str, str] = {}
    for manager_cls in _MANAGERS.values():
        manager = manager_cls()
        name = manager.get_resource_name()
        if name in overrides:
            count = overrides[name]
        else:
            count = manager.get_current_node_num_accelerators()
        if count <= 0:
            continue
        resources[name] = float(count)
        extra_res, extra_labels = manager.get_extra_resources_and_labels(
            count
        )
        resources.update(extra_res)
        labels.update(extra_labels)
    return resources, labels
