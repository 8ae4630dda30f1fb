# Copied from ray_tpu/autoscaler/cluster.py (JAX-free), without the TPU slice cluster:
# module names read ray_tpu_torch.
"""Autoscaling test cluster.

Reference: python/ray/cluster_utils.py:26 AutoscalingCluster — a head
plus a FakeMultiNodeProvider-backed autoscaler, so elasticity tests
run hermetically on one machine.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..cluster_utils import Cluster
from .autoscaler import Monitor, NodeTypeConfig, StandardAutoscaler
from .node_provider import FakeMultiNodeProvider


class AutoscalingCluster:
    def __init__(
        self,
        head_resources: Optional[Dict[str, float]] = None,
        worker_node_types: Optional[Dict[str, dict]] = None,
        idle_timeout_s: float = 3.0,
        update_interval_s: float = 0.3,
    ):
        self.cluster = Cluster(
            initialize_head=True,
            head_resources=head_resources or {"CPU": 1.0},
        )
        types = {
            name: NodeTypeConfig(
                resources=spec["resources"],
                min_workers=spec.get("min_workers", 0),
                max_workers=spec.get("max_workers", 4),
                labels=spec.get("labels", {}),
            )
            for name, spec in (worker_node_types or {}).items()
        }
        self.provider = FakeMultiNodeProvider(
            self.cluster.address, self.cluster.session_dir
        )
        self.autoscaler = StandardAutoscaler(
            self.provider, types, idle_timeout_s=idle_timeout_s
        )
        self.monitor = Monitor(self.autoscaler, update_interval_s)

    @property
    def address(self) -> str:
        return self.cluster.address

    def start(self) -> None:
        self.monitor.start()

    def num_workers(self) -> int:
        return len(self.provider.non_terminated_nodes())

    def shutdown(self) -> None:
        self.monitor.stop()
        self.provider.shutdown()
        self.cluster.shutdown()

