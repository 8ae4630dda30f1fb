# Copied from ray_tpu/autoscaler/node_provider.py (JAX-free): module names read ray_tpu_torch.
"""NodeProvider plugin interface.

Reference: python/ray/autoscaler/node_provider.py — the cloud-agnostic
surface the autoscaler drives (create/terminate/list); concrete
providers plug in per platform (GCE TPU pods being the one that
matters here). FakeMultiNodeProvider boots real in-process worker
daemons, the keystone test double (reference:
autoscaler/_private/fake_multi_node/node_provider.py).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional


class NodeProvider:
    """One node = one opaque node_id string."""

    def __init__(self, head_address: str):
        self.head_address = head_address

    def create_node(
        self, node_type: str, resources: Dict[str, float], labels: Dict
    ) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def node_type(self, node_id: str) -> Optional[str]:
        raise NotImplementedError

    def cluster_node_id(self, node_id: str) -> Optional[str]:
        """Provider node id -> cluster node id (hex) once registered."""
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class FakeMultiNodeProvider(NodeProvider):
    """Launches worker NodeDaemons inside this process."""

    def __init__(self, head_address: str, session_root: str):
        super().__init__(head_address)
        self.session_root = session_root
        self._lock = threading.Lock()
        self._nodes: Dict[str, dict] = {}
        self._seq = 0

    def create_node(self, node_type, resources, labels) -> str:
        from .._private.config import Config
        from .._private.daemon import NodeDaemon

        with self._lock:
            self._seq += 1
            provider_id = f"fake-{node_type}-{self._seq}"
        daemon = NodeDaemon(
            os.path.join(self.session_root, provider_id),
            dict(resources),
            Config.from_env(None),
            is_head=False,
            head_address=self.head_address,
            labels=dict(labels or {}),
        )
        daemon.start()
        with self._lock:
            self._nodes[provider_id] = {
                "daemon": daemon,
                "type": node_type,
            }
        return provider_id

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(node_id, None)
        if node is not None:
            node["daemon"].shutdown()

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    def node_type(self, node_id: str) -> Optional[str]:
        with self._lock:
            node = self._nodes.get(node_id)
            return node["type"] if node else None

    def cluster_node_id(self, node_id: str) -> Optional[str]:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return None
            return node["daemon"].node_id.hex()

    def shutdown(self) -> None:
        for node_id in self.non_terminated_nodes():
            self.terminate_node(node_id)
