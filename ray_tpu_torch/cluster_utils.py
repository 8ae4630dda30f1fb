# Copied from ray_tpu/cluster_utils.py (JAX-free): module names read ray_tpu_torch.
"""Multi-node-in-one-box test cluster.

The reference's keystone fixture boots multiple raylets against one GCS
inside a single machine (reference: python/ray/cluster_utils.py —
Cluster:135, add_node:202; fixture ray_start_cluster,
python/ray/tests/conftest.py:508). Here each `add_node` starts a full
`NodeDaemon` (worker-node role) in-process with its own Unix socket,
shared-memory store and worker-process pool, registered against the
head daemon — so scheduling policies, cross-node object transfer and
fault-tolerance paths run hermetically on one machine.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

from ._private.config import Config
from ._private.daemon import NodeDaemon


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        head_resources: Optional[Dict[str, float]] = None,
        system_config: Optional[dict] = None,
        use_tcp: bool = False,
    ):
        """`use_tcp=True` forces every daemon onto TCP loopback — the
        cross-host transport — so tests exercise the DCN wire format
        instead of Unix sockets (reference analogy: raylets always talk
        gRPC even in Cluster tests)."""
        self.session_dir = tempfile.mkdtemp(prefix="rt_cluster_")
        self.config = Config.from_env(system_config)
        self.use_tcp = use_tcp
        self.head: Optional[NodeDaemon] = None
        self.nodes: list[NodeDaemon] = []
        self._node_seq = 0
        if initialize_head:
            resources = dict(head_resources or {"CPU": 2.0})
            resources.setdefault("memory", float(2**32))
            self.head = NodeDaemon(
                os.path.join(self.session_dir, "head"),
                resources,
                self.config,
                is_head=True,
                listen_host="127.0.0.1" if use_tcp else None,
            )
            self.head.start()

    @property
    def address(self) -> str:
        assert self.head is not None
        return self.head.address

    def add_node(
        self,
        num_cpus: float = 2.0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> NodeDaemon:
        """Start a worker-node daemon registered with the head."""
        assert self.head is not None, "cluster has no head"
        self._node_seq += 1
        total = dict(resources or {})
        total.setdefault("CPU", float(num_cpus))
        total.setdefault("memory", float(2**32))
        node = NodeDaemon(
            os.path.join(self.session_dir, f"node-{self._node_seq}"),
            total,
            self.config,
            is_head=False,
            head_address=self.address,
            labels=labels,
            listen_host="127.0.0.1" if self.use_tcp else None,
        )
        node.start()
        self.nodes.append(node)
        return node

    def remove_node(self, node: NodeDaemon) -> None:
        """Tear a node down abruptly — the head observes the connection
        drop and runs its death path (reference: node death broadcast,
        test fixture Cluster.remove_node)."""
        if node in self.nodes:
            self.nodes.remove(node)
        node.shutdown()

    def wait_for_nodes(self, count: int, timeout: float = 10.0) -> None:
        """Block until the head sees `count` alive nodes (incl. head)."""
        assert self.head is not None
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.head.control.alive_nodes()) >= count:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"cluster did not reach {count} nodes within {timeout}s"
        )

    def crash_head(self) -> "NodeDaemon":
        """Take the head down abruptly (its control-plane state
        survives only via the gcs op log in the session dir). Worker
        nodes keep running; their heartbeat loops will resync once a
        head is restarted at the same address."""
        assert self.head is not None
        head, self.head = self.head, None
        self._head_resources = dict(head.resources)
        self._head_address = head.address
        head.shutdown()
        return head

    def restart_head(self) -> "NodeDaemon":
        """Start a fresh head over the SAME session dir (replays the
        gcs op log) and, for TCP clusters, the same port so surviving
        nodes and drivers can re-reach it."""
        assert self.head is None, "head still running"
        listen_port = 0
        if self.use_tcp and self._head_address.startswith("tcp://"):
            listen_port = int(self._head_address.rsplit(":", 1)[1])
        self.head = NodeDaemon(
            os.path.join(self.session_dir, "head"),
            self._head_resources,
            self.config,
            is_head=True,
            listen_host="127.0.0.1" if self.use_tcp else None,
            listen_port=listen_port,
        )
        self.head.start()
        return self.head

    def shutdown(self) -> None:
        # Phase 1: SIGKILL every daemon's worker tree up front, no
        # waits. With thousands of live workers on a small host the
        # graceful per-daemon path can take longer than the processes
        # deserve — and if anything earlier in teardown wedges, the
        # orphaned tree pins the pid table (observed: a 7k-worker
        # bench run saturating pid_max for good).
        for node in [*self.nodes, self.head]:
            if node is None:
                continue
            try:
                node.kill_worker_tree()
            except Exception:
                pass
        for node in self.nodes:
            try:
                node.shutdown()
            except Exception:
                pass
        self.nodes.clear()
        if self.head is not None:
            self.head.shutdown()
            self.head = None
