# Copied from ray_tpu/autoscaler/v2/autoscaler.py (JAX-free): module names read ray_tpu_torch.
"""AutoscalerV2: reconciler loop + provider subscribers.

Reference: python/ray/autoscaler/v2/autoscaler.py (wires InstanceManager
+ Reconciler + cloud provider) and instance_manager/subscribers/
{cloud_instance_updater.py, ray_stopper.py} — status transitions drive
side effects: REQUESTED launches on the provider, TERMINATING
terminates, RAY_STOP_REQUESTED drains. Provider calls run on a worker
thread; their failures surface as ProviderErrors consumed by the next
reconcile pass rather than exceptions in the loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

from ..autoscaler import PROVIDER_NODE_LABEL, NodeTypeConfig
from ..node_provider import FakeMultiNodeProvider, NodeProvider
from .instance import Instance, InstanceStatus as S
from .instance_manager import InstanceManager, InstanceUpdateEvent
from .reconciler import (
    CloudInstance,
    ProviderError,
    ReconcileConfig,
    Reconciler,
)


class V1ProviderAdapter:
    """Bridges the v1 NodeProvider plugin surface (synchronous
    create/terminate/list, used by the GCE TPU provider and the fake
    in-process provider) to the v2 async cloud-instance view."""

    def __init__(
        self,
        provider: NodeProvider,
        node_types: Dict[str, NodeTypeConfig],
    ):
        self.provider = provider
        self.node_types = node_types
        self._lock = threading.Lock()
        #: cloud_instance_id -> launch tag (instance_id)
        self._tags: Dict[str, str] = {}
        self._errors: List[ProviderError] = []
        self._work: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._drain, daemon=True
        )
        self._thread.start()

    # -- async ops (worker thread) ------------------------------------
    def _drain(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            kind, payload = item
            try:
                if kind == "launch":
                    inst: Instance = payload
                    cfg = self.node_types[inst.instance_type]
                    cloud_id = self.provider.create_node(
                        inst.instance_type,
                        cfg.resources,
                        dict(cfg.labels),
                    )
                    with self._lock:
                        self._tags[cloud_id] = inst.instance_id
                elif kind == "terminate":
                    self.provider.terminate_node(payload)
            except Exception as e:  # noqa: BLE001 — surfaced as error
                with self._lock:
                    if kind == "launch":
                        self._errors.append(
                            ProviderError(
                                kind="launch",
                                instance_id=payload.instance_id,
                                details=repr(e),
                            )
                        )
                    else:
                        self._errors.append(
                            ProviderError(
                                kind="terminate",
                                cloud_instance_id=payload,
                                details=repr(e),
                            )
                        )

    def launch(self, inst: Instance) -> None:
        self._work.put(("launch", inst))

    def terminate(self, cloud_instance_id: str) -> None:
        self._work.put(("terminate", cloud_instance_id))

    def non_terminated(self) -> Dict[str, CloudInstance]:
        out: Dict[str, CloudInstance] = {}
        with self._lock:
            tags = dict(self._tags)
        for cid in self.provider.non_terminated_nodes():
            out[cid] = CloudInstance(
                cloud_instance_id=cid,
                instance_type=self.provider.node_type(cid) or "",
                instance_id=tags.get(cid),
            )
        return out

    def poll_errors(self) -> List[ProviderError]:
        with self._lock:
            errors, self._errors = self._errors, []
            return errors

    def node_ids_of(self, cloud_id: str, load: dict) -> List[dict]:
        """Daemons of one cloud instance: label match (slice nodes)
        with single-node provider mapping fallback (same resolution as
        v1 StandardAutoscaler._daemons_of)."""
        daemons = [
            n
            for n in load.get("nodes", [])
            if (n.get("labels") or {}).get(PROVIDER_NODE_LABEL)
            == cloud_id
        ]
        if daemons:
            return daemons
        node_id = self.provider.cluster_node_id(cloud_id)
        return [
            n
            for n in load.get("nodes", [])
            if n["node_id"] == node_id
        ]

    def shutdown(self) -> None:
        self._work.put(None)
        self._thread.join(timeout=5)


class AutoscalerV2:
    def __init__(
        self,
        provider: NodeProvider,
        node_types: Dict[str, NodeTypeConfig],
        *,
        head_address: Optional[str] = None,
        config: Optional[ReconcileConfig] = None,
    ):
        self.node_types = node_types
        self.config = config or ReconcileConfig()
        self.adapter = V1ProviderAdapter(provider, node_types)
        self.manager = InstanceManager()
        self.head_address = head_address or provider.head_address
        self._client = None
        #: Two-strike leak reclaim: a cloud id is only terminated if
        #: it was already unclaimed on the PREVIOUS pass — closes the
        #: race where a freshly created node is listed before its
        #: launch tag lands in the adapter.
        self._leak_suspects: set = set()
        self.manager.subscribe(self._on_update)

    # -- subscriber: transitions -> provider side effects -------------
    def _on_update(
        self, inst: Instance, ev: InstanceUpdateEvent
    ) -> None:
        if ev.new_status == S.REQUESTED:
            inst.launch_attempts += 1
            self.adapter.launch(inst)
        elif ev.new_status == S.TERMINATING:
            if inst.cloud_instance_id:
                self.adapter.terminate(inst.cloud_instance_id)
        elif ev.new_status == S.RAY_STOP_REQUESTED:
            # No separate drain protocol on the fake/GCE providers:
            # acknowledge the stop so the reconciler reclaims the
            # cloud instance next pass (RAY_STOPPING -> TERMINATING).
            self.manager.update(
                [
                    InstanceUpdateEvent(
                        instance_id=inst.instance_id,
                        new_status=S.RAY_STOPPING,
                        details="drain acknowledged",
                    )
                ]
            )

    def _load(self) -> dict:
        from ..._private.rpc import RpcClient

        if self._client is None:
            self._client = RpcClient(self.head_address)
        return self._client.call("cluster_load")

    def update(self) -> dict:
        load = self._load()
        cloud = self.adapter.non_terminated()
        result = Reconciler.reconcile(
            self.manager,
            node_types=self.node_types,
            cloud_instances=cloud,
            load=load,
            config=self.config,
            provider_errors=self.adapter.poll_errors(),
            node_ids_of=lambda cid: self.adapter.node_ids_of(
                cid, load
            ),
        )
        # Leaked cloud instances (present at the provider, unknown to
        # the instance table) are reclaimed on the second consecutive
        # sighting.
        leaked_now = set(result["leaked"])
        for cid in leaked_now & self._leak_suspects:
            self.adapter.terminate(cid)
        self._leak_suspects = leaked_now
        return result

    def summary(self) -> List[dict]:
        return self.manager.summary()

    def shutdown(self) -> None:
        self.adapter.shutdown()


class MonitorV2:
    """Background reconcile loop (reference: v2/monitor.py)."""

    def __init__(
        self, autoscaler: AutoscalerV2, interval_s: float = 0.5
    ):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception:  # noqa: BLE001 — loop must survive
                pass
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class AutoscalingClusterV2:
    """Hermetic v2 test cluster: head + fake provider + v2 loop
    (v2 twin of autoscaler.cluster.AutoscalingCluster)."""

    def __init__(
        self,
        head_resources: Optional[Dict[str, float]] = None,
        worker_node_types: Optional[Dict[str, dict]] = None,
        idle_timeout_s: float = 3.0,
        update_interval_s: float = 0.3,
    ):
        from ...cluster_utils import Cluster

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
                slice_hosts=spec.get("slice_hosts", 1),
            )
            for name, spec in (worker_node_types or {}).items()
        }
        self.provider = FakeMultiNodeProvider(
            self.cluster.address, self.cluster.session_dir
        )
        self.autoscaler = AutoscalerV2(
            self.provider,
            types,
            config=ReconcileConfig(idle_timeout_s=idle_timeout_s),
        )
        self.monitor = MonitorV2(self.autoscaler, update_interval_s)

    @property
    def address(self) -> str:
        return self.cluster.address

    def start(self) -> None:
        self.monitor.start()

    def num_workers(self) -> int:
        return len(self.provider.non_terminated_nodes())

    def shutdown(self) -> None:
        self.monitor.stop()
        self.autoscaler.shutdown()
        self.provider.shutdown()
        self.cluster.shutdown()
