# Copied from ray_tpu/_private/gcs.py (JAX-free): module names read ray_tpu_torch.
"""Control-plane state tables (GCS equivalent).

The reference's Global Control Service is a standalone server hosting
node/actor/job/placement-group/worker/task managers over typed tables
with pluggable storage (reference: src/ray/gcs/gcs_server/gcs_server.h,
init order gcs_server.cc:183-233; storage src/ray/gcs/store_client/).

Here the same tables live in one `ControlState` object. On a head node
it is embedded in the node daemon and served over its RPC socket; other
node daemons talk to it remotely — mirroring how every raylet holds a
GcsClient. Persistence (the reference's Redis StoreClient) is a JSON
snapshot hook, sufficient for restart-with-state-recovery semantics.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .ids import ActorID, JobID, NodeID, PlacementGroupID

_FRAME = struct.Struct(">I")


class StateLog:
    """Append-only op log backing control-plane fault tolerance
    (reference role: the Redis store client behind GCS tables,
    src/ray/gcs/store_client/redis_store_client.h — here a length-
    prefixed pickle frame log in the session dir; a head restarted
    over the same session replays it and resumes).

    Frames are `[u32 length][pickle bytes]`. A torn final frame (crash
    mid-write) is detected by length mismatch and dropped."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "ab")  # noqa: SIM115 — lifetime = daemon

    def append(self, op: tuple) -> None:
        payload = pickle.dumps(op, protocol=5)
        with self._lock:
            self._f.write(_FRAME.pack(len(payload)) + payload)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass

    @staticmethod
    def replay(path: str) -> List[tuple]:
        ops: List[tuple] = []
        if not os.path.exists(path):
            return ops
        with open(path, "rb") as f:
            data = f.read()
        cursor = 0
        while cursor + _FRAME.size <= len(data):
            (length,) = _FRAME.unpack_from(data, cursor)
            cursor += _FRAME.size
            if cursor + length > len(data):
                break  # torn tail frame from a crash mid-write
            try:
                ops.append(pickle.loads(data[cursor:cursor + length]))
            except Exception:
                break
            cursor += length
        return ops

# Actor lifecycle states (reference: src/ray/design_docs/actor_states.rst).
ACTOR_DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
ACTOR_PENDING_CREATION = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"


@dataclass
class NodeInfo:
    node_id: NodeID
    address: str
    resources: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.time)
    is_head: bool = False
    # Load view refreshed by heartbeats (reference: ray_syncer resource
    # gossip feeding ClusterResourceManager).
    available: Dict[str, float] = field(default_factory=dict)
    queued: int = 0
    #: Latest core-metrics snapshot (metric_defs.collect) that rode a
    #: heartbeat; the head merges these into metrics_summary.
    core_metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    namespace: str
    state: str
    class_name: str
    node_id: Optional[NodeID] = None
    worker_id: Optional[Any] = None
    max_restarts: int = 0
    num_restarts: int = 0
    death_cause: Optional[str] = None


@dataclass
class JobInfo:
    job_id: JobID
    driver_pid: int
    start_time: float
    end_time: Optional[float] = None
    entrypoint: str = ""


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    name: Optional[str]
    strategy: str  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    bundles: List[Dict[str, float]]
    state: str = "PENDING"  # PENDING | CREATED | REMOVED
    bundle_nodes: List[Optional[NodeID]] = field(default_factory=list)


class ControlState:
    """All control-plane tables behind one lock.

    Sub-tables mirror the reference's managers: kv (GcsKvManager),
    nodes (GcsNodeManager), actors (GcsActorManager), jobs
    (GcsJobManager), placement groups (GcsPlacementGroupManager), task
    events (GcsTaskManager ring buffer).
    """

    def __init__(
        self,
        task_events_max: int = 10000,
        log: Optional[StateLog] = None,
    ):
        self._lock = threading.RLock()
        self.kv: Dict[str, Dict[str, bytes]] = {}  # namespace -> key -> val
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[tuple, ActorID] = {}  # (namespace, name)
        self.jobs: Dict[JobID, JobInfo] = {}
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self.task_events: deque = deque(maxlen=task_events_max)
        self._job_counter = 0
        #: Durable op log; None = in-memory only. Set AFTER replay so
        #: restored ops are not re-logged.
        self.log: Optional[StateLog] = log

    def _log(self, *op) -> None:
        if self.log is not None:
            try:
                self.log.append(op)
            except OSError:
                pass

    def log_extra(self, *op) -> None:
        """Durably record an op owned by the embedding daemon (e.g.
        actor creation specs); handed back verbatim from restore()."""
        self._log(*op)

    def restore(self, ops: List[tuple]) -> List[tuple]:
        """Replay logged ops into the tables (call before attaching a
        live log). Returns ops this class doesn't own (e.g. the
        daemon's actor creation specs) for the caller to apply."""
        extra: List[tuple] = []
        for op in ops:
            kind = op[0]
            if kind == "kv_put":
                self.kv.setdefault(op[1], {})[op[2]] = op[3]
            elif kind == "kv_del":
                self.kv.get(op[1], {}).pop(op[2], None)
            elif kind == "register_node":
                info = op[1]
                # Not alive until it re-registers/heartbeats with the
                # restarted head.
                info.alive = False
                self.nodes[info.node_id] = info
            elif kind == "mark_node_dead":
                if op[1] in self.nodes:
                    self.nodes[op[1]].alive = False
            elif kind == "job_counter":
                self._job_counter = max(self._job_counter, op[1])
            elif kind == "add_job":
                self.jobs[op[1].job_id] = op[1]
            elif kind == "finish_job":
                if op[1] in self.jobs:
                    self.jobs[op[1]].end_time = (
                        op[2] if len(op) > 2 else time.time()
                    )
            elif kind == "register_actor":
                info = op[1]
                self.actors[info.actor_id] = info
                if info.name and info.state != ACTOR_DEAD:
                    self.named_actors[(info.namespace, info.name)] = (
                        info.actor_id
                    )
            elif kind == "update_actor_state":
                info = self.actors.get(op[1])
                if info is not None:
                    info.state = op[2]
                    for k, v in op[3].items():
                        setattr(info, k, v)
                    if op[2] == ACTOR_DEAD and info.name:
                        self.named_actors.pop(
                            (info.namespace, info.name), None
                        )
            elif kind == "add_placement_group":
                self.placement_groups[op[1].pg_id] = op[1]
            else:
                extra.append(op)
        return extra

    # ---- kv (function blobs, cluster config) ----
    def kv_put(self, ns: str, key: str, value: bytes, overwrite=True) -> bool:
        with self._lock:
            table = self.kv.setdefault(ns, {})
            if not overwrite and key in table:
                return False
            table[key] = value
            self._log("kv_put", ns, key, value)
            return True

    def kv_get(self, ns: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self.kv.get(ns, {}).get(key)

    def kv_del(self, ns: str, key: str) -> None:
        with self._lock:
            self.kv.get(ns, {}).pop(key, None)
            self._log("kv_del", ns, key)

    def kv_keys(self, ns: str, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self.kv.get(ns, {}) if k.startswith(prefix)]

    # ---- nodes ----
    def register_node(self, info: NodeInfo) -> None:
        with self._lock:
            self.nodes[info.node_id] = info
            self._log("register_node", info)

    def heartbeat(self, node_id: NodeID) -> None:
        with self._lock:
            if node_id in self.nodes:
                self.nodes[node_id].last_heartbeat = time.time()

    def mark_node_dead(self, node_id: NodeID) -> None:
        with self._lock:
            if node_id in self.nodes:
                self.nodes[node_id].alive = False
                self._log("mark_node_dead", node_id)

    def alive_nodes(self) -> List[NodeInfo]:
        with self._lock:
            return [n for n in self.nodes.values() if n.alive]

    def all_nodes(self) -> List[NodeInfo]:
        """Snapshot of every known node, dead ones included — readers
        must not iterate `self.nodes` bare (registration on another
        thread would resize the dict mid-iteration)."""
        with self._lock:
            return list(self.nodes.values())

    # ---- jobs ----
    def next_job_id(self) -> JobID:
        with self._lock:
            self._job_counter += 1
            self._log("job_counter", self._job_counter)
            return JobID.from_int(self._job_counter)

    def add_job(self, info: JobInfo) -> None:
        with self._lock:
            self.jobs[info.job_id] = info
            self._log("add_job", info)

    def finish_job(self, job_id: JobID) -> None:
        with self._lock:
            if job_id in self.jobs:
                now = time.time()
                self.jobs[job_id].end_time = now
                self._log("finish_job", job_id, now)

    # ---- actors ----
    def register_actor(self, info: ActorInfo) -> None:
        with self._lock:
            if info.name:
                key = (info.namespace, info.name)
                if key in self.named_actors:
                    raise ValueError(
                        f"Actor name {info.name!r} already taken in "
                        f"namespace {info.namespace!r}"
                    )
                self.named_actors[key] = info.actor_id
            self.actors[info.actor_id] = info
            self._log("register_actor", info)

    def update_actor_state(self, actor_id: ActorID, state: str, **kw) -> None:
        with self._lock:
            info = self.actors.get(actor_id)
            if info is None:
                return
            info.state = state
            for k, v in kw.items():
                setattr(info, k, v)
            if state == ACTOR_DEAD and info.name:
                self.named_actors.pop((info.namespace, info.name), None)
            self._log("update_actor_state", actor_id, state, kw)

    def get_named_actor(self, namespace: str, name: str) -> Optional[ActorInfo]:
        with self._lock:
            actor_id = self.named_actors.get((namespace, name))
            return self.actors.get(actor_id) if actor_id else None

    # ---- placement groups ----
    def add_placement_group(self, info: PlacementGroupInfo) -> None:
        with self._lock:
            self.placement_groups[info.pg_id] = info
            self._log("add_placement_group", info)

    # ---- task events (observability ring buffer) ----
    def add_task_event(self, event: dict) -> None:
        with self._lock:
            self.task_events.append(event)

    def list_task_events(self, limit: int = 1000) -> List[dict]:
        with self._lock:
            return list(self.task_events)[-limit:]

    # ---- state API snapshot ----
    def summary(self) -> dict:
        with self._lock:
            return {
                "nodes": len(self.nodes),
                "alive_nodes": sum(1 for n in self.nodes.values() if n.alive),
                "actors": len(self.actors),
                "jobs": len(self.jobs),
                "placement_groups": len(self.placement_groups),
            }
