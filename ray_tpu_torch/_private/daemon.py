# Copied from ray_tpu/_private/daemon.py (JAX-free): module names read ray_tpu_torch, and the TPU resource is the GPU.
"""Per-node daemon: local scheduler + worker pool + object plane,
with the control plane embedded on the head node.

This process plays the role of the reference's raylet (reference:
src/ray/raylet/node_manager.h — worker leasing node_manager.cc:1807,
dependency-gated dispatch local_task_manager.cc:122, worker pool
worker_pool.cc:1312) and, on the head node, also the GCS server
(src/ray/gcs/gcs_server/gcs_server.h). Folding GCS into the head
daemon replaces the reference's separate `gcs_server` binary; the
tables are the same (`gcs.ControlState`).

Topology: every node runs a `NodeDaemon`. The head (`is_head=True`)
owns all control tables, object metadata (locations, refcounts), the
cluster scheduler (policies.py), actor lifecycle decisions, and node
health. Worker nodes (`is_head=False`, `head_address=...`) proxy
control ops to the head, execute tasks forwarded by the head against
their local worker pool, and serve/pull object data node-to-node
(the reference's ObjectManager push/pull plane,
src/ray/object_manager/object_manager.h, chunked per
ray_config_def.h:341). Placement is decided centrally at the head from
heartbeat-refreshed load views — the GCS-scheduling path of the
reference rather than raylet spillback.

Workers and drivers connect over a Unix socket (`rpc.RpcServer`).
Large objects never pass through this process on the node that owns
them: clients write them straight into per-object shared memory and
only the seal notification flows here (the plasma create/seal
protocol, src/ray/object_manager/plasma/store.h).
"""

from __future__ import annotations

import bisect
import json
import math
import os
import queue
import subprocess
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .config import Config
from .gcs import (
    ACTOR_ALIVE,
    ACTOR_DEAD,
    ACTOR_PENDING_CREATION,
    ACTOR_RESTARTING,
    ActorInfo,
    ControlState,
    JobInfo,
    NodeInfo,
)
from .ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)
from .object_store import ObjectStoreFullError, make_store
from .spilling import FileSpillStorage
from .placement_groups import (
    PGEntry,
    STRATEGIES,
    group_resources,
    place_bundles,
)
from .policies import NodeView, PlacementPolicy
from .rpc import DEFERRED, Connection, RpcClient, RpcError, RpcServer
from .scheduler import LocalScheduler, ResourceSet
from ray_tpu_torch.devtools.lock_witness import make_lock

# Object entry states.
PENDING = "PENDING"
SEALED = "SEALED"
ERRORED = "ERRORED"

#: A CPU worker's env keeps the host's CUDA_VISIBLE_DEVICES under this
#: name (as JSON, null where the host left it unset): the worker's own
#: is "", which hides the cards.
HOST_CUDA_VISIBLE_DEVICES = "RT_HOST_CUDA_VISIBLE_DEVICES"


def _oob_chunk(chunk: bytes):
    """Wrap an object-transfer chunk so the wire layer ships it as a
    pickle-5 out-of-band buffer: the sender scatter-gathers it straight
    from this memory and the receiver reconstructs a zero-copy view of
    its receive buffer (numpy implements the PickleBuffer protocol;
    raw bytes would be copied back in at load). The puller's
    `buf[off:off+n] = data` assignment accepts the array view as-is."""
    import numpy as np

    return np.frombuffer(chunk, dtype=np.uint8)


@dataclass
class ObjectEntry:
    state: str = PENDING
    size: int = 0
    inline: Optional[bytes] = None  # small objects live here (head)
    error: Optional[bytes] = None  # serialized TaskError payload
    in_shm: bool = False  # data present in THIS node's store
    refcount: int = 1  # head-only: owner refcount
    waiters: List[tuple] = field(default_factory=list)  # (conn, mid)
    # head-only: which nodes hold a shm copy + meta subscribers.
    locations: Set[bytes] = field(default_factory=set)
    meta_waiters: List[tuple] = field(default_factory=list)
    pulling: bool = False
    reconstructing: bool = False
    #: Data written to this node's spill storage; the shm copy may be
    #: gone but the object is still servable locally (reference:
    #: ObjectTableData spilled_url, gcs.proto).
    spilled: bool = False
    # Owner attribution (reference: ObjectTableData owner/spilled
    # fields; the memory ledger's per-job accounting rides these).
    #: Hex job id of the creating client; "" = unattributed.
    owner_job: str = ""
    #: Creating context: "driver", "task:<hex>" or "actor:<hex>".
    owner: str = ""
    #: Pid of the creating client ON THE SEALING NODE (0 elsewhere);
    #: probed for liveness by that node's memory report only.
    owner_pid: int = 0
    #: Wall time of the first seal (leak-age anchor).
    created_ts: float = 0.0
    #: How THIS node's shm copy materialised: "" (sealed locally),
    #: "pull" (remote arena), "pull_spill" (remote spill file) or
    #: "restore" (this node's own spill file). Drives get-path
    #: provenance classification in worker replies.
    source: str = ""
    #: Hex node id the copy was pulled from ("" unless source is a
    #: pull kind).
    src_node: str = ""
    #: True only between the materialising event and its waiter wake:
    #: gets that actually waited on the pull/restore bill it; later
    #: gets of the (now warm) copy classify as local arena hits.
    source_fresh: bool = False


@dataclass
class WorkerInfo:
    conn: Connection
    worker_id: WorkerID
    pid: int
    idle: bool = True
    #: Wall time of the last busy->idle transition (drives idle reap).
    idle_since: float = field(default_factory=time.time)
    is_gpu: bool = False
    pinned_actor: Optional[ActorID] = None
    current_task: Optional[TaskID] = None
    #: Direct-transport endpoint served by the worker process
    #: (reference: the worker's gRPC server in core_worker.h).
    direct_address: Optional[str] = None
    #: conn_id of the driver holding this worker via request_lease.
    leased_by: Optional[int] = None


@dataclass
class TaskEntry:
    spec: dict
    state: str = "PENDING"
    retries_left: int = 0
    node: Optional[bytes] = None  # head-only: forwarded-to node


@dataclass
class ActorHost:
    """Per-node hosting record: binds an actor to a local worker
    (reference: the executing side of ActorTaskSubmitter — the worker
    the creation task leased, transport/actor_task_submitter.h)."""

    creation_spec: dict
    worker_conn_id: Optional[int] = None
    pending: deque = field(default_factory=deque)
    inflight: Dict[TaskID, dict] = field(default_factory=dict)


@dataclass
class ActorRuntime:
    """Head-side authoritative actor record (reference:
    GcsActorManager state machine, design_docs/actor_states.rst)."""

    creation_spec: dict
    info: ActorInfo
    node: Optional[bytes] = None  # hosting node id
    pending: deque = field(default_factory=deque)  # queued while !ALIVE
    inflight: Dict[TaskID, dict] = field(default_factory=dict)
    creation_unpinned: bool = False


def _summarize_steps(records: List[dict]) -> dict:
    """Digest per-step/per-rank phase records into the two views the
    doctor needs: per-worker step-time stats (straggler detection) and
    per-step gang skew (max - min step_ms across the ranks that
    reported that step index).

    Stats are computed over the MOST RECENT job only: mixing two
    jobs' same-rank records (concurrent tenants, or back-to-back runs
    within the ring) would yield phantom stragglers and meaningless
    skew. Older jobs stay in the raw ring (`step_records`); the
    summary reports how many distinct jobs it saw."""
    jobs: Dict[str, float] = {}
    for rec in records:
        job = str(rec.get("job", ""))
        t = float(rec.get("time", 0.0))
        if t >= jobs.get(job, -1.0):
            jobs[job] = t
    if len(jobs) > 1:
        current = max(jobs, key=lambda j: jobs[j])
        records = [
            r for r in records if str(r.get("job", "")) == current
        ]
    by_step: Dict[int, Dict[int, dict]] = {}
    by_rank: Dict[int, List[dict]] = {}
    for rec in records:
        rank = int(rec.get("rank", 0))
        by_step.setdefault(int(rec.get("step", 0)), {})[rank] = rec
        by_rank.setdefault(rank, []).append(rec)
    skew: Dict[int, float] = {}
    for step, ranks in by_step.items():
        # Warmup (first-report) records derive step_ms from a wall
        # anchored at session construction — setup time, not a step;
        # ranks differ in setup time, so including them fakes skew.
        values = [
            float(r.get("step_ms", 0.0))
            for r in ranks.values()
            if not r.get("warmup")
        ]
        if len(values) >= 2:
            skew[step] = round(max(values) - min(values), 3)
    workers: Dict[int, dict] = {}
    for rank, recs in by_rank.items():
        timed = [r for r in recs if not r.get("warmup")] or recs
        step_ms = sorted(float(r.get("step_ms", 0.0)) for r in timed)
        row = {
            # The sample count BEHIND the stats: warmup records are
            # excluded, so the doctor's `steps >= 3` straggler gate
            # never convicts on fewer measured steps than it claims.
            "steps": len(timed),
            "p50_step_ms": round(step_ms[len(step_ms) // 2], 3),
            "max_step_ms": round(step_ms[-1], 3),
            "mean_step_ms": round(sum(step_ms) / len(step_ms), 3),
        }
        for phase in ("data_wait_ms", "h2d_ms", "wall_ms"):
            values = [
                float(r[phase]) for r in timed if phase in r
            ]
            if values:
                row["mean_" + phase] = round(
                    sum(values) / len(values), 3
                )
        inflight = [
            int(r["ckpt_inflight"])
            for r in recs
            if "ckpt_inflight" in r
        ]
        if inflight:
            row["max_ckpt_inflight"] = max(inflight)
        workers[rank] = row
    return {
        "workers": workers,
        "skew_ms": skew,
        "max_skew_ms": max(skew.values(), default=0.0),
        "steps_observed": len(by_step),
        "jobs_observed": len(jobs),
    }


class NodeDaemon:
    def __init__(
        self,
        session_dir: str,
        resources: Dict[str, float],
        config: Config,
        is_head: bool = True,
        head_address: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
        listen_host: Optional[str] = None,
        listen_port: int = 0,
    ):
        """A per-host daemon (raylet analog). Local workers always ride
        the session Unix socket; passing `listen_host` additionally
        binds a TCP listener (DCN transport) whose address is what the
        node advertises cluster-wide — the configuration for real
        multi-host deployments (reference: raylet's gRPC
        NodeManagerService port, node_manager.proto:406)."""
        self.session_dir = session_dir
        self.config = config
        # Before any make_lock() below: the witness only instruments
        # locks created after it is installed.
        from ray_tpu_torch.devtools.lock_witness import configure as _witness_configure

        _witness_configure(config)
        self.is_head = is_head
        self.node_id = NodeID.from_random()
        self.socket_path = os.path.join(session_dir, "hostd.sock")
        os.makedirs(session_dir, mode=0o700, exist_ok=True)
        try:
            # exist_ok skips mode application on pre-existing dirs;
            # the session dir's permissions gate unix-socket access
            # (rpc.py _frame_mac), so enforce them regardless.
            os.chmod(session_dir, 0o700)
        except OSError:
            pass

        capacity = config.object_store_memory or _default_store_bytes()
        self.store = make_store(
            self.node_id.hex(),
            capacity,
            on_evict=self._on_store_evict,
            use_native=config.use_native_object_store,
        )
        self.spill: Optional[FileSpillStorage] = None
        if config.object_spilling_enabled:
            self.spill = FileSpillStorage(
                os.path.join(
                    session_dir, "spilled_objects", self.node_id.hex()[:8]
                )
            )
        self._spill_lock = make_lock("daemon.spill")
        # Primary-copy pins: the daemon holds a read pin on every object
        # sealed by a local client so LRU eviction can never destroy the
        # only copy — store-full becomes a spill trigger instead
        # (reference: raylet pins primary copies via PinObjectIDs,
        # local_object_manager.h:41; spilling releases the pin).
        self._primary_pins: Dict[ObjectID, object] = {}
        self.scheduler = LocalScheduler(ResourceSet(resources))
        self.resources = dict(resources)
        self.labels = dict(labels or {})

        self._lock = make_lock("daemon.state", "rlock")
        # Core metrics (reference: stats/metric_defs.cc central
        # registry): monotonic event counters bumped at the few sites
        # where things happen; gauges computed at scrape
        # (metric_defs.collect).
        from .metric_defs import CoreCounters

        self.core_counters = CoreCounters()
        self.started_at = time.time()
        self.objects: Dict[ObjectID, ObjectEntry] = {}
        self.tasks: Dict[TaskID, TaskEntry] = {}
        self.actor_hosts: Dict[ActorID, ActorHost] = {}
        self.workers: Dict[int, WorkerInfo] = {}  # conn_id -> info
        self.drivers: Dict[int, JobID] = {}  # conn_id -> job
        self._spawning = 0
        self._spawn_watchlist: list = []
        self._spawn_watch_lock = threading.Lock()
        self._spawn_watcher: Optional[threading.Thread] = None
        #: Same-host peers' arenas attached for shm-copy pulls,
        #: keyed by arena path (see _pull_same_host).
        self._peer_arenas: Dict[str, object] = {}
        self._fork_server = None  # warm worker template (lazy)
        self._fork_server_lock = threading.Lock()
        # Worker spawns run on a dedicated thread: the fork-server
        # handshake (and a cold Popen on a loaded box) does blocking
        # I/O that must never run under self._lock — every dispatch,
        # registration and heartbeat handler needs that lock.
        self._spawn_queue: "queue.Queue" = queue.Queue()
        self._spawn_thread: Optional[threading.Thread] = None
        self._spawn_failures = 0
        #: Cumulative (never reset): workers that died before
        #: registering. Test fixtures assert this stays 0 — a startup
        #: crash is a bug even when a later spawn succeeded
        #: (the consecutive counter above resets on success).
        self._spawn_crash_total = 0
        #: Every pid that has EVER registered as a worker. The spawn
        #: watcher must consult history, not the live `workers` dict: a
        #: short-lived worker (one fast trial, then exit) can register
        #: AND exit between two watcher ticks — judging only by "is it
        #: registered right now" counts that healthy lifecycle as a
        #: startup crash (observed: TPE trials under heavy box load).
        self._registered_pids_ever: set = set()
        self._shutdown = False
        self._worker_procs: List[subprocess.Popen] = []
        # Direct-transport leases: lease_id -> (worker_conn_id,
        # driver_conn_id). The worker is out of the shared pool while
        # leased; its resources stay reserved in the scheduler under
        # the lease id (reference: raylet worker leases,
        # node_manager.cc:1807 HandleRequestWorkerLease).
        self.leases: Dict[str, tuple] = {}
        self._lease_counter = 0
        # actor_id -> [(conn, mid)] waiting for the actor's direct
        # address (replied when the actor becomes ALIVE or DEAD).
        self._actor_addr_waiters: Dict[ActorID, list] = {}
        # Driver connections subscribed to worker log streaming
        # (reference: log_monitor.py publishes tailed lines; drivers
        # print them). conn_id -> Connection. On the head this also
        # holds worker-node relay connections.
        self._log_subscribers: Dict[int, Connection] = {}
        # Worker-node cache of "does the head have log subscribers",
        # piggybacked on heartbeat replies.
        self._head_logs_wanted = False
        # Head-side resource-sync versions: node_id -> last version
        # whose load snapshot was applied (versioned delta heartbeats).
        self._node_sync_versions: Dict[bytes, int] = {}
        # Finished tracing spans (head only; own ring so span-heavy
        # apps and task-event-heavy apps can't evict each other).
        self._spans: deque = deque(maxlen=config.task_events_max_buffer)
        # Per-step, per-worker phase records from train telemetry
        # (head only; ride the metrics pipe as kind="step" records).
        # Bounded ring: old steps age out, the skew computation only
        # ever wants the recent window anyway.
        self._step_records: deque = deque(
            maxlen=config.task_events_max_buffer
        )
        # XLA compile watch (head): per-program digest rings folded
        # from kind="compile" metrics-pipe records
        # (_private/compile_watch.py fold_record — the same structure
        # the per-process registry keeps, so detect_storms serves
        # both). Bounded by construction: program names are
        # registered families, digests ring-capped per program.
        self._compile_programs: Dict[str, dict] = {}
        # Head time-series ring: periodic compacted snapshots of the
        # metric table so p50/p99 TRENDS survive past the live
        # reservoir (`/api/timeseries`, `ray_tpu_torch metrics snapshot`).
        from .timeseries import TimeSeriesStore

        self._timeseries = TimeSeriesStore(
            config.metrics_timeseries_max_snapshots
        )
        # Cluster memory & per-job usage ledger (head: aggregates the
        # per-node reports; every node builds its own report on the
        # memory-report tick).
        from .memory_ledger import MemoryLedger

        self._memory_ledger = MemoryLedger(
            max_owner_series=config.memory_report_topk
        )
        self._memory_folded_at = 0.0
        # Per-job spill/restore OP counts on THIS node (cumulative;
        # ride the node memory report so the head's ledger attributes
        # rt_object_spills/restores_total to the job that forced them).
        self._job_spill_ops: Dict[str, int] = {}
        self._job_restore_ops: Dict[str, int] = {}
        # This process's flight recorder obeys the cluster config
        # (env RT_flight_recorder_enabled already applied at import).
        from .compile_watch import configure as _compile_configure
        from .flight_recorder import configure as _flight_configure

        _flight_configure(config)
        _compile_configure(config)

        max_workers = config.max_workers_per_node or max(
            4, int(4 * resources.get("CPU", 1))
        )
        self._max_workers = max_workers
        # In-flight worker-process startups allowed at once (reference:
        # worker_pool.cc maximum_startup_concurrency = num_cpus). Actor
        # creations spawn past _max_workers but never past this gate.
        self._startup_concurrency = max(
            2, int(resources.get("CPU", 1))
        )

        # Head-only state.
        self.control: Optional[ControlState] = None
        self.actor_runtimes: Dict[ActorID, ActorRuntime] = {}
        self._policy = PlacementPolicy(
            config.scheduler_spread_threshold,
            config.scheduler_top_k_fraction,
        )
        self._infeasible: Dict[TaskID, dict] = {}  # spec by task id
        self._node_clients: Dict[bytes, RpcClient] = {}
        self._node_conns: Dict[int, bytes] = {}  # conn_id -> node_id
        self._memory_monitor = None
        # Application metrics (head): name -> aggregate state
        # (reference: metrics agent aggregation, _private/metrics_agent
        # .py; serving role of the OpenCensus registry).
        self._metrics_table: Dict[str, dict] = {}
        # (sender, seq) pairs already folded into the table: senders
        # retry sealed batches until acknowledged, so a batch whose
        # reply was lost arrives again — applying it twice would
        # silently inflate every counter it carries. Per sender:
        # [high-water mark, out-of-order seqs above it] — in-order
        # delivery keeps the set empty (O(1) resident per sender for
        # the head's lifetime); only a trim-induced seq gap parks
        # seqs in the set until the gap is passed.
        self._metrics_seen: Dict[str, list] = {}
        #: Standing autoscaler capacity target (head only; sdk
        #: request_resources — REPLACE semantics, cleared by []).
        self._resource_requests: List[dict] = []
        # Placement groups: head-side registry + node-side reserved
        # bundles ((pg_id, index) -> {"resources", "committed"}).
        self.pgs: Dict[bytes, PGEntry] = {}
        self._bundles: Dict[tuple, dict] = {}
        # Serializes the 2PC against concurrent retries/removals
        # (reentrant: a local commit inside the 2PC may re-enter
        # scheduling); the non-blocking gate stops _schedule()-driven
        # retries from recursing (place -> commit -> _schedule -> place).
        self._pg_mutex = make_lock("daemon.pg", "rlock")
        self._pg_retry_gate = threading.Lock()
        # Node-only state.
        self.head: Optional[RpcClient] = None
        self._peer_clients: Dict[str, RpcClient] = {}  # address -> client
        self._hb_thread: Optional[threading.Thread] = None

        self.server = RpcServer(self.socket_path)
        listen_host = listen_host or config.node_listen_host or None
        if listen_host:
            self.address = self.server.add_listener(
                f"tcp://{listen_host}:"
                f"{listen_port or config.node_listen_port}"
            )
        else:
            self.address = self.socket_path
        for name in [
            "register_client",
            "kv_put",
            "kv_get",
            "kv_del",
            "kv_keys",
            "submit_task",
            "submit_tasks",
            "submit_actor_task",
            "create_actor",
            "get_object",
            "get_objects",
            "wait_objects",
            "put_inline",
            "object_sealed",
            "seal_error",
            "task_done",
            "del_ref",
            "add_ref",
            "get_named_actor",
            "get_actor_info",
            "kill_actor",
            "cancel_task",
            "cluster_resources",
            "available_resources",
            "state_summary",
            "list_task_events",
            "list_nodes",
            "list_actors",
            "list_objects",
            "cluster_load",
            "request_resources",
            "metrics_record",
            "metrics_summary",
            "metrics_timeseries",
            # memory ledger (reports flow node -> head; the summary
            # serves `ray_tpu_torch memory` and /api/memory)
            "memory_report",
            "memory_summary",
            # data plane (ISSUE 20): the transfer matrix and the
            # object location/size index
            "transfer_summary",
            "object_locations",
            "event_stats",
            "profile_worker",
            # XLA observability: coordinated gang profiling + the
            # head's folded compile table (verdict.compile's data)
            "profile_gang",
            "compile_summary",
            # flight recorder / stall doctor (all nodes; diagnose and
            # step_summary forward to the head)
            "flight_recorder",
            "lock_witness",
            "worker_inspect",
            "step_summary",
            "diagnose",
            "ping",
            # object data plane (all nodes)
            "pull_object",
            "delete_object",
            # placement groups (API on head; bundle 2PC on all nodes)
            "create_placement_group",
            "remove_placement_group",
            "placement_group_state",
            "placement_group_table",
            "prepare_bundle",
            "commit_bundle",
            "release_bundle",
            # head control plane (worker nodes call these on the head)
            "register_node",
            "node_heartbeat",
            "get_object_meta",
            "task_finished",
            "actor_created",
            "actor_worker_died",
            "object_evicted",
            # head -> node forwards
            "schedule_task",
            "actor_task",
            "kill_actor_local",
            "cancel_local",
            # direct task transport (placement-only daemon role)
            "request_lease",
            "release_lease",
            "actor_address",
            "task_event",
            "task_counts",
            # tracing spans (all nodes forward to the head's ring)
            "span_event",
            "list_spans",
            # object spilling (all nodes)
            "spill_request",
            # pubsub (subscribe on any node; events forward to head)
            "subscribe_logs",
            "unsubscribe_logs",
            "log_batch",
            "publish_event",
            # head fault tolerance
            "node_resync",
        ]:
            self.server.register(name, getattr(self, "_h_" + name))
        self.server.register("_disconnect", self._h_disconnect)

        if is_head:
            self.control = ControlState(config.task_events_max_buffer)
            if config.gcs_fault_tolerance:
                self._restore_control_state()
            self.control.register_node(
                NodeInfo(
                    node_id=self.node_id,
                    address=self.address,
                    resources=dict(resources),
                    labels=self.labels,
                    is_head=True,
                    available=dict(resources),
                )
            )
        else:
            assert head_address, "worker node needs head_address"
            self.head_address = head_address

    def _restore_control_state(self) -> None:
        """Head fault tolerance (reference: GCS restart over its Redis
        store, node_manager.cc:1189 HandleNotifyGCSRestart): replay the
        session's op log into the control tables and resurrect actor
        runtime records; worker nodes re-register and resync via their
        heartbeat loop when they notice the new head."""
        from .gcs import StateLog

        log_path = os.path.join(self.session_dir, "gcs_oplog.bin")
        ops = StateLog.replay(log_path)
        extra = self.control.restore(ops) if ops else []
        self._restored_pending_creations = []
        for op in extra:
            if op[0] != "actor_spec":
                continue
            spec = op[1]
            actor_id = ActorID(spec["actor_id"])
            info = self.control.actors.get(actor_id)
            if info is None or info.state == ACTOR_DEAD:
                continue
            runtime = ActorRuntime(creation_spec=spec, info=info)
            if info.node_id is not None:
                runtime.node = info.node_id.binary()
            self.actor_runtimes[actor_id] = runtime
            if info.state in (
                ACTOR_PENDING_CREATION, ACTOR_RESTARTING,
            ):
                # Creation was in flight when the head died; the
                # scheduler queue was memory-only, so it must be
                # re-dispatched (after start(), when listeners are up).
                # _h_schedule_task's already-hosting guard keeps a
                # surviving node that finished the creation from
                # getting a duplicate instance.
                self._restored_pending_creations.append(spec)
        self.control.log = StateLog(log_path)

    def _redispatch_restored_creations(self) -> None:
        for spec in getattr(self, "_restored_pending_creations", ()):
            task_id = TaskID(spec["task_id"])
            with self._lock:
                self.tasks[task_id] = TaskEntry(spec=spec)
            try:
                self._submit_cluster(spec)
            except Exception:
                pass
        self._restored_pending_creations = []

    def start(self) -> None:
        self.server.start()
        # Launch the fork-server template early (non-blocking) so its
        # one-time import phase overlaps daemon startup instead of
        # stalling the first worker spawn.
        self._ensure_fork_server()
        if self.is_head:
            self._redispatch_restored_creations()
        threading.Thread(
            target=self._maintenance_loop, daemon=True,
            name=f"maint:{self.node_id.hex()[:8]}",
        ).start()
        if (
            self.is_head
            and self.config.metrics_timeseries_interval_s > 0
        ):
            threading.Thread(
                target=self._timeseries_loop, daemon=True,
                name=f"tsdb:{self.node_id.hex()[:8]}",
            ).start()
        if self.config.log_to_driver:
            threading.Thread(
                target=self._log_monitor_loop, daemon=True,
                name=f"logs:{self.node_id.hex()[:8]}",
            ).start()
        # Prestart under the lock (matching every other _spawn_worker
        # call site — _spawning is a plain counter), clamped so at
        # least one pool slot stays free for a differently-typed (TPU)
        # worker: prestarted workers are CPU-type and nothing reaps
        # idle workers, so filling the pool would starve TPU tasks.
        with self._lock:
            headroom = max(0, self._max_workers - 1) - len(
                self.workers
            ) - self._spawning
            for _ in range(
                min(self.config.worker_prestart_count, max(0, headroom))
            ):
                self._spawn_worker()
        if self.config.memory_monitor_refresh_ms > 0:
            from .memory_monitor import MemoryMonitor

            self._memory_monitor = MemoryMonitor(
                self.config.memory_usage_threshold,
                self.config.memory_monitor_refresh_ms / 1000.0,
                self._oom_candidates,
                self._oom_kill,
            )
            self._memory_monitor.start()
        if not self.is_head:
            self.head = RpcClient(
                self.head_address, push_handler=self._on_head_push
            )
            self.head.set_on_reconnect(self._on_head_reconnect)
            self.head.call(
                "register_node",
                node_id=self.node_id.binary(),
                address=self.address,
                resources=self.resources,
                labels=self.labels,
            )
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"hb:{self.node_id.hex()[:8]}",
            )
            self._hb_thread.start()
        if self.config.memory_report_interval_s > 0:
            # After the head client exists (worker nodes push their
            # reports over it); the head folds its own report locally.
            threading.Thread(
                target=self._memory_report_loop, daemon=True,
                name=f"mem:{self.node_id.hex()[:8]}",
            ).start()

    # ------------------------------------------------------------------
    # registration / lifecycle
    # ------------------------------------------------------------------
    def _h_register_client(self, conn: Connection, msg: dict):
        role = msg["role"]
        if role == "worker":
            info = WorkerInfo(
                conn=conn,
                worker_id=WorkerID.from_random(),
                pid=msg["pid"],
                is_gpu=bool(msg.get("is_gpu", False)),
                direct_address=msg.get("direct_address"),
            )
            with self._lock:
                self.workers[conn.conn_id] = info
                self._registered_pids_ever.add(msg["pid"])
                self._spawning = max(0, self._spawning - 1)
                self._spawn_failures = 0
            conn.metadata["role"] = "worker"
            self._schedule()
            return {
                "node_id": self.node_id.binary(),
                "worker_id": info.worker_id.binary(),
                "store_capacity": self.store.size_info()["capacity"],
                "config": self.config.to_dict(),
            }
        # driver
        if not self.is_head:
            # Drivers attach to the head, which owns job state. (The
            # reference lets drivers attach to any raylet; divergence
            # documented in SURVEY §7 — centralized control plane.)
            raise RuntimeError(
                "drivers must connect to the head node address"
            )
        job_id = self.control.next_job_id()
        self.control.add_job(
            JobInfo(
                job_id=job_id,
                driver_pid=msg["pid"],
                start_time=time.time(),
                entrypoint=msg.get("entrypoint", ""),
            )
        )
        with self._lock:
            self.drivers[conn.conn_id] = job_id
        conn.metadata["role"] = "driver"
        return {
            "node_id": self.node_id.binary(),
            "job_id": job_id.binary(),
            "store_capacity": self.store.size_info()["capacity"],
            "config": self.config.to_dict(),
        }

    def _h_register_node(self, conn, msg):
        """A worker-node daemon joins the cluster (head only)."""
        node_id = NodeID(msg["node_id"])
        with self._lock:
            # (Re-)registration resets NodeInfo.available to totals —
            # any previously acked load snapshot no longer describes
            # what this table holds, so force the node to resend.
            self._node_sync_versions.pop(node_id.binary(), None)
        self.control.register_node(
            NodeInfo(
                node_id=node_id,
                address=msg["address"],
                resources=dict(msg["resources"]),
                labels=dict(msg.get("labels") or {}),
                available=dict(msg["resources"]),
            )
        )
        conn.metadata["role"] = "node"
        with self._lock:
            self._node_conns[conn.conn_id] = node_id.binary()
        self._retry_pending_pgs()
        self._retry_infeasible()
        return {"ok": True}

    def _h_node_heartbeat(self, conn, msg):
        node_id = NodeID(msg["node_id"])
        info = self.control.nodes.get(node_id)
        if info is None:
            # Head restarted without state for this node (or the node
            # outlived a mark-dead): ask it to re-register + resync.
            return {"ok": False, "unknown_node": True}
        info.last_heartbeat = time.time()
        info.alive = True  # a heartbeating node is alive
        self.core_counters.bump("heartbeats")
        if "core_metrics" in msg:
            info.core_metrics = dict(msg["core_metrics"])
        version = int(msg.get("version", 0))
        if "available" in msg:
            # Payload present: apply + ack this version. Liveness-only
            # beats (unchanged state) leave the last snapshot in place.
            info.available = dict(msg.get("available") or {})
            info.queued = int(msg.get("queued", 0))
            # Totals change when placement-group bundles commit/release
            # (group resources are added to the node pool).
            total = msg.get("total")
            if total is not None:
                info.resources = dict(total)
            with self._lock:
                self._node_sync_versions[msg["node_id"]] = version
            acked = version
        else:
            with self._lock:
                acked = self._node_sync_versions.get(msg["node_id"], -1)
        # Parked tasks (forward raced a node death, or no feasible node
        # yet) and pending placement groups get another placement
        # attempt on the heartbeat tick.
        with self._hot_lock("heartbeat"):
            any_parked = bool(self._infeasible)
            any_pending_pg = any(
                e.state in ("PENDING", "RESCHEDULING")
                for e in self.pgs.values()
            )
        if any_pending_pg:
            self._retry_pending_pgs()
        if any_parked:
            self._retry_infeasible()
        with self._lock:
            logs_wanted = any(
                "log_lines" in chans
                for _, chans in self._log_subscribers.values()
            )
        return {
            "ok": True,
            "logs_wanted": logs_wanted,
            "acked_version": acked,
        }

    def _heartbeat_loop(self) -> None:
        # Versioned resource sync (reference: ray_syncer's versioned
        # resource messages, common/ray_syncer): the load snapshot only
        # rides the heartbeat when it CHANGED since the head's last
        # ack — an idle 1000-node cluster heartbeats liveness-only.
        version = 0
        last_acked = -1
        last_state = None
        beats = 0
        while not self._shutdown:
            try:
                state = (
                    self.scheduler.available().to_dict(),
                    self.scheduler.total().to_dict(),
                    self.scheduler.queued_count(),
                )
                if state != last_state:
                    version += 1
                    last_state = state
                kwargs = {
                    "node_id": self.node_id.binary(),
                    "version": version,
                    "timeout": 10.0,
                }
                if version != last_acked:
                    kwargs.update(
                        available=state[0], total=state[1],
                        queued=state[2],
                    )
                # Core metrics ride changed-state beats plus a slow
                # refresh tick, so idle nodes still stay liveness-only
                # on the wire most of the time (metric_defs docstring).
                if version != last_acked or beats % 20 == 0:
                    from .metric_defs import collect

                    kwargs["core_metrics"] = collect(self)
                beats += 1
                reply = self.head.call("node_heartbeat", **kwargs)
                if reply.get("acked_version") == version:
                    last_acked = version
                self._head_logs_wanted = bool(reply.get("logs_wanted"))
                if reply.get("unknown_node"):
                    last_acked = -1  # full snapshot after re-register
                    self._resync_with_head()
            except Exception:
                if self._shutdown:
                    return
                # Head connection lost — likely a head restart
                # (reference: raylet resync on HandleNotifyGCSRestart,
                # node_manager.cc:1189). Re-register and re-report our
                # live actors + sealed objects once it is back. The
                # (possibly new) head's view of our load is unknown,
                # so the next beat must carry the full snapshot.
                last_acked = -1
                try:
                    self._resync_with_head()
                except Exception:
                    pass
            # Reclaim arena reader pins of crashed/OOM-killed workers so
            # their slots become evictable again (plasma reclaims on
            # client disconnect; the serverless arena uses pid liveness).
            reap = getattr(self.store, "reap_dead_pins", None)
            if reap is not None:
                try:
                    reap()
                except Exception:
                    pass
            time.sleep(self.config.heartbeat_interval_s)

    def _resync_with_head(self) -> None:
        """Re-attach to a (possibly restarted) head: re-register this
        node and re-report locally-hosted actors and sealed objects so
        the head's directory is rebuilt (reference: raylet-side state
        report after HandleNotifyGCSRestart)."""
        self.head.call(
            "register_node",
            node_id=self.node_id.binary(),
            address=self.address,
            resources=self.resources,
            labels=self.labels,
            retries=5,
            timeout=10.0,
        )
        with self._lock:
            actors = [aid.binary() for aid in self.actor_hosts]
            objects = [
                (oid.binary(), entry.size)
                for oid, entry in self.objects.items()
                if entry.in_shm and entry.state == SEALED
            ]
        self.head.call(
            "node_resync",
            node_id=self.node_id.binary(),
            actors=actors,
            objects=objects,
            timeout=10.0,
        )
        with self._lock:
            has_subs = bool(self._log_subscribers)
        if has_subs:
            # A restarted head lost our relay subscription.
            self._ensure_log_relay()

    def _h_node_resync(self, conn, msg):
        """A worker node re-reports its live state after a head
        restart (head only)."""
        node_id = msg["node_id"]
        for actor_binary in msg.get("actors", ()):
            actor_id = ActorID(actor_binary)
            with self._lock:
                runtime = self.actor_runtimes.get(actor_id)
            if runtime is None or runtime.info.state == ACTOR_DEAD:
                continue
            with self._lock:
                runtime.node = node_id
                runtime.info.state = ACTOR_ALIVE
            self.control.update_actor_state(
                actor_id, ACTOR_ALIVE, node_id=NodeID(node_id)
            )
            self._wake_actor_addr_waiters(actor_id)
        with self._lock:
            for oid_binary, size in msg.get("objects", ()):
                entry = self._ensure_entry(ObjectID(oid_binary))
                entry.state = SEALED
                entry.size = size
                entry.locations.add(node_id)
        return {"ok": True}

    def _h_disconnect(self, conn: Connection, msg: dict):
        if self._shutdown:
            # Dying daemons must not report their own worker kills as
            # task failures — the head's node-death path owns recovery.
            return {}
        with self._lock:
            winfo = self.workers.pop(conn.conn_id, None)
            self.drivers.pop(conn.conn_id, None)
            dead_node = self._node_conns.pop(conn.conn_id, None)
            if winfo is not None:
                # Keep the registration-history set bounded: the spawn
                # watcher usually consumes the pid within a tick, but a
                # watch entry that expired before a slow registration
                # would otherwise pin the pid forever.
                self._registered_pids_ever.discard(winfo.pid)
        if winfo is not None:
            # A disconnecting worker provably registered — resolve any
            # still-pending spawn watch for its pid HERE, not via the
            # history set (which the line above just pruned): a
            # starved watcher that only woke after this disconnect
            # would otherwise see "exited, never registered" and count
            # a healthy short-lived worker as a startup crash.
            with self._spawn_watch_lock:
                self._spawn_watchlist[:] = [
                    e for e in self._spawn_watchlist
                    if e[0].pid != winfo.pid
                ]
        self._drop_log_subscriber(conn.conn_id)
        if dead_node is not None:
            self._on_node_death(dead_node)
            return {}
        if winfo is None:
            self._release_driver_leases(conn.conn_id)
            return {}
        # Worker died (reference: raylet detects worker death via the
        # socket, node_manager.cc:1089 publishes WorkerDeltaData).
        if winfo.leased_by is not None:
            # Leased worker died: free the lease's reservation; the
            # driver sees its direct connection break and handles
            # retry/failure submitter-side.
            with self._lock:
                lease_ids = [
                    lid
                    for lid, (wc, _) in self.leases.items()
                    if wc == conn.conn_id
                ]
            for lid in lease_ids:
                with self._lock:
                    self.leases.pop(lid, None)
                self.scheduler.release(lid)
            self._schedule()
        elif winfo.pinned_actor is not None:
            self._on_actor_worker_death(winfo)
        elif winfo.current_task is not None:
            self._on_task_worker_death(winfo)
        return {}

    def _h_ping(self, conn, msg):
        return {"ok": True, "node_id": self.node_id.binary()}

    # ------------------------------------------------------------------
    # direct task transport: worker leases + actor addresses
    # (reference: node_manager.cc:1807 HandleRequestWorkerLease;
    # the submitter-side protocol lives in _private/direct.py)
    # ------------------------------------------------------------------
    def _h_request_lease(self, conn, msg):
        """Lease an idle local worker to a driver. Queued through the
        LocalScheduler as a pseudo-task so resource accounting and
        FIFO fairness are shared with daemon-scheduled work."""
        if not self.is_head:
            # Drivers attach to the head (enforced at register); a
            # lease request reaching a worker node is out of contract.
            return {"unavailable": True}
        self.core_counters.bump("lease_requests")
        resources = dict(msg.get("resources") or {})
        request = ResourceSet(resources)
        if not request.fits_in(self.scheduler.total()):
            # Locally infeasible (possibly transiently, under PG
            # reservations): the daemon path owns placement then.
            return {"unavailable": True}
        with self._lock:
            self._lease_counter += 1
            lease_id = f"lease:{self._lease_counter}"
        spec = {
            "kind": "lease",
            "resources": resources,
            "needs_gpu": bool(msg.get("needs_gpu")),
            "_conn": conn,
            "_mid": msg["_mid"],
            "_driver": conn.conn_id,
            "_lease_id": lease_id,
        }
        # In a multi-node cluster an unserved lease must fail fast so
        # the driver's daemon path can spill the work to other nodes;
        # single-node it waits (workers free up or spawn).
        multinode = (
            self.is_head
            and self.control is not None
            and len(self.control.nodes) > 1
        )
        if multinode:
            spec["_deadline"] = time.time() + 1.0
            timer = threading.Timer(1.1, self._expire_lease_requests)
            timer.daemon = True
            timer.start()
        self.scheduler.enqueue(lease_id, request, spec)
        self._schedule()
        return DEFERRED

    def _expire_lease_requests(self) -> None:
        now = time.time()
        expired = self.scheduler.drain_queued(
            lambda s: s.get("kind") == "lease"
            and s.get("_deadline") is not None
            and s["_deadline"] < now
        )
        for spec in expired:
            spec["_conn"].reply(spec["_mid"], {"unavailable": True})

    def _h_release_lease(self, conn, msg):
        self._release_lease(msg["lease_id"])
        return {}

    def _release_lease(self, lease_id: str) -> None:
        with self._lock:
            entry = self.leases.pop(lease_id, None)
            if entry is None:
                return
            worker_conn_id, _ = entry
            worker = self.workers.get(worker_conn_id)
            if worker is not None:
                worker.leased_by = None
                worker.current_task = None
                worker.idle = True
                worker.idle_since = time.time()
        self.scheduler.release(lease_id)
        self._schedule()

    def _release_driver_leases(self, driver_conn_id: int) -> None:
        """Driver disconnected: return its leased workers and drop its
        queued lease requests."""
        with self._lock:
            held = [
                lid for lid, (_, drv) in self.leases.items()
                if drv == driver_conn_id
            ]
        for lid in held:
            self._release_lease(lid)
        dropped = self.scheduler.drain_queued(
            lambda s: s.get("kind") == "lease"
            and s.get("_driver") == driver_conn_id
        )
        if dropped:
            self._schedule()

    def _h_actor_address(self, conn, msg):
        """Resolve an actor's direct endpoint; defers until the actor
        leaves PENDING/RESTARTING. Empty reply = use the daemon path
        (remote node, dead, or no direct endpoint)."""
        if not self.is_head:
            # Never proxy: the head defers this reply until the actor
            # is ALIVE, and a blocking head.call here would wedge this
            # connection's dispatch thread (all RPC from that client)
            # behind actor creation. Drivers attach to the head, so a
            # request here is out of contract — daemon path.
            return {}
        actor_id = ActorID(msg["actor_id"])
        with self._lock:
            runtime = self.actor_runtimes.get(actor_id)
            if runtime is None or runtime.info.state == ACTOR_DEAD:
                return {}
            if runtime.info.state == ACTOR_ALIVE:
                return self._actor_address_reply(actor_id, runtime)
            self._actor_addr_waiters.setdefault(actor_id, []).append(
                (conn, msg["_mid"])
            )
        return DEFERRED

    def _actor_address_reply(self, actor_id, runtime) -> dict:
        """Caller holds the lock. ALIVE actor -> direct address if it
        is hosted by a local worker with an endpoint."""
        if runtime.node != self.node_id.binary():
            return {}
        host = self.actor_hosts.get(actor_id)
        if host is None or host.worker_conn_id is None:
            return {}
        worker = self.workers.get(host.worker_conn_id)
        if worker is None or not worker.direct_address:
            return {}
        return {
            "address": worker.direct_address,
            "worker_id": worker.worker_id.binary(),
        }

    def _wake_actor_addr_waiters(self, actor_id: ActorID) -> None:
        with self._lock:
            waiters = self._actor_addr_waiters.pop(actor_id, [])
            if not waiters:
                return
            runtime = self.actor_runtimes.get(actor_id)
            if runtime is None or runtime.info.state != ACTOR_ALIVE:
                reply = {}
            else:
                reply = self._actor_address_reply(actor_id, runtime)
        for conn, mid in waiters:
            conn.reply(mid, reply)

    # ------------------------------------------------------------------
    # node clients (head->node forwards, node->node pulls)
    # ------------------------------------------------------------------
    def _node_client(self, node_id: bytes) -> Optional[RpcClient]:
        with self._lock:
            client = self._node_clients.get(node_id)
        if client is not None:
            return client
        info = self.control.nodes.get(NodeID(node_id))
        if info is None or not info.alive:
            return None
        client = RpcClient(info.address)
        with self._lock:
            self._node_clients[node_id] = client
        return client

    def _peer_client(self, address: str) -> RpcClient:
        with self._lock:
            client = self._peer_clients.get(address)
        if client is None:
            client = RpcClient(address)
            with self._lock:
                self._peer_clients[address] = client
        return client

    # ------------------------------------------------------------------
    # KV (function/actor-class blobs — reference: GcsKvManager +
    # function_manager.py export/fetch protocol)
    # ------------------------------------------------------------------
    def _h_kv_put(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "kv_put", ns=msg.get("ns", ""), key=msg["key"],
                value=msg["value"], overwrite=msg.get("overwrite", True),
            )
        added = self.control.kv_put(
            msg.get("ns", ""), msg["key"], msg["value"],
            overwrite=msg.get("overwrite", True),
        )
        return {"added": added}

    def _h_kv_get(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "kv_get", ns=msg.get("ns", ""), key=msg["key"]
            )
        return {"value": self.control.kv_get(msg.get("ns", ""), msg["key"])}

    def _h_kv_del(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "kv_del", ns=msg.get("ns", ""), key=msg["key"]
            )
        self.control.kv_del(msg.get("ns", ""), msg["key"])
        return {}

    def _h_kv_keys(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "kv_keys", ns=msg.get("ns", ""),
                prefix=msg.get("prefix", ""),
            )
        return {
            "keys": self.control.kv_keys(
                msg.get("ns", ""), msg.get("prefix", "")
            )
        }

    # ------------------------------------------------------------------
    # objects — metadata (head) + local data plane (all nodes)
    # ------------------------------------------------------------------
    def _ensure_entry(self, oid: ObjectID) -> ObjectEntry:
        entry = self.objects.get(oid)
        if entry is None:
            entry = ObjectEntry()
            self.objects[oid] = entry
        return entry

    def _h_put_inline(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "put_inline", oid=msg["oid"], data=msg["data"],
                **self._owner_fwd(msg),
            )
        oid = ObjectID(msg["oid"])
        with self._lock:
            entry = self._ensure_entry(oid)
            entry.inline = msg["data"]
            entry.size = len(msg["data"])
            entry.state = SEALED
            self._record_owner(entry, msg, local_pid=False)
        self._wake(oid)
        self._schedule()
        return {}

    @staticmethod
    def _record_owner(
        entry: ObjectEntry, msg: dict, local_pid: bool
    ) -> None:
        """Adopt owner attribution from a seal/put report (caller
        holds the lock). First writer wins — a secondary copy's seal
        must not re-attribute the object — and the owner pid is only
        meaningful where the creating client actually runs
        (`local_pid`: the node that took the client's own report)."""
        if msg.get("owner_job") and not entry.owner_job:
            entry.owner_job = str(msg["owner_job"])
            entry.owner = str(msg.get("owner", "") or "")
            if local_pid:
                entry.owner_pid = int(msg.get("owner_pid") or 0)
        if not entry.created_ts:
            # A pulled secondary copy inherits the primary's creation
            # time (leak age anchors at first seal, not local arrival).
            entry.created_ts = float(
                msg.get("created_ts") or 0.0
            ) or time.time()

    @staticmethod
    def _owner_fwd(msg: dict) -> dict:
        """Owner-attribution fields of a seal/put report, for
        forwarding to the head."""
        return {
            k: msg[k]
            for k in ("owner_job", "owner", "owner_pid")
            if k in msg
        }

    def _h_object_sealed(self, conn, msg):
        """A shm object was sealed. From a local worker: record the
        local copy (and, on worker nodes, tell the head). From a node
        daemon (head only): record the remote location."""
        oid = ObjectID(msg["oid"])
        source_node = msg.get("node_id")  # set when a node reports
        with self._lock:
            entry = self._ensure_entry(oid)
            entry.size = msg["size"]
            entry.state = SEALED
            # Owner pid liveness is only probeable on the node the
            # creating client runs on — the node taking its direct
            # report (the head's directory copy keeps job/owner for
            # attribution, without the pid).
            self._record_owner(
                entry, msg, local_pid=source_node is None
            )
            if source_node is None:
                entry.in_shm = True  # sealed by a local client
            if self.is_head:
                entry.locations.add(source_node or self.node_id.binary())
        if source_node is None:
            # Primary copy: pin against eviction until spilled/deleted.
            self._pin_primary(oid, msg["size"])
        if not self.is_head and source_node is None:
            # Report our copy (with its attribution) to the head's
            # object directory.
            self.head.call(
                "object_sealed", oid=msg["oid"], size=msg["size"],
                node_id=self.node_id.binary(), **self._owner_fwd(msg),
            )
        self._wake(oid)
        self._schedule()
        return {}

    def _h_seal_error(self, conn, msg):
        if not self.is_head:
            reply = self.head.call(
                "seal_error", oid=msg["oid"], error=msg["error"]
            )
            # Also fail local waiters (workers blocked on this node).
            self._seal_error_local(ObjectID(msg["oid"]), msg["error"])
            self._schedule()  # errored deps count as resolved
            return reply
        self._seal_error_local(ObjectID(msg["oid"]), msg["error"])
        self._schedule()
        return {}

    def _seal_error(self, oid: ObjectID, error: bytes) -> None:
        """Mark an object as errored in the authoritative table."""
        if not self.is_head:
            try:
                self.head.call(
                    "seal_error", oid=oid.binary(), error=error
                )
            except RpcError:
                pass
        self._seal_error_local(oid, error)

    def _seal_error_local(self, oid: ObjectID, error: bytes) -> None:
        with self._lock:
            entry = self._ensure_entry(oid)
            entry.error = error
            entry.state = ERRORED
        self._wake(oid)

    def _object_reply_local(self, oid: ObjectID) -> Optional[dict]:
        """Reply for a local consumer, or None if data must be pulled."""
        with self._lock:
            entry = self.objects.get(oid)
            if entry is None or entry.state == PENDING:
                return {"pending": True}
            if entry.state == ERRORED:
                return {"error": entry.error}
            if entry.inline is not None:
                return {"inline": entry.inline}
            if entry.in_shm:
                reply = {"shm_size": entry.size}
                if entry.source_fresh and entry.source:
                    # Provenance rides the reply only while fresh so
                    # the worker can classify this get's wait; the
                    # flag clears once the materialising event's
                    # waiters have been answered.
                    reply["via"] = entry.source
                    if entry.src_node:
                        reply["src"] = entry.src_node
                return reply
        return None  # sealed, data elsewhere

    def _wake(self, oid: ObjectID) -> None:
        """Wake waiters that can now be answered; re-arm data waiters
        whose object is sealed but remote (pull in progress)."""
        with self._lock:
            entry = self.objects.get(oid)
            if entry is None:
                return
            waiters = entry.waiters
            entry.waiters = []
            meta_waiters = entry.meta_waiters
            entry.meta_waiters = []
        for conn, mid in meta_waiters:
            conn.reply(mid, self._meta_reply(oid))
        needs_pull = False
        for conn, mid in waiters:
            reply = self._object_reply_local(oid)
            if reply is None:
                with self._lock:
                    entry.waiters.append((conn, mid))
                needs_pull = True
            else:
                conn.reply(mid, reply)
        if needs_pull:
            self._ensure_local(oid)

    def _h_get_object(self, conn, msg):
        oid = ObjectID(msg["oid"])
        with self._lock:
            entry = self._ensure_entry(oid)
            if entry.state == PENDING:
                entry.waiters.append((conn, msg["_mid"]))
                if not self.is_head:
                    pull_needed = not entry.pulling
                else:
                    pull_needed = False
            else:
                pull_needed = False
        if pull_needed:
            # On worker nodes PENDING may just mean "not local yet":
            # ask the head (blocks until sealed) then pull.
            self._ensure_local(oid)
            return DEFERRED
        if entry.state == PENDING:
            return DEFERRED
        reply = self._object_reply_local(oid)
        if reply is None:
            with self._lock:
                entry.waiters.append((conn, msg["_mid"]))
            self._ensure_local(oid)
            return DEFERRED
        return reply

    def _h_get_objects(self, conn, msg):
        """Batched NON-BLOCKING get: one round trip resolves every oid
        the daemon can answer right now (the worker's many-arg fetch
        path — per-arg blocking gets cost one RTT each). Unready or
        remote oids come back as pending markers (a pull is kicked for
        sealed-elsewhere entries); the caller falls back to blocking
        get_object for those, which waits exactly like before."""
        out = []
        pulls = []
        oids = msg["oids"]
        # Chunked lock scope: a 10k-oid request must not pin the hot
        # lock for the whole scan.
        for start in range(0, len(oids), 512):
            with self._lock:
                for blob in oids[start:start + 512]:
                    oid = ObjectID(blob)
                    entry = self.objects.get(oid)
                    if entry is None or entry.state == PENDING:
                        out.append({"pending": True})
                    elif entry.state == ERRORED:
                        out.append({"error": entry.error})
                    elif entry.inline is not None:
                        out.append({"inline": entry.inline})
                    elif entry.in_shm:
                        reply = {"shm_size": entry.size}
                        if entry.source_fresh and entry.source:
                            reply["via"] = entry.source
                            if entry.src_node:
                                reply["src"] = entry.src_node
                        out.append(reply)
                    else:
                        pulls.append(oid)
                        out.append({"pending": True})
        for oid in pulls:
            self._ensure_local(oid)
        return {"results": out}

    def _meta_reply(self, oid: ObjectID) -> dict:
        """Metadata view served to node daemons (head only)."""
        with self._lock:
            entry = self.objects.get(oid)
            if entry is None or entry.state == PENDING:
                return {"pending": True}
            if entry.state == ERRORED:
                return {"error": entry.error}
            if entry.inline is not None:
                return {"inline": entry.inline}
            locations = []
            for nid in entry.locations:
                info = self.control.nodes.get(NodeID(nid))
                if info is not None and info.alive:
                    locations.append((nid, info.address))
            # Attribution rides the meta so a pulling node's secondary
            # copy lands in its arena already attributed (no pid: the
            # creator doesn't run there, liveness is unknowable).
            return {
                "size": entry.size,
                "locations": locations,
                "owner_job": entry.owner_job,
                "owner": entry.owner,
                "created_ts": entry.created_ts,
            }

    def _h_get_object_meta(self, conn, msg):
        oid = ObjectID(msg["oid"])
        with self._lock:
            entry = self._ensure_entry(oid)
            if entry.state == PENDING:
                entry.meta_waiters.append((conn, msg["_mid"]))
                return DEFERRED
        reply = self._meta_reply(oid)
        if reply.get("size") is not None and not reply["locations"]:
            # All copies lost: try lineage reconstruction, keep waiting.
            with self._lock:
                entry.meta_waiters.append((conn, msg["_mid"]))
            self._maybe_reconstruct(oid)
            return DEFERRED
        return reply

    def _h_pull_object(self, conn, msg):
        """Serve a chunk of a locally-stored object (reference:
        PushManager chunking, object_manager/push_manager.h)."""
        oid = ObjectID(msg["oid"])
        self.core_counters.bump("pushes")
        offset = msg.get("offset", 0)
        length = msg.get("length", self.config.object_transfer_chunk_size)
        with self._lock:
            entry = self.objects.get(oid)
            size = entry.size if entry is not None and entry.in_shm else None
        if getattr(self.store, "needs_release", False):
            pin = self.store.acquire(oid, timeout=0.1)
            if pin is None:
                return self._pull_from_spill(oid, offset, length)
            try:
                total = len(pin.view)
                view = pin.view[offset : min(offset + length, total)]
                # Zero-copy send: reply INSIDE the pin scope so the
                # chunk scatter-gathers straight from the arena onto
                # the socket (pickle-5 out-of-band buffer) — the
                # bytes() staging copy this replaces was one full
                # memcpy per transferred chunk. sendmsg has fully
                # handed the bytes to the kernel when reply returns,
                # so releasing the pin afterwards is safe.
                conn.reply(
                    msg["_mid"],
                    {"data": _oob_chunk(view), "total_size": total},
                )
                return DEFERRED
            finally:
                pin.release()
        view = self.store.get(oid, timeout=0.1)
        if view is None and size is not None:
            # Segment was created directly by a local worker process;
            # attach by name (plasma clients mmap by object id).
            try:
                view = self.store.open_remote(oid, size)
            except FileNotFoundError:
                view = None
        if view is None:
            return self._pull_from_spill(oid, offset, length)
        total = len(view)
        # Zero-copy: the numpy wrapper keeps the segment view (and its
        # pages) alive until the reply frame has been sent; per-object
        # segments are kernel-refcounted, so a concurrent delete only
        # unlinks the name.
        chunk = view[offset : min(offset + length, total)]
        return {"data": _oob_chunk(chunk), "total_size": total}

    def _pull_from_spill(self, oid: ObjectID, offset: int, length: int):
        """Serve a pull chunk straight from this node's spill file —
        remote reads need not restore the shm copy first."""
        if self.spill is not None and self.spill.contains(oid):
            data = self.spill.read(oid, offset, length)
            total = self.spill.size(oid)
            if data is not None and total is not None:
                # Marker lets the puller classify the transfer as a
                # remote spill restore rather than an arena pull.
                return {
                    "data": _oob_chunk(data),
                    "total_size": total,
                    "from_spill": True,
                }
        return {"missing": True}

    def _h_delete_object(self, conn, msg):
        """Head tells this node to drop its copy (refcount hit zero)."""
        oid = ObjectID(msg["oid"])
        with self._lock:
            self.objects.pop(oid, None)
        self._drop_local_copy(oid)
        return {}

    def _drop_local_copy(self, oid: ObjectID, in_shm: bool = True) -> None:
        """Release every local holding of one object: the primary pin,
        the shm segment (unlink_by_id also reaches segments created
        directly by local worker processes — the daemon never attached
        them), and any spill file."""
        self._unpin_primary(oid)
        if in_shm:
            self.store.unlink_by_id(oid)
        else:
            self.store.delete(oid)
        if self.spill is not None:
            self.spill.delete(oid)

    def _h_object_evicted(self, conn, msg):
        """A node evicted a cached copy under memory pressure — or, in
        the native-arena store, a local worker process whose create()
        triggered eviction (no node_id in that case)."""
        oid = ObjectID(msg["oid"])
        node_id = msg.get("node_id")
        if node_id is None:
            # Local worker eviction: shared arena means this node's
            # copy is gone; run the node-level eviction path.
            self._on_store_evict(oid)
            return {}
        with self._lock:
            entry = self.objects.get(oid)
            if entry is not None:
                entry.locations.discard(node_id)
        return {}

    def _on_store_evict(self, oid: ObjectID) -> None:
        with self._lock:
            entry = self.objects.get(oid)
            if entry is not None:
                entry.in_shm = False
                if entry.spilled:
                    # The spill file still serves this object from this
                    # node — keep the directory location alive.
                    return
        if self.is_head:
            with self._lock:
                if entry is not None:
                    entry.locations.discard(self.node_id.binary())
        elif self.head is not None:
            try:
                self.head.notify(
                    "object_evicted", oid=oid.binary(),
                    node_id=self.node_id.binary(),
                )
            except Exception:
                pass

    # ------------------------------------------------------------------
    # object spilling (reference: raylet LocalObjectManager,
    # local_object_manager.h:110 SpillObjectsOfSize; restore path
    # AsyncRestoreSpilledObject; storage external_storage.py:72)
    # ------------------------------------------------------------------
    _PIN_ABSENT = object()

    def _pin_primary(
        self, oid: ObjectID, size: int, pin=None
    ) -> None:
        """Pin a locally-sealed (primary) copy against eviction.
        `pin` carries a ready ArenaPin taken atomically at seal time
        (seal_pinned) — adopted instead of acquiring a fresh one.

        Entry protocol for self._primary_pins[oid]:
          absent       — unprotected
          None         — reservation: some thread is acquiring a pin
          pin object   — protected
        A ready pin FILLS a pending reservation (releasing it there
        would reopen the zero-pin eviction window while the reserver
        is still acquiring); the reserver only installs its own pin if
        the entry is still its empty reservation, else releases it.
        """
        with self._lock:
            existing = self._primary_pins.get(oid, self._PIN_ABSENT)
            if existing is None:
                # Pending reservation from another thread.
                if pin is not None:
                    self._primary_pins[oid] = pin  # fill it
                return  # (reserver will see the fill and stand down)
            if existing is not self._PIN_ABSENT:
                if pin is not None:
                    self._release_pin(pin)  # truly already protected
                return
            self._primary_pins[oid] = pin  # pin, or None = reservation
            if pin is not None:
                return
        # We hold the empty reservation: acquire outside the lock.
        if getattr(self.store, "needs_release", False):
            pin = self.store.acquire(oid, timeout=0)
        else:
            if not self.store.contains(oid):
                try:
                    self.store.open_remote(oid, size)
                except FileNotFoundError:
                    with self._lock:
                        if self._primary_pins.get(oid) is None:
                            self._primary_pins.pop(oid, None)
                    return
            self.store.pin(oid)
            pin = oid  # marker: pinned in the py store
        stale = False
        with self._lock:
            current = self._primary_pins.get(oid, self._PIN_ABSENT)
            if current is None:
                # Still our empty reservation.
                if pin is None:
                    self._primary_pins.pop(oid, None)
                else:
                    self._primary_pins[oid] = pin
            else:
                # Deleted concurrently (absent) or a seal-time pin
                # filled the reservation first — our pin is surplus.
                stale = True
        if stale and pin is not None:
            self._release_pin(pin)

    def _release_pin(self, pin) -> None:
        if getattr(self.store, "needs_release", False):
            try:
                pin.release()
            except Exception:
                pass
        else:
            self.store.unpin(pin)  # py-store marker IS the oid

    def _unpin_primary(self, oid: ObjectID) -> None:
        with self._lock:
            pin = self._primary_pins.pop(oid, None)
        if pin is None:
            return
        if getattr(self.store, "needs_release", False):
            try:
                pin.release()
            except Exception:
                pass
        else:
            self.store.unpin(oid)

    # ------------------------------------------------------------------
    # log streaming (reference: _private/log_monitor.py — tail worker
    # log files, publish line batches; driver prints with prefixes)
    # ------------------------------------------------------------------
    def _on_head_push(self, channel: str, msg: dict) -> None:
        """Pushes arriving on the node->head client connection: relayed
        pubsub events (log batches, error events, future channels) for
        this node's local subscribers."""
        if channel:
            msg = {
                k: v for k, v in msg.items()
                if k not in ("_mid", "_push")
            }
            self._push_to_subscribers(channel, msg)

    def _on_head_reconnect(self) -> None:
        """Per-connection head state must be re-established after a
        transparent RpcClient reconnect."""
        with self._lock:
            has_subs = bool(self._log_subscribers)
        if has_subs:
            self._ensure_log_relay()

    def _h_subscribe_logs(self, conn, msg):
        """Subscribe this connection to pushed pubsub channels
        ("log_lines" worker output, "error_event" cluster failures).
        The conn may be a local driver OR (on the head) a worker-node
        daemon relaying for its own local drivers."""
        channels = set(msg.get("channels") or ("log_lines",))
        with self._lock:
            prev = self._log_subscribers.get(conn.conn_id)
            if prev is not None:
                channels |= prev[1]
            self._log_subscribers[conn.conn_id] = (conn, channels)
        if not self.is_head and self.head is not None:
            # Relay: all events flow through the head (every node
            # forwards there), so a driver attached to a non-head node
            # sees cluster-wide traffic by this node subscribing
            # upstream for the union of its local channels.
            self._ensure_log_relay()
        return {}

    def _ensure_log_relay(self) -> None:
        with self._lock:
            union = set()
            for _, chans in self._log_subscribers.values():
                union |= chans
        try:
            self.head.notify("subscribe_logs", channels=sorted(union))
        except Exception:
            pass

    def _h_unsubscribe_logs(self, conn, msg):
        self._drop_log_subscriber(conn.conn_id)
        return {}

    def _drop_log_subscriber(self, conn_id: int) -> None:
        """Remove one subscriber; when a relay node's LAST local
        subscriber goes, tear the upstream relay down too — otherwise
        one past driver session would keep the whole cluster tailing
        and forwarding forever."""
        with self._lock:
            was_sub = self._log_subscribers.pop(conn_id, None) is not None
            any_left = bool(self._log_subscribers)
        if (
            was_sub
            and not any_left
            and not self.is_head
            and self.head is not None
        ):
            try:
                self.head.notify("unsubscribe_logs")
            except Exception:
                pass

    def _h_log_batch(self, conn, msg):
        """A worker node forwards its tailed log lines (head only)."""
        self._push_logs(msg["batches"], msg.get("node", ""))
        return {}

    def _h_publish_event(self, conn, msg):
        """A worker node forwards a pubsub event for head fan-out."""
        self._push_to_subscribers(msg["channel"], msg["payload"])
        return {}

    def _push_to_subscribers(self, channel: str, payload: dict) -> None:
        """Fan one event out to every subscriber of `channel` (shared
        by log batches and error events; pop subscribers whose
        connection died)."""
        with self._lock:
            subs = [
                (cid, conn)
                for cid, (conn, chans) in self._log_subscribers.items()
                if channel in chans
            ]
        for conn_id, conn in subs:
            try:
                conn.push(channel, payload)
            except Exception:
                with self._lock:
                    self._log_subscribers.pop(conn_id, None)

    def _push_logs(self, batches: list, node: str) -> None:
        # Known limitation vs the reference's per-job log_monitor
        # filtering: workers here are shared across jobs, so a stdout
        # line has no reliable job attribution — every subscriber gets
        # every line (prefixed by worker/pid/node). Multi-driver
        # sessions wanting isolation set log_to_driver=False and read
        # session-dir files.
        self._push_to_subscribers(
            "log_lines", {"batches": batches, "node": node}
        )

    def _logs_wanted(self) -> bool:
        """Whether anyone, anywhere, wants this node's log lines."""
        with self._lock:
            local = any(
                "log_lines" in chans
                for _, chans in self._log_subscribers.values()
            )
        if local:
            return True
        # Worker nodes learn via the heartbeat reply whether the head
        # has subscribers (drivers or node relays).
        return (not self.is_head) and self._head_logs_wanted

    def _log_monitor_loop(self) -> None:
        offsets: Dict[str, int] = {}
        node_hex = self.node_id.hex()[:8]
        while not self._shutdown:
            try:
                if not self._logs_wanted():
                    # Nobody listening: skip the tail work but keep
                    # offsets at EOF so a new subscriber gets a live
                    # stream, not a history dump.
                    self._fast_forward_logs(offsets)
                else:
                    batches = self._tail_worker_logs(offsets)
                    if batches:
                        if self.is_head:
                            self._push_logs(batches, node_hex)
                        elif self.head is not None:
                            # Single path: batches go up to the head,
                            # which fans out to drivers and node
                            # relays (including back to this node if a
                            # local driver subscribed) — no double
                            # delivery.
                            self.head.notify(
                                "log_batch", batches=batches,
                                node=node_hex,
                            )
            except Exception:
                pass
            time.sleep(self.config.log_monitor_interval_s)

    def _fast_forward_logs(self, offsets: Dict[str, int]) -> None:
        for i in range(len(self._worker_procs)):
            path = os.path.join(self.session_dir, f"worker-{i}.out")
            try:
                offsets[path] = os.path.getsize(path)
            except OSError:
                pass

    def _tail_worker_logs(self, offsets: Dict[str, int]) -> list:
        """Read complete new lines from each worker's log file."""
        batches = []
        for i, proc in enumerate(list(self._worker_procs)):
            path = os.path.join(self.session_dir, f"worker-{i}.out")
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = offsets.get(path, 0)
            if size <= off:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(min(size - off, 256 * 1024))
            except OSError:
                continue
            nl = data.rfind(b"\n")
            if nl < 0:
                # No complete line yet; flush anyway if the partial
                # line is absurdly long so progress can't stall.
                if len(data) < 64 * 1024:
                    continue
                nl = len(data) - 1
            chunk, consumed = data[: nl + 1], nl + 1
            offsets[path] = off + consumed
            batches.append({
                "worker": i,
                "pid": proc.pid,
                "lines": chunk.decode(errors="replace").splitlines(),
            })
        return batches

    def _maintenance_loop(self) -> None:
        """Periodic store upkeep on EVERY daemon (the head included —
        worker nodes additionally reap via their heartbeat loop):
        reclaim arena pins of crashed/killed reader processes, then
        spill under pressure. A dead reader's pin otherwise defers
        deletion forever and leaks the slot."""
        while not self._shutdown:
            # Reap zombie worker children FIRST: a SIGKILLed worker
            # stays a zombie until waitpid, and the arena's pid-liveness
            # check (kill(pid, 0)) reports zombies as alive — its pins
            # would defer slot frees forever.
            for proc in list(self._worker_procs):
                try:
                    proc.poll()
                except Exception:
                    pass
            reap = getattr(self.store, "reap_dead_pins", None)
            if reap is not None:
                try:
                    reap()
                except Exception:
                    pass
            try:
                self._maybe_spill()
            except Exception:
                pass
            try:
                self._reap_idle_workers()
            except Exception:
                pass
            time.sleep(self.config.object_eviction_check_interval_s)

    #: Idle workers beyond the pool cap live this long before exiting.
    _IDLE_WORKER_GRACE_S = 5.0

    def _reap_idle_workers(self) -> None:
        """Shrink the warm pool back to worker_pool_max_idle_workers
        (reference: WorkerPool TryKillingIdleWorkers,
        worker_pool.cc — idle workers past the cap are asked to exit
        after a grace period). Leased and actor-pinned workers never
        count as idle."""
        cap = self.config.worker_pool_max_idle_workers or max(
            1, int(self.resources.get("CPU", 1))
        )
        now = time.time()
        with self._lock:
            idle = [
                w for w in self.workers.values()
                if w.idle
                and w.pinned_actor is None
                and w.leased_by is None
            ]
            excess = len(idle) - cap
            if excess <= 0:
                return
            idle.sort(key=lambda w: w.idle_since)  # oldest first
            victims = [
                w for w in idle[:excess]
                if now - w.idle_since > self._IDLE_WORKER_GRACE_S
            ]
            for w in victims:
                # Unschedulable from the same critical section that
                # selected it: a dispatch racing the exit push would
                # otherwise land a task on a dying worker and surface
                # a spurious WorkerCrashedError.
                w.idle = False
        for w in victims:
            try:
                w.conn.push("exit", {})
            except Exception:
                pass

    def _h_spill_request(self, conn, msg):
        """A local worker hit store-full on create: synchronously free
        space by spilling (reference: plasma's create retries after the
        raylet spills, create_request_queue.h)."""
        freed = self._maybe_spill(bytes_needed=msg.get("bytes_needed", 0))
        return {"freed": freed}

    def _maybe_spill(self, bytes_needed: int = 0) -> int:
        """Spill LRU sealed objects until store usage is back under the
        spilling threshold (plus `bytes_needed` headroom). Returns the
        number of bytes freed from the store."""
        if self.spill is None:
            return 0
        with self._spill_lock:
            info = self.store.size_info()
            high = self.config.object_spilling_threshold * info["capacity"]
            target = info["used"] + bytes_needed - high
            if target <= 0:
                return 0
            with self._lock:
                # Insertion order approximates LRU: oldest sealed local
                # objects first. Inline and unsealed objects are not
                # spillable; errored ones have no data.
                victims = [
                    (oid, e.size)
                    for oid, e in self.objects.items()
                    if e.in_shm and e.state == SEALED and e.inline is None
                ]
            freed = 0
            for oid, size in victims:
                if freed >= target:
                    break
                if self._spill_one(oid, size):
                    freed += size
            return freed

    def _spill_one(self, oid: ObjectID, size: int) -> bool:
        """Write one object's bytes to spill storage, then drop its shm
        copy. The head keeps this node in the object's location set —
        the spill file serves pulls and restores."""
        try:
            if getattr(self.store, "needs_release", False):
                pin = self.store.acquire(oid, timeout=0)
                if pin is None:
                    return False
                try:
                    self.spill.spill(oid, pin.view)
                finally:
                    pin.release()
            else:
                view = self.store.get(oid, timeout=0)
                if view is None:
                    # Segment created by a local worker process; attach.
                    try:
                        view = self.store.open_remote(oid, size)
                    except FileNotFoundError:
                        return False
                self.spill.spill(oid, view)
        except Exception:
            return False
        with self._lock:
            entry = self.objects.get(oid)
            if entry is None:
                # Deleted concurrently; drop the orphan file.
                self.spill.delete(oid)
                return False
            entry.spilled = True
            entry.in_shm = False
            job = entry.owner_job
        self._unpin_primary(oid)
        self.store.unlink_by_id(oid)
        self.core_counters.bump("spills")
        self._bump_job_op(self._job_spill_ops, job)
        return True

    def _bump_job_op(self, table: Dict[str, int], job: str) -> None:
        """Count one spill/restore op against a job on THIS node
        (""-keyed when unattributed); cumulative, shipped with the
        node memory report."""
        with self._lock:
            table[job] = table.get(job, 0) + 1

    def _report_transfer(
        self, job: str, src: str, kind: str, nbytes: int, ms: float
    ) -> None:
        """Bill one completed (or aborted) data movement INTO this
        node against the (job, src, dst) flow. Rides the metrics pipe
        like step records — the head folds its own directly, a worker
        node piggybacks one notify per pull/restore OP (never one per
        get; gets aggregate worker-side)."""
        if self.config.transfer_report_interval_s <= 0:
            return
        rec = (
            "transfer",
            kind,
            float(nbytes),
            (
                ("dst", self.node_id.hex()),
                ("job", job or ""),
                ("ms", str(round(ms, 3))),
                ("src", src),
            ),
        )
        if self.is_head:
            with self._lock:
                self._apply_metric_record(rec)
        elif self.head is not None:
            try:
                # No (sender, seq): a lost notify costs one record,
                # not a double-count — transfer ops are rare enough
                # (per pull, not per get) that dedup bookkeeping
                # isn't worth a synchronous call on the pull path.
                self.head.notify("metrics_record", records=[rec])
            except Exception:
                pass

    def _restore_spilled(self, oid: ObjectID) -> bool:
        """Copy a spilled object back into the shm store so local
        consumers map it zero-copy again."""
        if self.spill is None:
            return False
        t0 = time.perf_counter()
        data = self.spill.read(oid)
        if data is None:
            return False
        pin = None

        def _put_pinned():
            # seal_pinned (arena) closes the window where the restored
            # copy is sealed but not yet primary-pinned and a foreign
            # create() LRU-evicts it again.
            buf = self.store.create(oid, len(data))
            buf[: len(data)] = data
            seal_pinned = getattr(self.store, "seal_pinned", None)
            if seal_pinned is not None:
                return seal_pinned(oid)
            self.store.seal(oid)
            return None

        try:
            try:
                pin = _put_pinned()
            except ObjectStoreFullError:
                # Make room by spilling colder objects, then retry once.
                self._maybe_spill(bytes_needed=len(data))
                pin = _put_pinned()
        except ValueError:
            pass  # already (re-)created by a concurrent restore
        except ObjectStoreFullError:
            return False
        with self._lock:
            entry = self._ensure_entry(oid)
            entry.in_shm = True
            entry.size = len(data)
            entry.state = SEALED
            # Provenance: waiters woken by this restore classify their
            # wait as a spill restore, not an arena hit.
            entry.source = "restore"
            entry.src_node = ""
            entry.source_fresh = True
            job = entry.owner_job
            if self.is_head:
                entry.locations.add(self.node_id.binary())
        self._pin_primary(oid, len(data), pin=pin)
        self.core_counters.bump("restores")
        self._bump_job_op(self._job_restore_ops, job)
        self._report_transfer(
            job, self.node_id.hex(), "restore", len(data),
            (time.perf_counter() - t0) * 1000.0,
        )
        return True

    # -- cross-node pull -------------------------------------------------
    def _ensure_local(self, oid: ObjectID) -> None:
        """Asynchronously make a sealed object's data local to this
        node (reference: PullManager, object_manager/pull_manager.h)."""
        with self._lock:
            entry = self._ensure_entry(oid)
            if entry.pulling or entry.in_shm or entry.inline is not None:
                return
            if entry.state == ERRORED:
                return
            entry.pulling = True
        threading.Thread(
            target=self._pull_worker, args=(oid,), daemon=True,
            name=f"pull:{oid.hex()[:8]}",
        ).start()

    def _pull_worker(self, oid: ObjectID) -> None:
        try:
            self._pull_once(oid)
        finally:
            with self._lock:
                entry = self.objects.get(oid)
                if entry is not None:
                    entry.pulling = False
            self._wake(oid)
            # Waiters answered: later gets of the (now warm) copy are
            # plain local arena hits, not pull/restore waits.
            with self._lock:
                entry = self.objects.get(oid)
                if entry is not None:
                    entry.source_fresh = False
            self._schedule()

    def _pull_once(self, oid: ObjectID) -> None:
        # Restore-from-spill fast path: the data never left this node's
        # disk (reference: AsyncRestoreSpilledObject before remote pull,
        # local_object_manager.h).
        if (
            self.spill is not None
            and self.spill.contains(oid)
            and self._restore_spilled(oid)
        ):
            return
        for attempt in range(5):
            if self.is_head:
                meta = self._meta_reply(oid)
            else:
                try:
                    # retries: a transiently dropped meta RPC (chaos
                    # injection, head failover blip) must not abandon
                    # the pull — nothing re-arms it until an unrelated
                    # seal event.
                    meta = self.head.call(
                        "get_object_meta", oid=oid.binary(), retries=3
                    )
                except RpcError:
                    return
            if meta.get("error") is not None:
                self._seal_error_local(oid, meta["error"])
                return
            if meta.get("inline") is not None:
                with self._lock:
                    entry = self._ensure_entry(oid)
                    entry.inline = meta["inline"]
                    entry.size = len(meta["inline"])
                    entry.state = SEALED
                return
            if meta.get("pending"):
                # Head path only (node meta call blocks until sealed):
                # object not produced yet; waiters stay armed.
                return
            size = meta["size"]
            locations = [
                (nid, addr)
                for nid, addr in meta["locations"]
                if nid != self.node_id.binary()
            ]
            if not locations:
                # A local spill file outranks reconstruction: an earlier
                # restore may have failed only because the store was
                # momentarily too full (finding: restore-fail must not
                # look like data loss while the bytes sit on this disk).
                if (
                    self.spill is not None
                    and self.spill.contains(oid)
                ):
                    if self._restore_spilled(oid):
                        return
                    time.sleep(0.2 * (attempt + 1))
                    continue
                if self.is_head:
                    self._maybe_reconstruct(oid)
                    return
                time.sleep(0.2 * (attempt + 1))
                continue
            # Random source among ALL copy holders: N nodes pulling the
            # same object spread across each other as copies appear
            # instead of serializing on the owner (reference intent:
            # PushManager broadcast; here an organic pull tree).
            import random as _random

            nid, addr = _random.choice(locations)
            t0 = time.perf_counter()
            from_spill = False
            if self._pull_same_host(nid, oid, size):
                pulled = True
            else:
                client = (
                    self._node_client(nid) if self.is_head
                    else self._peer_client(addr)
                )
                if client is None:
                    continue
                pulled, from_spill = self._pull_chunks(
                    client, oid, size
                )
            pull_ms = (time.perf_counter() - t0) * 1000.0
            src_hex = NodeID(nid).hex()
            if not pulled:
                # The aborted attempt is COUNTED against the flow but
                # its bytes are never billed as transferred (the
                # ledger's "aborted" kind only bumps the op count) —
                # a retry that succeeds bills the full size exactly
                # once.
                self._report_transfer(
                    meta.get("owner_job", ""), src_hex, "aborted",
                    size, pull_ms,
                )
            if pulled:
                # from_spill is None when no bytes actually moved (a
                # concurrent pull won the race) — the winner already
                # billed the transfer and stamped provenance.
                kind = "pull_spill" if from_spill else "pull"
                with self._lock:
                    entry = self._ensure_entry(oid)
                    entry.in_shm = True
                    entry.size = size
                    entry.state = SEALED
                    if from_spill is not None:
                        # Provenance for waiters: a spill-served pull
                        # is a remote restore, an arena-served one a
                        # plain pull.
                        entry.source = kind
                        entry.src_node = src_hex
                        entry.source_fresh = True
                    # The secondary copy fills THIS node's arena: carry
                    # the owner from the meta so the memory ledger can
                    # attribute the bytes here too.
                    self._record_owner(entry, meta, local_pid=False)
                    if self.is_head:
                        entry.locations.add(self.node_id.binary())
                if from_spill is not None:
                    self._report_transfer(
                        meta.get("owner_job", ""), src_hex, kind,
                        size, pull_ms,
                    )
                if not self.is_head:
                    try:
                        self.head.call(
                            "object_sealed", oid=oid.binary(), size=size,
                            node_id=self.node_id.binary(),
                        )
                    except RpcError:
                        pass
                return
        # Exhausted retries: leave waiters armed; a future seal or
        # location report re-wakes them.

    def _pull_same_host(
        self, src_nid: bytes, oid: ObjectID, size: int
    ) -> bool:
        """Same-host transfer: attach the source daemon's shared
        arena and copy the slot under a pin — one memcpy, no sockets
        (reference: plasma hands same-host clients the store mmap and
        only the object manager moves bytes over the network,
        object_manager/object_manager.h; two daemons on one host are
        'network peers' only in topology, not in memory). Falls back
        to chunked socket pulls when the source's arena file isn't on
        this machine, the store isn't the native arena, or the object
        vanished (eviction race)."""
        if not getattr(self.store, "needs_release", False):
            return False  # py store: per-object segments, socket path
        path = f"/dev/shm/rt_arena_{NodeID(src_nid).hex()[:8]}"
        if not os.path.exists(path):
            return False  # different host (or source gone)
        from .object_store import ArenaPin

        try:
            arena = self._peer_arenas.get(path)
            if arena is None:
                from .._native import NativeArena

                arena = NativeArena.attach(path)
                self._peer_arenas[path] = arena  # rt: noqa[RT201] — worst case is a duplicate NativeArena.attach of the same file (harmless); shutdown() only overlaps at process exit
            pinned = arena.try_pin(oid.binary())
        except Exception:
            return False
        if pinned is None:
            return False  # evicted at the source: retry via meta
        index, view = pinned
        pin = ArenaPin(arena, view, index)
        try:
            if len(view) != size:
                return False  # stale metadata; let the socket path sort it
            if self.store.contains(oid):
                return True
            try:
                buf = self.store.create(oid, size)
            except ValueError:
                return True  # concurrent pull won
            except Exception:
                return False
            buf[:size] = view
            self.store.seal(oid)
            return True
        finally:
            pin.release()

    def _pull_chunks(
        self, client: RpcClient, oid: ObjectID, size: int
    ) -> Tuple[bool, Optional[bool]]:
        """Transfer one object with a WINDOW of chunk requests in
        flight (reference: PushManager streams chunks concurrently
        under an in-flight cap, push_manager.h). The serial
        request-per-chunk loop this replaces was latency-bound: a
        cross-node 1 GiB transfer paid one RTT per 5 MiB.

        Returns ``(ok, from_spill)``; ``from_spill`` is True when the
        source served the bytes from its spill file rather than its
        arena, and None when no bytes moved at all (already local or a
        concurrent pull won) so the caller must not bill a transfer."""
        if self.store.contains(oid):
            return True, None
        chunk_size = self.config.object_transfer_chunk_size
        try:
            buf = self.store.create(oid, size)
        except ValueError:
            return True, None  # concurrent pull won
        except Exception:
            return False, None
        self.core_counters.bump("pulls")
        self.core_counters.bump(
            "pull_chunks", max(1, -(-size // chunk_size))
        )
        window = max(1, min(
            8,
            self.config.object_pull_max_bytes_in_flight // chunk_size,
        ))
        n_chunks = max(1, -(-size // chunk_size))
        lock = threading.Lock()
        done = threading.Event()
        state = {
            "next": 0, "inflight": 0, "completed": 0,
            "err": None, "aborted": False, "from_spill": False,
        }

        def plan_launches_locked() -> list:
            """Reserve the next chunk requests (caller holds lock)."""
            planned = []
            while (
                state["inflight"] < window
                and state["next"] < n_chunks
                and state["err"] is None
            ):
                idx = state["next"]
                state["next"] += 1
                state["inflight"] += 1
                off = idx * chunk_size
                planned.append((off, min(chunk_size, size - off)))
            return planned

        def issue(planned: list) -> None:
            # MUST run with the lock released: call_async invokes the
            # callback synchronously on this same thread when the
            # client is closed or the send hits ConnectionLost, and
            # the callback takes the (non-reentrant) lock.
            for off, length in planned:
                client.call_async(
                    "pull_object", _make_cb(off, length),
                    oid=oid.binary(), offset=off, length=length,
                )

        def _make_cb(off, length):
            def cb(reply):
                planned = []
                with lock:
                    state["inflight"] -= 1
                    if reply.get("from_spill"):
                        state["from_spill"] = True
                    if state["aborted"]:
                        pass  # buffer may already be gone; drop it
                    elif state["err"] is None:
                        data = reply.get("data")
                        if (
                            reply.get("_error")
                            or reply.get("missing")
                            or data is None
                            or len(data) == 0
                        ):
                            state["err"] = reply.get(
                                "_error", "source missing object/chunk"
                            )
                        elif len(data) != length:
                            # A short chunk means the source's copy
                            # disagrees with the metadata size; sealing
                            # would serve a zero-filled hole.
                            state["err"] = (
                                f"short chunk at {off}: "
                                f"{len(data)} != {length}"
                            )
                        else:
                            try:
                                buf[off : off + length] = data
                                state["completed"] += 1
                            except Exception as e:  # released buffer
                                state["err"] = str(e)
                    finished = state["completed"] == n_chunks
                    failed = (
                        state["err"] is not None
                        and state["inflight"] == 0
                    )
                    if finished or failed:
                        done.set()
                    elif state["err"] is None:
                        planned = plan_launches_locked()
                issue(planned)
            return cb

        with lock:
            first = plan_launches_locked()
        issue(first)
        # Overall deadline scales with size (floor 60s); a wedged
        # source fails the pull instead of hanging the waiter forever.
        deadline = 60.0 + size / (1 * 1024 * 1024)
        if not done.wait(timeout=deadline):
            with lock:
                state["err"] = "pull timed out"
                state["aborted"] = True
        ok = state["err"] is None and state["completed"] == n_chunks
        if not ok:
            with lock:
                state["aborted"] = True
            self.store.delete(oid)
            # Mid-flight death of the source (or eviction under it) is
            # counted distinctly; the caller reports the flow-level
            # "aborted" record (bytes never billed as transferred).
            self.core_counters.bump("pulls_aborted")
            return False, state["from_spill"]
        self.store.seal(oid)
        return True, state["from_spill"]

    # -- wait ------------------------------------------------------------
    def _h_wait_objects(self, conn, msg):
        if not self.is_head:
            mid = msg["_mid"]

            def proxy():
                try:
                    reply = self.head.call(
                        "wait_objects", oids=msg["oids"],
                        num_returns=msg["num_returns"],
                        wait_timeout=msg.get("wait_timeout"),
                    )
                except RpcError as e:
                    reply = {"_error": str(e)}
                conn.reply(mid, reply)

            threading.Thread(target=proxy, daemon=True).start()
            return DEFERRED
        oids = [ObjectID(b) for b in msg["oids"]]
        num_returns = msg["num_returns"]
        timeout = msg.get("wait_timeout")
        state = {"done": False}

        def check_and_reply(force: bool = False):
            with self._lock:
                if state["done"]:
                    return
                ready = [
                    o.binary()
                    for o in oids
                    if self.objects.get(o) is not None
                    and self.objects[o].state != PENDING
                ]
                if len(ready) >= num_returns or force:
                    state["done"] = True
                    remaining = [
                        o.binary() for o in oids if o.binary() not in set(ready)
                    ]
                    conn.reply(
                        msg["_mid"], {"ready": ready, "remaining": remaining}
                    )

        with self._lock:
            for o in oids:
                entry = self._ensure_entry(o)
                if entry.state == PENDING:
                    entry.waiters.append(
                        (_CallbackConn(check_and_reply), None)
                    )
        if timeout is not None:
            threading.Timer(timeout, lambda: check_and_reply(force=True)).start()
        check_and_reply()
        return DEFERRED

    # -- refcounting -----------------------------------------------------
    def _h_add_ref(self, conn, msg):
        if not self.is_head:
            self.head.notify("add_ref", oids=msg["oids"])
            return {}
        with self._lock:
            for b in msg["oids"]:
                self._ensure_entry(ObjectID(b)).refcount += 1
        return {}

    def _h_del_ref(self, conn, msg):
        if not self.is_head:
            self.head.notify("del_ref", oids=msg["oids"])
            return {}
        to_delete = []
        with self._lock:
            for b in msg["oids"]:
                oid = ObjectID(b)
                entry = self.objects.get(oid)
                if entry is None:
                    continue
                entry.refcount -= 1
                if entry.refcount <= 0 and entry.state != PENDING:
                    remote_locs = [
                        nid for nid in entry.locations
                        if nid != self.node_id.binary()
                    ]
                    to_delete.append((oid, entry.in_shm, remote_locs))
                    del self.objects[oid]
        for oid, in_shm, remote_locs in to_delete:
            self._drop_local_copy(oid, in_shm=in_shm)
            for nid in remote_locs:
                client = self._node_client(nid)
                if client is not None:
                    try:
                        client.notify("delete_object", oid=oid.binary())
                    except Exception:  # rt: noqa[RT007] — best-effort fanout to a maybe-dead node; nothing to reply
                        pass
        return {}

    # ------------------------------------------------------------------
    # task pinning helpers (head only — the head owns refcounts)
    # ------------------------------------------------------------------
    def _pin_args(self, spec: dict) -> None:
        """Hold a reference on every ObjectRef argument for the task's
        lifetime so caller-side handle drops can't delete an object a
        queued task still needs (reference: ReferenceCounter pins
        submitted-task arguments, reference_count.h)."""
        with self._lock:
            for kind, payload in spec["args"]:
                if kind == "ref":
                    self._ensure_entry(ObjectID(payload)).refcount += 1

    def _unpin_creation_args(self, runtime: ActorRuntime) -> None:
        """Release an actor's creation-task args exactly once, when the
        actor can no longer restart."""
        with self._lock:
            if runtime.creation_unpinned:
                return
            runtime.creation_unpinned = True
        self._unpin_args(runtime.creation_spec)

    def _unpin_args(self, spec: dict) -> None:
        self._h_del_ref(
            None,
            {
                "oids": [
                    payload
                    for kind, payload in spec["args"]
                    if kind == "ref"
                ]
            },
        )

    # ------------------------------------------------------------------
    # task submission + cluster placement (head)
    # ------------------------------------------------------------------
    def _node_views(self) -> List[NodeView]:
        views = []
        mine = self.node_id.binary()
        for info in self.control.alive_nodes():
            nid = info.node_id.binary()
            if nid == mine:
                avail = self.scheduler.available()
                total = self.scheduler.total()
            else:
                avail = ResourceSet(info.available)
                total = ResourceSet(info.resources)
            views.append(
                NodeView(
                    node_id=nid,
                    total=total,
                    available=avail,
                    labels=info.labels,
                    is_local=(nid == mine),
                )
            )
        return views

    def _submit_cluster(self, spec: dict, schedule: bool = True) -> None:
        """Place a task spec on a node (head only). Infeasible specs
        wait for the cluster to change (reference: tasks queue until
        resources exist). `schedule=False` defers the local dispatch
        pass to the caller — batch ingestion runs ONE pass per batch
        instead of one per spec."""
        task_id = TaskID(spec["task_id"])
        request = ResourceSet(spec.get("resources", {}))
        target = self._policy.pick(
            self._node_views(), request, spec.get("scheduling_strategy")
        )
        if target is None:
            with self._lock:
                self._infeasible[task_id] = spec
            self._record_task_event(spec, "PENDING_NODE_ASSIGNMENT")
            return
        with self._lock:
            entry = self.tasks.get(task_id)
            if entry is not None:
                entry.node = target
            if spec["kind"] == "actor_creation":
                runtime = self.actor_runtimes.get(ActorID(spec["actor_id"]))
                if runtime is not None:
                    runtime.node = target
        if target == self.node_id.binary():
            self._record_task_event(spec, "PENDING_ARGS_AVAIL")
            if spec["kind"] == "actor_creation":
                with self._lock:
                    aid = ActorID(spec["actor_id"])
                    self.actor_hosts.setdefault(aid, ActorHost(spec))
            self.scheduler.enqueue(task_id, request, spec)
            if schedule:
                self._schedule()
            return
        client = self._node_client(target)
        if client is None:
            self._park_infeasible(task_id, spec)
            return
        self._record_task_event(spec, "FORWARDED")
        try:
            client.call("schedule_task", spec=spec)
        except RpcError:
            # Node just died. Clear the assignment so the node-death
            # orphan scan can't also resubmit it (double execution).
            self._park_infeasible(task_id, spec)

    def _park_infeasible(self, task_id: TaskID, spec: dict) -> None:
        with self._lock:
            entry = self.tasks.get(task_id)
            if entry is not None:
                entry.node = None
            self._infeasible[task_id] = spec

    def _retry_infeasible(self) -> None:
        with self._lock:
            pending = [
                (tid, spec)
                for tid, spec in self._infeasible.items()
                if not (
                    tid in self.tasks and self.tasks[tid].state == "DONE"
                )
            ]
            self._infeasible.clear()
        for _, spec in pending:
            self._submit_cluster(spec)

    def _h_submit_task(self, conn, msg):
        spec = msg["spec"]
        if not self.is_head:
            return self.head.call("submit_task", spec=spec)
        task_id = TaskID(spec["task_id"])
        with self._lock:
            self.tasks[task_id] = TaskEntry(
                spec=spec, retries_left=spec.get("max_retries", 0)
            )
            for ret in spec["returns"]:
                self._ensure_entry(ObjectID(ret))
        self._pin_args(spec)
        self._submit_cluster(spec)
        return {}

    def _h_submit_tasks(self, conn, msg):
        """Batched task ingestion: one wire round trip covers a whole
        flat-codec spec batch. Ingestion is IDEMPOTENT by task_id —
        re-sending a batch whose first attempt was lost in transport
        re-ingests only the specs the head never saw, which is what
        makes driver-side batch retry exactly-once. Per-spec decode
        failures ride back as {index: error} so one malformed spec
        fails alone. Dispatch interleaves with ingestion: each batch
        schedules before the connection's ordered drain picks up the
        next frame, so early tasks complete while later batches are
        still arriving."""
        from .wire import SpecCodecError, decode_spec, split_spec_batch

        if not self.is_head:
            return self.head.call(
                "submit_tasks", specs=msg["specs"], count=msg["count"]
            )
        blobs = split_spec_batch(msg["specs"])
        # Decode OUTSIDE the hot lock: a 256-spec frame (with embedded
        # pickles for cold fields) is milliseconds of pure decode, and
        # heartbeats/dispatch must not stall behind it.
        decoded = []
        errors = {}
        for i, blob in enumerate(blobs):
            try:
                spec = decode_spec(blob)
                decoded.append((TaskID(spec["task_id"]), spec))
            except (SpecCodecError, ValueError) as e:
                errors[i] = repr(e)
        accepted = []
        with self._lock:
            for task_id, spec in decoded:
                if task_id in self.tasks:
                    continue  # retried batch: already ingested
                self.tasks[task_id] = TaskEntry(
                    spec=spec, retries_left=spec.get("max_retries", 0)
                )
                for ret in spec["returns"]:
                    self._ensure_entry(ObjectID(ret))
                accepted.append(spec)
        for spec in accepted:
            self._pin_args(spec)
            self._submit_cluster(spec, schedule=False)
        if accepted:
            # One dispatch pass per batch, not per spec: enqueue is
            # O(1), and the pass runs while the NEXT batch is still in
            # the socket — submit-flood ingestion and dispatch
            # interleave at batch granularity.
            self._schedule()
        reply = {"accepted": len(accepted)}
        if errors:
            reply["errors"] = errors
        return reply

    def _h_schedule_task(self, conn, msg):
        """Head forwarded a task to run on this node."""
        spec = msg["spec"]
        task_id = TaskID(spec["task_id"])
        re_report = None
        with self._lock:
            if spec["kind"] == "actor_creation":
                aid = ActorID(spec["actor_id"])
                host = self.actor_hosts.get(aid)
                if host is not None:
                    # Already hosting/creating this actor — a restarted
                    # head re-dispatched a creation this node finished
                    # (or still runs). Re-report instead of duplicating
                    # the instance.
                    if host.worker_conn_id is not None:
                        re_report = aid
                    else:
                        return {}
                else:
                    self.actor_hosts[aid] = ActorHost(spec)
            if re_report is None:
                self.tasks[task_id] = TaskEntry(
                    spec=spec, retries_left=spec.get("max_retries", 0)
                )
        if re_report is not None:
            # On worker nodes this is a synchronous RPC to the head —
            # a slow head must never wedge this node's dispatch lock
            # (every other handler and the heartbeat block on it).
            self._control_actor_created(
                re_report, False, self.node_id.binary()
            )
            return {}
        self.scheduler.enqueue(
            task_id, ResourceSet(spec.get("resources", {})), spec
        )
        self._schedule()
        return {}

    def _h_task_finished(self, conn, msg):
        """A node reports final task completion (head only).
        Idempotent: a task already finalized (e.g. failed via
        _fail_task_returns) is not unpinned twice."""
        task_id = TaskID(msg["task_id"])
        with self._lock:
            entry = self.tasks.get(task_id)
            if entry is None or entry.state == "DONE":
                return {}
            entry.state = "DONE"
        spec = entry.spec
        self.core_counters.bump(
            "tasks_failed" if msg.get("had_error") else "tasks_finished"
        )
        self._record_task_event(
            spec, "FAILED" if msg.get("had_error") else "FINISHED"
        )
        if spec["kind"] == "actor_task":
            with self._lock:
                runtime = self.actor_runtimes.get(ActorID(spec["actor_id"]))
                if runtime is not None:
                    runtime.inflight.pop(task_id, None)
        self._unpin_args(spec)
        return {}

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def _h_create_actor(self, conn, msg):
        spec = msg["spec"]
        if not self.is_head:
            return self.head.call("create_actor", spec=spec)
        self.core_counters.bump("actors_created")
        actor_id = ActorID(spec["actor_id"])
        info = ActorInfo(
            actor_id=actor_id,
            name=spec.get("name"),
            namespace=spec.get("namespace", "default"),  # rt: noqa[RT006] — wire-compat: specs from old clients lack the field
            state=ACTOR_PENDING_CREATION,
            class_name=spec.get("class_name", ""),
            max_restarts=spec.get("max_restarts", 0),
        )
        try:
            self.control.register_actor(info)
        except Exception as e:
            # Creates arrive as one-way notifies (pipelined), so a
            # registration error (duplicate name) can't ride an RPC
            # reply — it surfaces the way every other actor failure
            # does: the creation task's return object seals with the
            # error and the first method result raises it.
            self._fail_task_returns(
                spec, "ActorDiedError", f"actor registration failed: {e}"
            )
            return {}
        # Creation spec rides the op log so a restarted head can
        # rebuild this runtime record (and restart the actor if its
        # host later dies).
        self.control.log_extra("actor_spec", spec)
        with self._lock:
            self.actor_runtimes[actor_id] = ActorRuntime(
                creation_spec=spec, info=info
            )
            task_id = TaskID(spec["task_id"])
            self.tasks[task_id] = TaskEntry(spec=spec)
            for ret in spec["returns"]:
                self._ensure_entry(ObjectID(ret))
        self._pin_args(spec)
        self._submit_cluster(spec)
        return {}

    def _h_submit_actor_task(self, conn, msg):
        spec = msg["spec"]
        if not self.is_head:
            return self.head.call("submit_actor_task", spec=spec)
        actor_id = ActorID(spec["actor_id"])
        task_id = TaskID(spec["task_id"])
        with self._lock:
            runtime = self.actor_runtimes.get(actor_id)
            self.tasks[task_id] = TaskEntry(
                spec=spec, retries_left=spec.get("max_retries", 0)
            )
            for ret in spec["returns"]:
                self._ensure_entry(ObjectID(ret))
        self._pin_args(spec)
        if runtime is None or runtime.info.state == ACTOR_DEAD:
            self._fail_task_returns(
                spec, "ActorDiedError", "actor is dead"
            )
            return {}
        self._route_actor_task(runtime, spec)
        return {}

    def _route_actor_task(self, runtime: ActorRuntime, spec: dict) -> None:
        """Deliver an actor task to its hosting node, or queue while the
        actor is pending/restarting (head only)."""
        task_id = TaskID(spec["task_id"])
        with self._lock:
            if runtime.info.state != ACTOR_ALIVE or runtime.node is None:
                runtime.pending.append(spec)
                return
            runtime.inflight[task_id] = spec
            target = runtime.node
        if target == self.node_id.binary():
            self._host_push_task(ActorID(spec["actor_id"]), spec)
            return
        client = self._node_client(target)
        if client is None:
            self._fail_task_returns(
                spec, "ActorUnavailableError", "actor node unreachable"
            )
            return
        try:
            client.call("actor_task", spec=spec)
        except RpcError:
            self._fail_task_returns(
                spec, "ActorUnavailableError", "actor node unreachable"
            )

    def _h_actor_task(self, conn, msg):
        """Head forwards an actor task to this hosting node."""
        spec = msg["spec"]
        self._host_push_task(ActorID(spec["actor_id"]), spec)
        return {}

    def _host_push_task(self, actor_id: ActorID, spec: dict) -> None:
        with self._lock:
            host = self.actor_hosts.get(actor_id)
            if host is None:
                host = self.actor_hosts.setdefault(actor_id, ActorHost(spec))
            worker = (
                self.workers.get(host.worker_conn_id)
                if host.worker_conn_id is not None
                else None
            )
            if worker is not None:
                host.inflight[TaskID(spec["task_id"])] = spec
                worker.conn.push("execute_task", {"spec": spec})
            else:
                host.pending.append(spec)

    def _h_task_done(self, conn, msg):
        task_id = TaskID(msg["task_id"])
        error = msg.get("error")  # serialized error payload or None
        system = msg.get("system_error", False)
        with self._lock:
            winfo = self.workers.get(conn.conn_id)
            entry = self.tasks.get(task_id)
        if entry is None:
            return {}
        spec = entry.spec
        if error is not None and system and entry.retries_left > 0:
            # System failures retry with the same task id → same return
            # object ids, the property lineage reconstruction relies on
            # (reference: TaskManager::RetryTaskIfPossible).
            entry.retries_left -= 1
            self._record_task_event(spec, "RETRY")
            self.scheduler.release(task_id)
            self.scheduler.enqueue(
                task_id, ResourceSet(spec.get("resources", {})), spec
            )
        else:
            if error is not None:
                for ret in spec["returns"]:
                    self._seal_error(ObjectID(ret), error)
            if spec["kind"] == "actor_creation":
                self._on_actor_created_host(spec, error, conn.conn_id)
                if error is not None:
                    self.scheduler.release(task_id)
                elif spec.get("release_creation_resources"):
                    # Default-resource actor: the 1 CPU gated placement
                    # only (reference DEFAULT_ACTOR_CREATION_CPU_SIMPLE
                    # =0) — return it now that the actor is up so more
                    # default actors than node CPUs still come up.
                    # (Idempotent: the later death-path release no-ops.
                    # _h_task_done's fall-through _schedule() dispatches
                    # anything the freed CPU unblocks.)
                    self.scheduler.release(task_id)
                # else: a live actor holds its explicit creation
                # resources until death (_on_actor_worker_death /
                # actor death handling).
            elif spec["kind"] == "actor_task":
                with self._lock:
                    host = self.actor_hosts.get(ActorID(spec["actor_id"]))
                    if host is not None:
                        host.inflight.pop(task_id, None)
            else:
                self.scheduler.release(task_id)
            # Final-completion bookkeeping lives on the head.
            if spec["kind"] != "actor_creation":
                if self.is_head:
                    self._h_task_finished(
                        None,
                        {"task_id": msg["task_id"], "had_error": error is not None},
                    )
                else:
                    self.head.notify(
                        "task_finished",
                        task_id=msg["task_id"],
                        had_error=error is not None,
                    )
            with self._lock:
                entry.state = "DONE"
        # Return the worker to the pool (actor workers stay pinned).
        with self._lock:
            if winfo is not None and winfo.pinned_actor is None:
                winfo.idle = True
                winfo.idle_since = time.time()
                winfo.current_task = None
        self._schedule()
        return {}

    def _publish_error_event(self, source: str, message: str) -> None:
        """Push a cluster error event to subscribed drivers (reference:
        error messages published per job and printed by the driver,
        worker.py listen_error_messages). Rides the same subscriber
        registry as log streaming — one pubsub, several channels.
        Worker-node failures forward through the head like everything
        else (drivers attach there)."""
        payload = {
            "source": source, "message": message, "time": time.time(),
        }
        if self.is_head:
            self._push_to_subscribers("error_event", payload)
        elif self.head is not None:
            try:
                self.head.notify(
                    "publish_event", channel="error_event",
                    payload=payload,
                )
            except Exception:
                pass

    def _fail_task_returns(self, spec: dict, kind: str, detail: str) -> None:
        from .task_spec import make_error_payload

        payload = make_error_payload(kind, detail)
        for ret in spec["returns"]:
            self._seal_error(ObjectID(ret), payload)
        self._record_task_event(spec, "FAILED")
        self._publish_error_event(
            f"task {spec.get('name') or TaskID(spec['task_id']).hex()[:8]}",
            f"{kind}: {detail}",
        )
        if not self.is_head:
            return
        with self._lock:
            entry = self.tasks.get(TaskID(spec["task_id"]))
            if entry is not None:
                if entry.state == "DONE":
                    return  # already finalized; don't unpin twice
                entry.state = "DONE"
        if spec["kind"] == "actor_creation":
            with self._lock:
                runtime = self.actor_runtimes.get(ActorID(spec["actor_id"]))
            if runtime is not None:
                self._unpin_creation_args(runtime)
            else:
                self._unpin_args(spec)
        else:
            self._unpin_args(spec)

    def _h_cancel_task(self, conn, msg):
        if not self.is_head:
            return self.head.call("cancel_task", task_id=msg["task_id"])
        task_id = TaskID(msg["task_id"])
        cancelled = self.scheduler.cancel(task_id)
        if not cancelled:
            with self._lock:
                entry = self.tasks.get(task_id)
                target = entry.node if entry is not None else None
                if task_id in self._infeasible:
                    del self._infeasible[task_id]
                    cancelled = True
            if not cancelled and target and target != self.node_id.binary():
                client = self._node_client(target)
                if client is not None:
                    try:
                        cancelled = client.call(
                            "cancel_local", task_id=msg["task_id"]
                        )["cancelled"]
                    except RpcError:
                        cancelled = False
        if cancelled:
            with self._lock:
                entry = self.tasks.get(task_id)
            if entry is not None:
                self._fail_task_returns(
                    entry.spec, "TaskCancelledError", "task was cancelled"
                )
        return {"cancelled": cancelled}

    def _h_cancel_local(self, conn, msg):
        task_id = TaskID(msg["task_id"])
        return {"cancelled": self.scheduler.cancel(task_id)}

    # -- host-side actor lifecycle --------------------------------------
    def _on_actor_created_host(
        self, spec: dict, error, worker_conn_id: int
    ) -> None:
        actor_id = ActorID(spec["actor_id"])
        with self._lock:
            host = self.actor_hosts.get(actor_id)
            if host is None:
                return
            if error is not None:
                self.actor_hosts.pop(actor_id, None)
                worker = self.workers.get(worker_conn_id)
                if worker is not None:
                    worker.pinned_actor = None
            else:
                host.worker_conn_id = worker_conn_id
                worker = self.workers.get(worker_conn_id)
                if worker is not None:
                    worker.current_task = None
                    worker.pinned_actor = actor_id
                while host.pending:
                    queued = host.pending.popleft()
                    host.inflight[TaskID(queued["task_id"])] = queued
                    worker.conn.push("execute_task", {"spec": queued})
        self._control_actor_created(
            actor_id, error is not None, self.node_id.binary()
        )

    def _control_actor_created(
        self, actor_id: ActorID, failed: bool, node_id: bytes
    ) -> None:
        if not self.is_head:
            try:
                self.head.call(
                    "actor_created", actor_id=actor_id.binary(),
                    failed=failed, node_id=node_id,
                )
            except RpcError:
                pass
            return
        self._h_actor_created(
            None,
            {
                "actor_id": actor_id.binary(),
                "failed": failed,
                "node_id": node_id,
            },
        )

    def _h_actor_created(self, conn, msg):
        """Creation-task outcome reaches the control plane (head)."""
        actor_id = ActorID(msg["actor_id"])
        failed = msg["failed"]
        node_id = msg["node_id"]
        killed_mid_creation = False
        with self._lock:
            runtime = self.actor_runtimes.get(actor_id)
            if runtime is None:
                return {}
            if runtime.info.state == ACTOR_DEAD:
                killed_mid_creation = True
            elif failed:
                runtime.info.state = ACTOR_DEAD
                pending = list(runtime.pending)
                runtime.pending.clear()
            else:
                runtime.info.state = ACTOR_ALIVE
                runtime.node = node_id
                pending = []
        if killed_mid_creation:
            # Killed while the creation task was queued/running: do
            # not resurrect; recycle the hosting worker so actor state
            # can't leak into later tasks. The kill may RPC another
            # node — never under the head's state lock (a slow node
            # would wedge the whole control plane for the timeout).
            if not failed:
                self._kill_host_worker(actor_id, node_id)
            return {}
        if failed:
            self.control.update_actor_state(
                actor_id, ACTOR_DEAD, death_cause="creation task failed"
            )
            for p in pending:
                self._fail_task_returns(
                    p, "ActorDiedError", "actor creation failed"
                )
            self._unpin_creation_args(runtime)
        else:
            self.control.update_actor_state(
                actor_id, ACTOR_ALIVE, node_id=NodeID(node_id)
            )
            while True:
                with self._lock:
                    if not runtime.pending:
                        break
                    spec = runtime.pending.popleft()
                self._route_actor_task(runtime, spec)
        self._wake_actor_addr_waiters(actor_id)
        return {}

    def _kill_host_worker(self, actor_id: ActorID, node_id: bytes) -> None:
        """Kill the worker process hosting an actor (post-kill cleanup
        when creation finished after kill())."""
        if node_id == self.node_id.binary():
            with self._lock:
                host = self.actor_hosts.pop(actor_id, None)
                worker = (
                    self.workers.get(host.worker_conn_id)
                    if host and host.worker_conn_id is not None
                    else None
                )
                if worker is not None:
                    worker.pinned_actor = None
            if worker is not None:
                try:
                    os.kill(worker.pid, 9)
                except ProcessLookupError:
                    pass
            return
        client = self._node_client(node_id)
        if client is not None:
            try:
                client.call("kill_actor_local", actor_id=actor_id.binary())
            except RpcError:
                pass

    def _on_actor_worker_death(self, winfo: WorkerInfo) -> None:
        actor_id = winfo.pinned_actor
        with self._lock:
            host = self.actor_hosts.pop(actor_id, None)
        creating = (
            winfo.current_task is not None
            and host is not None
            and host.worker_conn_id is None
        )
        if host is not None:
            creation_task = TaskID(host.creation_spec["task_id"])
            self.scheduler.release(creation_task)
            # The freed share may fit a queued task or actor creation
            # (a pipeline's next stages, built right after the last
            # ones were killed): dispatch now, not at the next event.
            self._schedule()
        if not self.is_head:
            try:
                self.head.call(
                    "actor_worker_died", actor_id=actor_id.binary(),
                    creating=creating,
                )
            except RpcError:
                pass
            return
        self._h_actor_worker_died(
            None, {"actor_id": actor_id.binary(), "creating": creating}
        )

    def _h_actor_worker_died(self, conn, msg):
        """Hosting worker died; decide restart vs. death (head)."""
        actor_id = ActorID(msg["actor_id"])
        creating = msg.get("creating", False)
        with self._lock:
            runtime = self.actor_runtimes.get(actor_id)
            if runtime is None:
                return {}
            can_restart = (
                runtime.info.max_restarts == -1
                or runtime.info.num_restarts < runtime.info.max_restarts
            ) and not self._shutdown
            inflight = list(runtime.inflight.values())
            runtime.inflight.clear()
        for spec in inflight:
            self._fail_task_returns(
                spec,
                "ActorUnavailableError" if can_restart else "ActorDiedError",
                "actor worker died while executing task",
            )
        if creating and not can_restart:
            self._fail_task_returns(
                runtime.creation_spec,
                "ActorDiedError",
                "actor died during creation",
            )
        if can_restart:
            with self._lock:
                runtime.info.num_restarts += 1
                self.core_counters.bump("actor_restarts")
                runtime.info.state = ACTOR_RESTARTING
                runtime.node = None
            self.control.update_actor_state(actor_id, ACTOR_RESTARTING)
            spec = runtime.creation_spec
            task_id = TaskID(spec["task_id"])
            with self._lock:
                self.tasks[task_id] = TaskEntry(spec=spec)
            self._submit_cluster(spec)
            with self._lock:
                entry = self.tasks.get(task_id)
                runtime.node = entry.node if entry else None
        else:
            self._mark_actor_dead(actor_id, "worker died")
        return {}

    def _mark_actor_dead(self, actor_id: ActorID, cause: str) -> None:
        with self._lock:
            runtime = self.actor_runtimes.get(actor_id)
            if runtime is None:
                return
            already_dead = runtime.info.state == ACTOR_DEAD
            runtime.info.state = ACTOR_DEAD
        if not already_dead:
            # Publish exactly once, on the live->dead transition (kill
            # + later worker-death report would double-announce).
            self._publish_error_event(
                f"actor {actor_id.hex()[:8]}", f"dead: {cause}"
            )
        with self._lock:
            runtime = self.actor_runtimes.get(actor_id)
            if runtime is None:
                return
            pending = list(runtime.pending)
            runtime.pending.clear()
            inflight = list(runtime.inflight.values())
            runtime.inflight.clear()
        self.control.update_actor_state(
            actor_id, ACTOR_DEAD, death_cause=cause
        )
        self._unpin_creation_args(runtime)
        for p in pending + inflight:
            self._fail_task_returns(p, "ActorDiedError", cause)
        self._wake_actor_addr_waiters(actor_id)

    def _h_kill_actor(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "kill_actor", actor_id=msg["actor_id"],
                no_restart=msg.get("no_restart", True),
            )
        actor_id = ActorID(msg["actor_id"])
        with self._lock:
            runtime = self.actor_runtimes.get(actor_id)
            if runtime is None:
                return {"ok": False}
            if msg.get("no_restart", True):
                runtime.info.max_restarts = 0  # suppress restart
            target = runtime.node
            creation_task = TaskID(runtime.creation_spec["task_id"])
            infeasible = creation_task in self._infeasible
            if infeasible:
                del self._infeasible[creation_task]
        if infeasible:
            self._fail_task_returns(
                runtime.creation_spec,
                "ActorDiedError",
                "actor killed before creation",
            )
            self._mark_actor_dead(actor_id, "killed via kill()")
            return {"ok": True}
        if target is None or target == self.node_id.binary():
            self._kill_actor_local(actor_id)
        else:
            client = self._node_client(target)
            if client is not None:
                try:
                    client.call(
                        "kill_actor_local", actor_id=actor_id.binary()
                    )
                except RpcError:
                    self._mark_actor_dead(actor_id, "actor node unreachable")
        return {"ok": True}

    def _h_kill_actor_local(self, conn, msg):
        self._kill_actor_local(ActorID(msg["actor_id"]))
        return {"ok": True}

    def _kill_actor_local(self, actor_id: ActorID) -> None:
        """Kill the local hosting worker, or cancel a still-queued
        creation task (then report death to the control plane)."""
        with self._lock:
            host = self.actor_hosts.get(actor_id)
            winfo = (
                self.workers.get(host.worker_conn_id)
                if host and host.worker_conn_id is not None
                else None
            )
        if winfo is not None:
            try:
                os.kill(winfo.pid, 9)
            except ProcessLookupError:
                pass
            return
        if host is not None:
            creation_task = TaskID(host.creation_spec["task_id"])
            if self.scheduler.cancel(creation_task):
                with self._lock:
                    self.actor_hosts.pop(actor_id, None)
                self._fail_task_returns(
                    host.creation_spec,
                    "ActorDiedError",
                    "actor killed before creation",
                )
                if self.is_head:
                    self._mark_actor_dead(actor_id, "killed via kill()")
                else:
                    try:
                        self.head.call(
                            "actor_worker_died",
                            actor_id=actor_id.binary(),
                            creating=False,
                        )
                    except RpcError:
                        pass
                return
        # Creation running (worker not yet bound): fall back to marking
        # dead at the control plane; the bind-time check recycles it.
        if self.is_head:
            self._mark_actor_dead(actor_id, "killed via kill()")
        else:
            try:
                self.head.call(
                    "actor_worker_died", actor_id=actor_id.binary(),
                    creating=False,
                )
            except RpcError:
                pass

    def _h_get_named_actor(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "get_named_actor", name=msg["name"],
                namespace=msg.get("namespace", "default"),  # rt: noqa[RT006] — wire-compat fallback for old clients
            )
        info = self.control.get_named_actor(
            msg.get("namespace", "default"), msg["name"]  # rt: noqa[RT006] — wire-compat fallback for old clients
        )
        if info is None:
            return {"found": False}
        with self._lock:
            runtime = self.actor_runtimes.get(info.actor_id)
        return {
            "found": True,
            "actor_id": info.actor_id.binary(),
            "state": info.state,
            "handle_meta": runtime.creation_spec.get("handle_meta")
            if runtime
            else None,
        }

    def _h_get_actor_info(self, conn, msg):
        if not self.is_head:
            return self.head.call("get_actor_info", actor_id=msg["actor_id"])
        actor_id = ActorID(msg["actor_id"])
        with self._lock:
            runtime = self.actor_runtimes.get(actor_id)
        if runtime is None:
            return {"found": False}
        return {
            "found": True,
            "state": runtime.info.state,
            "num_restarts": runtime.info.num_restarts,
            "node_id": NodeID(runtime.node).hex() if runtime.node else None,
        }

    # ------------------------------------------------------------------
    # node death (head)
    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # placement groups (reference: gcs_placement_group_manager.cc on the
    # head + placement_group_resource_manager.h 2PC on each node)
    # ------------------------------------------------------------------
    def _h_create_placement_group(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "create_placement_group",
                pg_id=msg["pg_id"],
                bundles=msg["bundles"],
                strategy=msg["strategy"],
                name=msg.get("name", ""),
            )
        strategy = msg["strategy"]
        if strategy not in STRATEGIES:
            return {"error": f"unknown strategy {strategy!r}"}
        entry = PGEntry(
            pg_id=msg["pg_id"],
            bundles=list(msg["bundles"]),
            strategy=strategy,
            name=msg.get("name", ""),
        )
        with self._lock:
            if entry.name:
                for other in self.pgs.values():
                    if other.name == entry.name and other.state != "REMOVED":
                        return {
                            "error": f"placement group name {entry.name!r}"
                            " already taken"
                        }
            self.pgs[entry.pg_id] = entry
        self._try_place_pg(entry)
        return {"ok": True}

    def _h_placement_group_state(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "placement_group_state", pg_id=msg["pg_id"]
            )
        entry = self.pgs.get(msg["pg_id"])
        if entry is None:
            return {"state": None}
        return {"state": entry.state, "entry": entry.to_table_entry()}

    def _h_placement_group_table(self, conn, msg):
        if not self.is_head:
            return self.head.call("placement_group_table")
        with self._lock:
            table = [e.to_table_entry() for e in self.pgs.values()]
        return {"table": table}

    def _h_remove_placement_group(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "remove_placement_group", pg_id=msg["pg_id"]
            )
        with self._pg_mutex:
            with self._lock:
                entry = self.pgs.get(msg["pg_id"])
                if entry is None or entry.state == "REMOVED":
                    return {"ok": True}
                entry.state = "REMOVED"
                assignment = list(entry.bundle_nodes)
                entry.bundle_nodes = [None] * len(entry.bundles)
            for index, node in enumerate(assignment):
                if node is not None:
                    self._bundle_call(
                        node,
                        "release_bundle",
                        pg_id=entry.pg_id,
                        bundle_index=index,
                    )
        self._purge_pg_tasks(entry.pg_id.hex())
        self._schedule()
        return {"ok": True}

    def _purge_pg_tasks(self, pg_hex: str) -> None:
        """Fail tasks parked on a removed group's resources — their
        formatted resources can never exist again."""
        with self._lock:
            doomed = [
                (tid, spec)
                for tid, spec in self._infeasible.items()
                if any(
                    pg_hex in name
                    for name in (spec.get("resources") or {})
                )
            ]
            for tid, _ in doomed:
                del self._infeasible[tid]
        for _, spec in doomed:
            self._fail_task_returns(
                spec,
                "TaskError",
                f"placement group {pg_hex} was removed",
            )

    def _try_place_pg(self, entry: PGEntry) -> None:
        """Attempt bundle placement + 2PC; leaves the group PENDING /
        RESCHEDULING when infeasible (retried on cluster change). The
        group mutex serializes against concurrent retries and removal."""
        with self._pg_mutex:
            created = self._try_place_pg_locked(entry)
        if created:
            # Group resources now exist: tasks gated on them can place.
            self._retry_infeasible()
            self._schedule()

    def _try_place_pg_locked(self, entry: PGEntry) -> bool:
        with self._lock:
            if entry.state in ("REMOVED", "CREATED"):
                return False
            missing = [
                i for i, n in enumerate(entry.bundle_nodes) if n is None
            ]
            exclude = []
            if entry.strategy == "STRICT_SPREAD":
                exclude = [n for n in entry.bundle_nodes if n is not None]
        if not missing:
            with self._lock:
                entry.state = "CREATED"
            return True
        assignment = place_bundles(
            [entry.bundles[i] for i in missing],
            entry.strategy if entry.strategy != "STRICT_PACK" or len(
                missing
            ) == len(entry.bundles) else "PACK",
            self._node_views(),
            exclude=exclude,
        )
        if assignment is None:
            return False
        prepared = []
        ok = True
        for offset, index in enumerate(missing):
            node = assignment[offset]
            reply = self._bundle_call(
                node,
                "prepare_bundle",
                pg_id=entry.pg_id,
                bundle_index=index,
                resources=entry.bundles[index],
            )
            if not reply.get("ok"):
                ok = False
                break
            prepared.append((index, node))
        if not ok:
            for index, node in prepared:
                self._bundle_call(
                    node,
                    "release_bundle",
                    pg_id=entry.pg_id,
                    bundle_index=index,
                )
            return False
        committed = []
        uncommitted = []
        for index, node in prepared:
            reply = self._bundle_call(
                node,
                "commit_bundle",
                pg_id=entry.pg_id,
                bundle_index=index,
            )
            if reply.get("ok"):
                committed.append((index, node))
            else:
                # A commit that never lands (RPC loss between prepare
                # and commit) must not let the head record the bundle
                # as placed — the node would hold unformatted resources
                # while tasks queue on {R}_group_{i}_{pg} forever.
                # Reference: gcs_placement_group_manager.cc treats
                # commit failure as placement failure and reschedules.
                uncommitted.append((index, node))
        with self._lock:
            # Committed bundles stay placed (their formatted resources
            # exist and tasks may already be queued or running on
            # them); releasing them here would spuriously fail those
            # tasks. Only the prepared-but-uncommitted bundles are
            # rolled back and retried.
            for index, node in committed:
                entry.bundle_nodes[index] = node
        for index, node in uncommitted:
            self._bundle_call(
                node,
                "release_bundle",
                pg_id=entry.pg_id,
                bundle_index=index,
            )
        with self._lock:
            # _pg_mutex (held by our caller) serializes against
            # remove_placement_group, so the state can't have become
            # REMOVED since the check at the top of this method.
            if all(n is not None for n in entry.bundle_nodes):
                entry.state = "CREATED"
            else:
                entry.state = "RESCHEDULING"
        return not uncommitted

    def _retry_pending_pgs(self) -> None:
        with self._lock:
            pending = [
                e
                for e in self.pgs.values()
                if e.state in ("PENDING", "RESCHEDULING")
            ]
        for entry in pending:
            self._try_place_pg(entry)

    def _maybe_retry_pgs(self) -> None:
        """Capacity just freed somewhere: give pending groups another
        shot. Runs from _schedule(), so a non-blocking gate breaks the
        place -> commit -> _schedule recursion (and makes concurrent
        callers coalesce instead of queueing)."""
        with self._lock:
            pending = any(
                e.state in ("PENDING", "RESCHEDULING")
                for e in self.pgs.values()
            )
        if not pending:
            return
        if not self._pg_retry_gate.acquire(blocking=False):
            return
        try:
            self._retry_pending_pgs()
        finally:
            self._pg_retry_gate.release()

    def _bundle_call(self, node_id: bytes, method: str, **kwargs) -> dict:
        """Run a bundle 2PC verb locally or on a remote node."""
        if node_id == self.node_id.binary():
            handler = getattr(self, "_h_" + method)
            return handler(None, kwargs)
        client = self._node_client(node_id)
        if client is None:
            return {"ok": False}
        try:
            return client.call(method, **kwargs)
        except RpcError:
            return {"ok": False}

    def _h_prepare_bundle(self, conn, msg):
        request = ResourceSet(msg["resources"])
        if not self.scheduler.try_reserve(request):
            return {"ok": False}
        with self._lock:
            self._bundles[(msg["pg_id"], msg["bundle_index"])] = {
                "resources": dict(msg["resources"]),
                "committed": False,
            }
        return {"ok": True}

    def _h_commit_bundle(self, conn, msg):
        key = (msg["pg_id"], msg["bundle_index"])
        with self._lock:
            bundle = self._bundles.get(key)
            if bundle is None:
                return {"ok": False}
            bundle["committed"] = True
        formatted = group_resources(
            msg["pg_id"].hex(), msg["bundle_index"], bundle["resources"]
        )
        self.scheduler.add_capacity(ResourceSet(formatted))
        # Local 2PC calls (conn is None) run with _pg_mutex held; the
        # placing caller triggers scheduling after release.
        if conn is not None:
            self._schedule()
        return {"ok": True}

    def _h_release_bundle(self, conn, msg):
        key = (msg["pg_id"], msg["bundle_index"])
        with self._lock:
            bundle = self._bundles.pop(key, None)
        if bundle is None:
            return {"ok": True}
        if bundle["committed"]:
            # Formatted capacity exists only after commit; a rolled-back
            # prepare must not subtract it.
            formatted = group_resources(
                msg["pg_id"].hex(), msg["bundle_index"], bundle["resources"]
            )
            self.scheduler.remove_capacity(ResourceSet(formatted))
        self.scheduler.add_capacity(ResourceSet(bundle["resources"]))
        # Tasks queued on this node against the group's formatted
        # resources can never run again — fail them now instead of
        # letting the caller's get() hang.
        pg_hex = msg["pg_id"].hex()
        doomed = self.scheduler.drain_queued(
            lambda spec: any(
                pg_hex in name for name in (spec.get("resources") or {})
            )
        )
        for spec in doomed:
            self._fail_task_returns(
                spec, "TaskError", f"placement group {pg_hex} was removed"
            )
            if not self.is_head:
                try:
                    self.head.notify(
                        "task_finished",
                        task_id=spec["task_id"],
                        had_error=True,
                    )
                except Exception:  # rt: noqa[RT007] — head may be mid-failover; resync will reconcile
                    pass
        if conn is not None:
            self._schedule()
        return {"ok": True}

    def _pg_on_node_death(self, node_id: bytes) -> None:
        """Bundles on a dead node are lost; re-place them elsewhere
        (reference: GcsPlacementGroupManager::OnNodeDead reschedules
        lost bundles)."""
        affected = []
        with self._lock:
            for entry in self.pgs.values():
                if entry.state == "REMOVED":
                    continue
                lost = False
                for i, n in enumerate(entry.bundle_nodes):
                    if n == node_id:
                        entry.bundle_nodes[i] = None
                        lost = True
                if lost:
                    if entry.strategy == "STRICT_PACK":
                        # Bundles are co-located: all died together.
                        entry.bundle_nodes = [None] * len(entry.bundles)
                    entry.state = "RESCHEDULING"
                    affected.append(entry)
        for entry in affected:
            self._try_place_pg(entry)

    def _on_node_death(self, node_id: bytes) -> None:
        """Handle a worker node's death: drop locations, retry its
        tasks, restart its actors (reference: GcsNodeManager death
        broadcast + lineage reconstruction,
        object_recovery_manager.h:90)."""
        if self._shutdown:
            return
        self.control.mark_node_dead(NodeID(node_id))
        # Its arena died with it: stop attributing its bytes (the
        # ledger's byte·s already banked what it consumed while alive).
        self._memory_ledger.drop_node(NodeID(node_id).hex())
        with self._lock:
            self._node_sync_versions.pop(node_id, None)
        self._pg_on_node_death(node_id)
        with self._lock:
            client = self._node_clients.pop(node_id, None)
        if client is not None:
            try:
                client.close()
            except Exception:
                pass
        # 1. Object copies on the dead node are gone.
        lost_waiting = []
        with self._lock:
            for oid, entry in self.objects.items():
                if node_id in entry.locations:
                    entry.locations.discard(node_id)
                    if (
                        not entry.locations
                        and not entry.in_shm
                        and entry.inline is None
                        and entry.state == SEALED
                        and (entry.waiters or entry.meta_waiters)
                    ):
                        lost_waiting.append(oid)
        for oid in lost_waiting:
            self._maybe_reconstruct(oid)
        # 2. Tasks forwarded to the dead node: retry elsewhere or fail.
        with self._lock:
            orphans = [
                (tid, e)
                for tid, e in self.tasks.items()
                if e.node == node_id and e.state != "DONE"
                and e.spec["kind"] == "normal"
            ]
        for tid, entry in orphans:
            if entry.retries_left > 0:
                entry.retries_left -= 1
                self._record_task_event(entry.spec, "RETRY")
                self._submit_cluster(entry.spec)
            else:
                self._fail_task_returns(
                    entry.spec, "WorkerCrashedError", "node died"
                )
        # 3. Actors hosted on the dead node: restart or die.
        with self._lock:
            dead_actors = [
                aid
                for aid, rt in self.actor_runtimes.items()
                if rt.node == node_id
                and rt.info.state in (
                    ACTOR_ALIVE, ACTOR_PENDING_CREATION, ACTOR_RESTARTING
                )
            ]
        for aid in dead_actors:
            self._h_actor_worker_died(
                None, {"actor_id": aid.binary(), "creating": True}
            )

    def _maybe_reconstruct(self, oid: ObjectID) -> None:
        """Lineage reconstruction: resubmit the task that created a
        lost object (reference: ObjectRecoveryManager::ReconstructObject
        — same task id ⇒ same return ids). Args must still be reachable;
        if they were already released the object is lost for good."""
        task_id = oid.task_id()
        with self._lock:
            entry = self.objects.get(oid)
            task = self.tasks.get(task_id)
            if entry is None:
                return
            if entry.reconstructing or entry.in_shm or entry.inline is not None:
                return
            if entry.state == PENDING:
                return  # already resubmitted (or never produced yet)
            args_gone = task is not None and any(
                kind == "ref" and ObjectID(payload) not in self.objects
                for kind, payload in task.spec["args"]
            )
            if task is None or task.spec["kind"] != "normal" or args_gone:
                from .task_spec import make_error_payload

                payload = make_error_payload(
                    "ObjectLostError",
                    f"object {oid.hex()} lost (all copies gone) and its "
                    "lineage is not reconstructable (creating task "
                    "unknown or its arguments already released)",
                )
            else:
                payload = None
                entry.reconstructing = True
                entry.state = PENDING
                entry.in_shm = False
                entry.locations.clear()
                task.state = "PENDING"
        if payload is not None:
            self._seal_error_local(oid, payload)
            return
        self._record_task_event(task.spec, "RECONSTRUCTING")
        self._pin_args(task.spec)
        self._submit_cluster(task.spec)
        with self._lock:
            entry.reconstructing = False

    # ------------------------------------------------------------------
    # scheduling + worker pool
    # ------------------------------------------------------------------
    def _schedule(self) -> None:
        if self._shutdown:
            return
        self.scheduler.maybe_dispatch(self._deps_ready, self._try_dispatch)
        if self.is_head:
            self._maybe_retry_pgs()

    def _deps_ready(self, spec: dict) -> bool:
        missing = []
        with self._lock:
            for kind, payload in spec.get("args", ()):
                if kind == "ref":
                    oid = ObjectID(payload)
                    entry = self.objects.get(oid)
                    if entry is None or entry.state == PENDING:
                        if not self.is_head:
                            missing.append(oid)
                        else:
                            return False
                    elif entry.state == SEALED and not (
                        entry.in_shm or entry.inline is not None
                    ):
                        missing.append(oid)
        if missing:
            for oid in missing:
                self._ensure_local(oid)
            return False
        return True

    @contextmanager
    def _hot_lock(self, name: str):
        """self._lock, with the acquisition wait recorded to the
        flight recorder — used on the hot paths where a long wait IS
        the diagnosis (dispatch stuck behind a slow handler holding
        the daemon lock)."""
        from .flight_recorder import recorder

        rec = recorder()
        if not rec.enabled:
            with self._lock:
                yield
            return
        t0 = time.monotonic()
        with self._lock:
            waited_ms = (time.monotonic() - t0) * 1e3
            # Zero-wait acquisitions are the steady state on the
            # dispatch path — recording them would let thousands of
            # uninformative entries/s evict the RPC/task events the
            # doctor digests. A long wait IS the diagnosis; only
            # those earn a ring slot.
            if waited_ms >= 1.0:
                rec.record("lock.wait", name, waited_ms)
            yield

    def _try_dispatch(self, task_id: TaskID, spec: dict) -> bool:
        needs_gpu = spec.get("resources", {}).get("GPU", 0) > 0
        if spec["kind"] == "lease":
            return self._try_grant_lease(task_id, spec, needs_gpu)
        with self._hot_lock("dispatch"):
            worker = next(
                (
                    w
                    for w in self.workers.values()
                    if w.idle and w.is_gpu == needs_gpu
                ),
                None,
            )
            if worker is None:
                self._spawn_for_dispatch(spec, needs_gpu)
                return False
            worker.idle = False
            worker.current_task = task_id
            if spec["kind"] == "actor_creation":
                worker.pinned_actor = ActorID(spec["actor_id"])
        self._record_task_event(spec, "RUNNING")
        worker.conn.push("execute_task", {"spec": spec})
        return True

    def _spawn_for_dispatch(self, spec: dict, needs_gpu: bool) -> None:
        """No idle worker took `spec`: grow the pool (caller holds
        self._lock)."""
        if spec["kind"] == "actor_creation":
            # Actors get DEDICATED workers exempt from the task-pool
            # cap — admission is controlled by the actor's resource
            # request, and a capped pool would deadlock many-actor
            # apps (reference: worker_pool starts one process per
            # actor; only in-flight startups are bounded,
            # worker_pool.cc maximum_startup_concurrency). Spawn
            # enough to cover the queued same-type creations (this
            # spec is out of the queue while being tried: +1).
            want = 1 + self.scheduler.count_queued(
                lambda s: s.get("kind") == "actor_creation"
                and (s.get("resources", {}).get("GPU", 0) > 0)
                == needs_gpu
            )
            while (
                self._spawning < self._startup_concurrency
                and want > self._spawning
            ):
                self._spawn_worker(needs_gpu)
        elif self._task_pool_size() + self._spawning < self._max_workers:
            self._spawn_worker(needs_gpu)

    def _task_pool_size(self) -> int:
        """Workers countable against the task-pool cap (caller holds
        self._lock). Actor-pinned workers are dedicated for the
        actor's lifetime and never return to the pool — counting them
        would let a few long-lived actors permanently starve plain
        tasks of worker spawns."""
        return sum(
            1 for w in self.workers.values() if w.pinned_actor is None
        )

    def _try_grant_lease(self, lease_id, spec: dict, needs_gpu: bool) -> bool:
        """Dispatch callback for lease pseudo-tasks: hand an idle
        worker (with a direct endpoint) to the requesting driver."""
        with self._lock:
            if spec["_driver"] not in self.drivers:
                # Requesting driver disconnected while this request was
                # queued (its lease sweep already ran): consume the
                # request and free the reservation, or the worker
                # would be marked leased to a ghost forever.
                self.scheduler.release(lease_id)
                return True
            worker = next(
                (
                    w
                    for w in self.workers.values()
                    if w.idle
                    and w.is_gpu == needs_gpu
                    and w.direct_address
                ),
                None,
            )
            if worker is None:
                if (
                    self._task_pool_size() + self._spawning
                    < self._max_workers
                ):
                    self._spawn_worker(needs_gpu)
                return False
            worker.idle = False
            worker.current_task = lease_id
            worker.leased_by = spec["_driver"]
            self.leases[lease_id] = (worker.conn.conn_id, spec["_driver"])
            worker_id = worker.worker_id.binary()
            address = worker.direct_address
        spec["_conn"].reply(
            spec["_mid"],
            {"lease_id": lease_id, "worker_id": worker_id,
             "address": address},
        )
        return True

    def _worker_env(self, needs_gpu: bool) -> dict:
        env = dict(os.environ)
        env["RT_SOCKET"] = self.socket_path
        env["RT_WORKER_GPU"] = "1" if needs_gpu else "0"
        if not needs_gpu:
            # CPU workers must not touch (or pay the init cost of) the
            # CUDA runtime: hide the cards, as the JAX package hides its
            # TPU chips (TPU_VISIBLE_CHIPS="" and JAX_PLATFORMS=cpu). A
            # GPU worker sees the host's cards; each rank binds its own
            # card itself (`train.backend.init_torch_distributed`). The
            # host's value stays under a name of its own, for the one
            # process a CPU worker starts that must see the cards: a
            # submitted job's entrypoint (`job_submission.JobManager`).
            env[HOST_CUDA_VISIBLE_DEVICES] = json.dumps(
                os.environ.get("CUDA_VISIBLE_DEVICES"))
            env["CUDA_VISIBLE_DEVICES"] = ""
        # Workers must import this package regardless of their cwd.
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH", "")) if p
        )
        return env

    def _ensure_fork_server(self):
        """Warm fork-server template for this node (lazy; cpu-scoped
        env, CUDA hidden). GPU workers never come from it: they are
        spawned fresh (`_spawn_worker_blocking`), so no process that
        forks ever initialises CUDA."""
        with self._fork_server_lock:
            if (
                self._fork_server is None
                and self.config.worker_fork_server
            ):
                from .worker_forkserver import ForkServerClient

                self._fork_server = ForkServerClient(
                    self._worker_env(needs_gpu=False),
                    os.path.join(self.session_dir, "forkserver.out"),
                )
                self._fork_server.start()
            return self._fork_server

    def _spawn_worker(self, needs_gpu: bool = False) -> None:
        """Request one worker spawn (non-blocking; callers hold
        self._lock). The actual fork/exec happens on the spawner
        thread — its pipe handshake must never stall dispatch."""
        self._spawning += 1
        self.core_counters.bump("workers_started")
        if self._spawn_thread is None:
            self._spawn_thread = threading.Thread(
                target=self._spawn_loop, daemon=True,
                name=f"spawn:{self.node_id.hex()[:8]}",
            )
            self._spawn_thread.start()
        self._spawn_queue.put(needs_gpu)

    def _spawn_loop(self) -> None:
        while not self._shutdown:
            try:
                needs_gpu = self._spawn_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self._spawn_worker_blocking(needs_gpu)
            except Exception:
                # Counted like a pre-registration death so the spawn
                # slot is reclaimed and the queue can't starve.
                with self._lock:
                    self._spawning = max(0, self._spawning - 1)
                    self._spawn_failures += 1
                    self._spawn_crash_total += 1
                self._schedule()

    def _spawn_worker_blocking(self, needs_gpu: bool) -> None:
        log_path = os.path.join(
            self.session_dir, f"worker-{len(self._worker_procs)}.out"
        )
        proc = None
        # A GPU worker is a fresh interpreter: CUDA must never be
        # initialised in a process that forks, and a fork of the warm
        # template would share its pages and threads with CUDA's.
        fork_server = None if needs_gpu else self._ensure_fork_server()
        if fork_server is not None:
            # Per-spawn deltas derived as a diff against the template's
            # base env (one source of truth: _worker_env; None unsets).
            base = self._worker_env(needs_gpu=False)
            want = self._worker_env(needs_gpu)
            overrides = {
                k: v for k, v in want.items() if base.get(k) != v
            }
            overrides.update(
                {k: None for k in base if k not in want}
            )
            proc = fork_server.spawn(log_path, overrides)
        if proc is None:
            # Cold path: a GPU worker, or the fork server disabled or
            # crashed twice.
            with open(log_path, "ab") as log_file:
                # The child holds its own copy of the fd; closing ours
                # immediately avoids leaking one fd per spawn.
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "ray_tpu_torch._private.worker_main"],
                    env=self._worker_env(needs_gpu),
                    stdout=log_file,
                    stderr=subprocess.STDOUT,
                )
        self._worker_procs.append(proc)
        self._watch_worker_start(proc)

    def _watch_worker_start(self, proc: subprocess.Popen) -> None:
        """Detect workers that die before registering (bad env, import
        error) so their spawn slot is reclaimed and the failure is
        surfaced instead of hanging the queue (reference: WorkerPool
        PopWorker failure callbacks, worker_pool.cc:1312).

        ONE watcher thread serves all pending spawns: a thread per
        spawn, each scanning the workers dict on its own 0.2s tick,
        was O(spawns x workers) of pure poll overhead at the
        1000-actor scale."""
        # The window must outlast the worker's own daemon-connect
        # budget (RT_WORKER_CONNECT_TIMEOUT, 60s): a worker still in
        # its connect retry loop is pending, not dead, and dropping it
        # from the watchlist early would leak its startup slot.
        window = 30.0 + float(
            os.environ.get("RT_WORKER_CONNECT_TIMEOUT", "60")
        )
        # Mutable entry: the watch loop appends a grace deadline on
        # first seeing the process exited.
        with self._spawn_watch_lock:
            self._spawn_watchlist.append([proc, time.time() + window])
            if self._spawn_watcher is None or not (
                self._spawn_watcher.is_alive()
            ):
                self._spawn_watcher = threading.Thread(
                    target=self._spawn_watch_loop, daemon=True,
                    name="spawn-watch",
                )
                self._spawn_watcher.start()

    def _spawn_watch_loop(self) -> None:
        while True:
            with self._spawn_watch_lock:
                watched = list(self._spawn_watchlist)
            if not watched:
                with self._spawn_watch_lock:
                    if not self._spawn_watchlist:
                        self._spawn_watcher = None
                        return
                time.sleep(0.05)
                continue
            with self._lock:
                # History, not the live dict: a fast worker can
                # register AND exit between ticks (short trial, idle
                # reap) — that is a success, not a startup crash.
                # Membership per watched pid (not a whole-set copy:
                # the set is O(workers ever) on long-lived daemons),
                # and CONSUMED on resolution so a later reuse of the
                # same pid by a new spawn is judged on its own
                # registration, not this one's.
                registered = {
                    e[0].pid
                    for e in watched
                    if e[0].pid in self._registered_pids_ever
                }
                self._registered_pids_ever -= registered
            now = time.time()
            done = []
            for entry in watched:
                proc, deadline = entry[0], entry[1]
                if proc.pid in registered:
                    done.append(entry)
                    continue
                exited = proc.poll() is not None
                if exited and len(entry) == 2:
                    # First sighting of the exit. The registration RPC
                    # may still be sitting unprocessed in the daemon's
                    # socket buffer (the worker can exit while its
                    # register_client is in flight under load), so give
                    # it one grace window before judging.
                    entry.append(now + 2.0)
                    continue
                if exited and now < entry[2]:
                    continue  # grace window still open
                if exited or now > deadline:
                    done.append(entry)
                    if exited:
                        with self._lock:
                            self._spawning = max(0, self._spawning - 1)
                            self._spawn_failures += 1
                            self._spawn_crash_total += 1
                            failures = self._spawn_failures
                        # Consecutive-failure trip wire. Generous by
                        # default: under heavy load a few slow spawns
                        # die racing their connect timeout while the
                        # SYSTEM is healthy, and nuking the queue for
                        # that turns overload into an outage.
                        limit = int(
                            os.environ.get("RT_SPAWN_FAILURE_LIMIT", "10")
                        )
                        if failures >= limit:
                            self._fail_all_queued(
                                "worker processes are crashing at "
                                "startup; see "
                                f"{self.session_dir}/worker-*.out"
                            )
                        self._schedule()
            if done:
                with self._spawn_watch_lock:
                    for item in done:
                        try:
                            self._spawn_watchlist.remove(item)
                        except ValueError:
                            pass
            time.sleep(0.2)

    def _fail_all_queued(self, detail: str) -> None:
        with self._lock:
            queued = [
                (tid, spec)
                for tid, (_, spec) in list(self.scheduler._queue.items())
            ]
        for tid, spec in queued:
            if self.scheduler.cancel(tid):
                if spec.get("kind") == "lease":
                    # Lease pseudo-tasks have no returns; tell the
                    # requesting driver to use the daemon path.
                    spec["_conn"].reply(
                        spec["_mid"], {"unavailable": True}
                    )
                else:
                    self._fail_task_returns(
                        spec, "WorkerCrashedError", detail
                    )

    def _on_task_worker_death(self, winfo: WorkerInfo) -> None:
        task_id = winfo.current_task
        with self._lock:
            entry = self.tasks.get(task_id)
        if entry is None:
            return
        self.scheduler.release(task_id)
        if entry.retries_left > 0 and not self._shutdown:
            entry.retries_left -= 1
            self._record_task_event(entry.spec, "RETRY")
            self.scheduler.enqueue(
                task_id,
                ResourceSet(entry.spec.get("resources", {})),
                entry.spec,
            )
            self._schedule()
        else:
            self._fail_task_returns(
                entry.spec, "WorkerCrashedError", "worker process died"
            )
            if entry.spec["kind"] != "actor_creation" and not self.is_head:
                self.head.notify(
                    "task_finished",
                    task_id=entry.spec["task_id"],
                    had_error=True,
                )

    # ------------------------------------------------------------------
    # introspection / state API
    # ------------------------------------------------------------------
    def _h_cluster_resources(self, conn, msg):
        if not self.is_head:
            return self.head.call("cluster_resources")
        total = ResourceSet()
        for info in self.control.alive_nodes():
            total = total.add(ResourceSet(info.resources))
        return {"resources": total.to_dict()}

    def _h_available_resources(self, conn, msg):
        if not self.is_head:
            return self.head.call("available_resources")
        total = ResourceSet()
        mine = self.node_id.binary()
        for info in self.control.alive_nodes():
            if info.node_id.binary() == mine:
                total = total.add(self.scheduler.available())
            else:
                total = total.add(ResourceSet(info.available))
        return {"resources": total.to_dict()}

    def _h_state_summary(self, conn, msg):
        if not self.is_head:
            return self.head.call("state_summary")
        summary = self.control.summary()
        summary.update(self.store.size_info())
        if self.spill is not None:
            summary.update(self.spill.stats())
        with self._lock:
            summary["workers"] = len(self.workers)
            summary["queued_tasks"] = self.scheduler.queued_count()
            summary["infeasible_tasks"] = len(self._infeasible)
        return {"summary": summary}

    def _h_event_stats(self, conn, msg):
        """Per-handler RPC timing stats for THIS daemon (reference:
        event_stats.cc dump in the debug state). Unlike most read
        APIs this does not forward to the head — the asker names the
        node whose loop it is diagnosing by connecting to it."""
        from .event_stats import stats

        return {"handlers": stats().snapshot()}

    def _relay_to_node(
        self, method: str, node_id, timeout: float, **fwd
    ) -> Optional[dict]:
        """Shared routing step of the operator RPCs that target a
        worker/daemon by node (profile_worker, flight_recorder,
        worker_inspect): a non-head daemon bounces the call through
        the head, the head calls the owning daemon directly. Returns
        None when `node_id` is absent or THIS node — the caller
        serves the request locally."""
        if not node_id or node_id == self.node_id.binary():
            return None
        if not self.is_head:
            return self.head.call(
                method, timeout=timeout, node_id=node_id, **fwd
            )
        client = self._node_client(node_id)
        if client is None:
            raise ValueError(f"no live node {NodeID(node_id).hex()}")
        return client.call(method, timeout=timeout, **fwd)

    @staticmethod
    def _parallel_map(fn, items: list) -> list:
        """Bounded concurrent map for the operator-driven fan-outs
        (inspect probes, diagnose node pulls, stack captures): one
        slow or unreachable target costs ONE probe window for the
        whole sweep instead of serializing every target behind it —
        several wedged targets in a serial loop would blow the
        caller's own RPC timeout exactly when the doctor is needed."""
        if not items:
            return []
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(8, len(items))
        ) as pool:
            return list(pool.map(fn, items))

    def _call_worker_direct(
        self, pid: int, method: str, timeout: float, **kwargs
    ) -> dict:
        """Call a LOCAL worker's direct endpoint by pid (the other
        shared half of the operator-RPC relay)."""
        with self._lock:
            worker = next(
                (
                    w
                    for w in self.workers.values()
                    if w.pid == pid and w.direct_address
                ),
                None,
            )
        if worker is None:
            raise ValueError(
                f"no local worker with pid {pid} (pass node_id to "
                f"reach a worker on another node)"
            )
        client = RpcClient(worker.direct_address)
        try:
            return client.call(method, timeout=timeout, **kwargs)
        finally:
            client.close()

    #: Forwardable profile parameters (shared by the single-worker
    #: relay, the doctor's stack capture, and the gang fan-out —
    #: `start_at` is the gang window's synchronized start).
    _PROFILE_PARAMS = ("kind", "duration_s", "hz", "top", "start_at")

    def _profile_target(
        self, node_id, pid: int, timeout: float, **params
    ) -> dict:
        """ONE start/stop/collect implementation for every profile
        capture: route to the owning daemon (driver -> head -> node)
        when `node_id` is remote, else call the local worker's direct
        `profile` endpoint. The single-worker RPC, the doctor's
        hung-task stack capture, and the gang-profile fan-out all run
        through here — no per-caller capture paths to drift."""
        reply = self._relay_to_node(
            "profile_worker", node_id, timeout, pid=pid, **params
        )
        if reply is not None:
            return reply
        return self._call_worker_direct(
            pid, "profile", timeout, **params
        )

    def _h_profile_worker(self, conn, msg):
        """Attach an on-demand profiler to a live worker (reference:
        dashboard reporter profile_manager.py py-spy/memray attach;
        here the worker profiles itself in-process —
        _private/profiling.py — reached over its direct endpoint).
        Routing: pid alone targets this node; (node_id, pid) routes
        driver -> head -> owning daemon. Blocks one RPC pool thread
        for the profile window (rare, operator-driven)."""
        params = {
            k: msg[k] for k in self._PROFILE_PARAMS if k in msg
        }
        params.setdefault("kind", "stack")
        timeout = float(msg.get("duration_s", 5.0)) + 30.0
        if "start_at" in params:
            timeout += max(0.0, float(params["start_at"]) - time.time())
        return self._profile_target(
            msg.get("node_id"), msg["pid"], timeout, **params
        )

    def _h_profile_gang(self, conn, msg):
        """Coordinated gang profiling (`rt.profile_gang` /
        `ray_tpu_torch profile --job`): fan ONE synchronized start/stop
        window out to every rank of a gang through the profile relay,
        and merge the per-rank capture artifacts with the gang's
        step-telemetry phases into one chrome trace on a shared
        (unix-epoch-us) clock. Head-only: the step ring that knows
        which (node, pid) hosts each rank lives here."""
        if not self.is_head:
            fwd = {
                k: msg[k]
                for k in ("job", "duration_s", "hz")
                if k in msg
            }
            # Forward timeout tracks the requested window (the head
            # legitimately blocks for duration + fan-out slack) — a
            # fixed value would throw away a long capture that ran
            # to completion.
            return self.head.call(
                "profile_gang",
                timeout=float(msg.get("duration_s", 2.0)) + 120.0,
                **fwd,
            )
        duration_s = min(
            float(msg.get("duration_s", 2.0)),
            self.config.profile_gang_max_duration_s,
        )
        hz = float(msg.get("hz", 100.0))
        job = msg.get("job") or None
        with self._lock:
            step_records = list(self._step_records)
        if job is None:
            # Default to the most recently reporting job — the one an
            # operator watching a slow gang means.
            latest: Dict[str, float] = {}
            for rec in step_records:
                j = str(rec.get("job", ""))
                latest[j] = max(
                    latest.get(j, 0.0), float(rec.get("time", 0.0))
                )
            job = max(latest, key=lambda j: latest[j], default=None)
        job_records = [
            r for r in step_records if str(r.get("job", "")) == job
        ]
        # Gang members = the reporting processes of the job's recent
        # step records; rank identity rides every record already.
        members: Dict[tuple, int] = {}
        for rec in job_records:
            node, pid = rec.get("node"), rec.get("pid")
            if node and pid:
                members[(str(node), int(pid))] = int(
                    rec.get("rank", 0)
                )
        if not members:
            raise ValueError(
                f"no step-reporting ranks found for job {job!r} — "
                "gang profiling needs a gang that reports step "
                "telemetry"
            )
        # Synchronized window: every rank sleeps until start_at, then
        # samples for the same duration — slices across ranks line up
        # on the shared clock instead of staggering by fan-out order.
        start_at = time.time() + 0.5
        timeout = duration_s + 30.0 + (start_at - time.time())

        def capture(item):
            (node_hex, pid), rank = item
            try:
                reply = self._profile_target(
                    bytes.fromhex(node_hex),
                    pid,
                    timeout,
                    kind="gang",
                    duration_s=duration_s,
                    hz=hz,
                    start_at=start_at,
                )
                return rank, reply, None
            except Exception as e:  # noqa: BLE001 — per-rank finding
                return rank, None, repr(e)

        trace: list = []
        ranks: list = []
        errors: Dict[int, str] = {}
        # Dedicated pool sized to the gang: _parallel_map's shared
        # 8-thread cap would serialize ranks 9+ past start_at —
        # every rank must hold an in-flight RPC for the WHOLE window
        # or the "synchronized" slices silently stagger.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(64, len(members))
        ) as pool:
            captures = list(
                pool.map(
                    capture,
                    sorted(
                        members.items(), key=lambda kv: kv[1]
                    ),
                )
            )
        for rank, reply, err in captures:
            if err is not None:
                errors[rank] = err
                continue
            row = {
                "rank": rank,
                "samples": reply.get("samples", 0),
                "threads": reply.get("threads", 0),
            }
            if reply.get("device_trace"):
                row["device_trace"] = reply["device_trace"]
            ranks.append(row)
            for event in reply.get("events", ()):
                # Re-home each rank's slices under one rank-labeled
                # process row so the merged view reads like the gang.
                event = dict(event)
                event["pid"] = f"rank {rank}"
                event.setdefault("args", {})["rank"] = rank
                trace.append(event)
        # Step-telemetry phases of the same job on the same clock —
        # the markers that say WHICH step the hot stacks sat in.
        from .step_telemetry import steps_to_chrome_trace

        window_records = [
            r
            for r in job_records
            if float(r.get("time", 0.0)) >= start_at - 60.0
        ]
        trace.extend(steps_to_chrome_trace(window_records))
        return {
            "job": job,
            "trace": trace,
            "ranks": ranks,
            "errors": errors,
            "window": {
                "start": start_at,
                "duration_s": duration_s,
            },
        }

    def _h_compile_summary(self, conn, msg):
        """The head's folded compile table + current storm verdict
        (`/api/compile`; the cluster half of
        compile_watch.snapshot())."""
        if not self.is_head:
            return self.head.call("compile_summary")
        from .compile_watch import detect_storms

        with self._lock:
            programs = {
                name: {
                    "compiles": row["compiles"],
                    "total_ms": round(row["total_ms"], 3),
                    "distinct_shapes": len(row["digests"]),
                    "digests": {
                        k: dict(v) for k, v in row["digests"].items()
                    },
                }
                for name, row in self._compile_programs.items()
            }
            storms = detect_storms(
                self._compile_programs,
                self.config.compile_storm_threshold,
            )
        return {"compile": {"programs": programs, "storms": storms}}

    def _h_list_task_events(self, conn, msg):
        if not self.is_head:
            return self.head.call(
                "list_task_events", limit=msg.get("limit", 1000)
            )
        return {"events": self.control.list_task_events(msg.get("limit", 1000))}

    def _h_list_nodes(self, conn, msg):
        if not self.is_head:
            return self.head.call("list_nodes")
        return {
            "nodes": [
                {
                    "node_id": n.node_id.hex(),
                    "address": n.address,
                    "resources": n.resources,
                    "available": n.available,
                    "labels": n.labels,
                    "alive": n.alive,
                    "is_head": n.is_head,
                }
                for n in self.control.nodes.values()
            ]
        }

    def _h_list_actors(self, conn, msg):
        if not self.is_head:
            return self.head.call("list_actors")
        with self._lock:
            return {
                "actors": [
                    {
                        "actor_id": rt.info.actor_id.hex(),
                        "name": rt.info.name,
                        "namespace": rt.info.namespace,
                        "state": rt.info.state,
                        "class_name": rt.info.class_name,
                        "num_restarts": rt.info.num_restarts,
                        "node_id": NodeID(rt.node).hex() if rt.node else None,
                    }
                    for rt in self.actor_runtimes.values()
                ]
            }

    def _h_list_objects(self, conn, msg):
        """Node-local object table for the state API (reference:
        node_manager.cc:780 HandleGetObjectsInfo). Largest first
        BEFORE truncating: dict order here is creation order, so a
        plain [:limit] under load dropped an arbitrary slice — the
        big consumers an operator is actually after (same bug class
        as the list_tasks newest-first fix)."""
        limit = int(msg.get("limit", 1000))
        now = time.time()
        # Snapshot under the lock, sort + build rows outside it (the
        # _node_memory_report pattern): the O(N log N) pass over a
        # large table must not stall the seal/get/schedule hot paths.
        with self._lock:
            entries = [
                # locations is a live set: tuple-copy it here so the
                # row build can't race a concurrent seal's add().
                (oid, entry, tuple(entry.locations),
                 oid in self._primary_pins)
                for oid, entry in self.objects.items()
            ]
        entries.sort(key=lambda item: item[1].size, reverse=True)
        out = []
        for oid, entry, locations, pinned in entries[:limit]:
            out.append(
                {
                    "object_id": oid.hex(),
                    "state": entry.state,
                    "size": entry.size,
                    "in_shm": entry.in_shm,
                    "inline": entry.inline is not None,
                    "locations": [
                        NodeID(n).hex() for n in locations
                    ],
                    "ref_count": entry.refcount,
                    # Ledger attribution columns (ISSUE 14).
                    "job": entry.owner_job,
                    "owner": entry.owner,
                    "age_s": (
                        round(now - entry.created_ts, 3)
                        if entry.created_ts
                        else 0.0
                    ),
                    "spilled": entry.spilled,
                    "pinned": pinned,
                    # Data-plane columns (ISSUE 20): where the bytes
                    # live, how many copies exist, and how THIS node's
                    # copy materialised ("" = sealed in place).
                    "node": (
                        min(NodeID(n).hex() for n in locations)
                        if locations
                        else (
                            self.node_id.hex()
                            if entry.in_shm or entry.spilled
                            else ""
                        )
                    ),
                    "copies": (
                        len(locations)
                        if locations
                        else int(
                            entry.in_shm
                            or entry.spilled
                            or entry.inline is not None
                        )
                    ),
                    "source": (
                        "inline"
                        if entry.inline is not None
                        else entry.source or
                        ("local" if entry.state == SEALED else "")
                    ),
                }
            )
        return {"objects": out}

    def _h_cluster_load(self, conn, msg):
        """Pending demand + per-node utilization for the autoscaler
        (reference: GcsAutoscalerStateManager serving cluster resource
        state / pending demand via autoscaler.proto)."""
        if not self.is_head:
            return self.head.call("cluster_load")
        with self._lock:
            infeasible = [
                dict(spec.get("resources") or {})
                for spec in self._infeasible.values()
            ]
            pending_pgs = [
                {"strategy": e.strategy, "bundles": list(e.bundles)}
                for e in self.pgs.values()
                if e.state in ("PENDING", "RESCHEDULING")
            ]
        nodes = []
        mine = self.node_id.binary()
        for info in self.control.alive_nodes():
            nid = info.node_id.binary()
            if nid == mine:
                available = self.scheduler.available().to_dict()
                total = self.scheduler.total().to_dict()
                queued = self.scheduler.queued_count()
            else:
                available = dict(info.available)
                total = dict(info.resources)
                queued = info.queued
            nodes.append(
                {
                    "node_id": info.node_id.hex(),
                    "is_head": info.is_head,
                    "total": total,
                    "available": available,
                    "queued": queued,
                    # Provider-node mapping for the autoscaler: a
                    # multi-host TPU slice is ONE provider node whose
                    # N host daemons each carry the provider-node
                    # label (reference: GCP provider matches instances
                    # to raylets by ip; labels are the tpu-native
                    # equivalent that survives NAT/fake clusters).
                    "labels": dict(info.labels or {}),
                }
            )
        return {
            "infeasible": infeasible,
            "pending_placement_groups": pending_pgs,
            "nodes": nodes,
            "resource_requests": self._resource_requests,
        }

    def _h_request_resources(self, conn, msg):
        """Standing autoscaler target (reference:
        ray.autoscaler.sdk.request_resources /
        GcsAutoscalerStateManager::HandleRequestClusterResource
        Constraint): REPLACE semantics — the latest call's bundles are
        the whole target; an empty list clears it. Persisted only in
        head memory: a restarted head forgets the hint, exactly like
        the reference."""
        if not self.is_head:
            return self.head.call(
                "request_resources", bundles=msg["bundles"]
            )
        self._resource_requests = [  # rt: noqa[RT201] — REPLACE semantics by design: a single atomic list store, latest caller wins
            dict(b) for b in msg["bundles"] if b
        ]
        return {"count": len(self._resource_requests)}

    # ------------------------------------------------------------------
    # OOM defense (reference: MemoryMonitor + worker killing policies)
    # ------------------------------------------------------------------
    def _oom_candidates(self) -> list:
        from .memory_monitor import process_rss

        out = []
        with self._lock:
            workers = list(self.workers.values())
            for winfo in workers:
                if winfo.idle or winfo.current_task is None:
                    continue
                entry = self.tasks.get(winfo.current_task)
                retriable = (
                    entry is not None and entry.retries_left > 0
                )
                out.append(
                    {
                        "pid": winfo.pid,
                        "task_id": winfo.current_task,
                        "retriable": retriable,
                        "rss": process_rss(winfo.pid),
                    }
                )
        return out

    def _oom_kill(self, victim: dict) -> None:
        """SIGKILL the chosen worker; the normal worker-death path
        retries or fails its task."""
        import signal

        self.core_counters.bump("oom_kills")
        try:
            os.kill(victim["pid"], signal.SIGKILL)
        except ProcessLookupError:
            pass

    def _h_metrics_record(self, conn, msg):
        """Batched metric records from local workers; forwarded to the
        head's aggregate table (reference: core-worker metrics flow to
        the node's metrics agent, then get scraped centrally)."""
        if not self.is_head:
            # A failed forward must FAIL the worker's call: replying
            # success here would defeat the sender-side requeue (the
            # _Buffer keeps the batch and retries) and silently lose
            # the records — step telemetry among them. Bounded: an
            # unresponsive head must not pin this daemon's pool
            # threads (one per flushing worker, every 0.5 s) until
            # the node itself stops answering dispatch/heartbeat.
            return self.head.call(
                "metrics_record",
                records=msg["records"],
                sender=msg.get("sender"),
                seq=msg.get("seq"),
                timeout=30.0,
            )
        with self._lock:
            sender, seq = msg.get("sender"), msg.get("seq")
            entry = None
            if sender is not None and seq is not None:
                sender = str(sender)
                seq = int(seq)
                entry = self._metrics_seen.pop(sender, None)
                if entry is None:
                    entry = [0, set()]
                # Re-insert at the END: eviction below pops the
                # LEAST-RECENTLY-USED sender, never one still
                # actively flushing (evicting an active sender would
                # re-enable the redelivery double-count this entry
                # exists to prevent).
                self._metrics_seen[sender] = entry
                if seq <= entry[0] or seq in entry[1]:
                    # Redelivery of a batch whose reply was lost —
                    # already folded in, ack without re-applying.
                    return {}
                while len(self._metrics_seen) > 4096:
                    self._metrics_seen.pop(
                        next(iter(self._metrics_seen))
                    )
            for rec in msg["records"]:
                try:
                    self._apply_metric_record(rec)
                except Exception as e:
                    # A malformed record (e.g. a hand-rolled
                    # report_step extra whose items aren't
                    # 2-tuples) can never succeed on a retry:
                    # skipping it — visibly, via this ring — is the
                    # only option that neither wedges the sender's
                    # requeue loop nor loses the good records
                    # around it.
                    from .flight_recorder import record as _fr

                    _fr(
                        "metrics.drop",
                        type(e).__name__,
                        0.0,
                        {"error": True, "detail": str(e)[:200]},
                    )
            # Seal the seq only now, with the batch folded in:
            # marking it seen before applying would turn a crash
            # mid-batch into silent permanent loss (the sender's
            # retry of the partially-applied batch would be dropped
            # as a duplicate). Then compact: senders deliver sealed
            # batches in seq order, so the contiguous prefix
            # collapses into the high-water mark and steady state
            # keeps nothing resident per sender but two ints.
            if entry is not None:
                wm, seen = entry[0], entry[1]
                seen.add(seq)
                while wm + 1 in seen:
                    wm += 1
                    seen.discard(wm)
                entry[0] = wm
                if len(seen) > 4096:
                    seen.discard(min(seen))
        return {}

    def _apply_metric_record(self, rec) -> None:
        """Fold ONE metrics-pipe record into the head's tables
        (caller holds self._lock)."""
        kind, name, value, tags = rec[:4]
        if kind == "step":
            # Train-step telemetry rides the metrics pipe as
            # its own record kind: `tags` carries the phase
            # payload (train/telemetry.py), `value` the step
            # index. Stored whole — skew needs per-step,
            # per-rank records, not aggregates.
            record = {
                "step": int(value),
                "time": time.time(),
                **{str(k): v for k, v in tags},
            }
            self._step_records.append(record)
            # Chip·s accounting accumulates at APPEND time (exact):
            # the bounded diagnostic ring can evict records between
            # periodic ledger folds under a fast gang's record rate.
            if self.config.memory_report_interval_s > 0:
                self._memory_ledger.add_step(record)
            return
        if kind == "compile":
            # XLA compile events ride the pipe like step records:
            # `name` is the program, `value` the compile duration,
            # `tags` the digest/shape payload. Folded into the
            # per-program digest ring the storm detector reads;
            # count/duration AGGREGATES arrive separately as the
            # rt_jax_* counter/histogram records.
            from .compile_watch import fold_record

            info = {str(k): v for k, v in tags}
            info["time"] = time.time()
            fold_record(
                self._compile_programs, str(name), float(value), info
            )
            return
        if kind == "transfer":
            # One completed (or aborted) cross-store data movement,
            # reported by the RECEIVING daemon: `name` is the kind
            # (pull / pull_spill / restore / aborted), `value` the
            # byte count, tags carry (dst, job, ms, src). Folded into
            # the ledger's (job, src, dst) transfer matrix.
            if self.config.memory_report_interval_s > 0:
                info = {str(k): v for k, v in tags}
                self._memory_ledger.record_transfer(
                    info.get("job", ""),
                    str(info.get("src", "")),
                    str(info.get("dst", "")),
                    str(name),
                    int(value),
                    ms=float(info.get("ms", 0.0) or 0.0),
                )
            return
        if kind == "get":
            # Worker-side rt.get provenance aggregates (one record per
            # (provenance, src, task) per flush tick — NEVER per get):
            # `name` is the provenance class, `value` the get count,
            # tags carry (bytes, job, ms, node, src, task).
            if self.config.memory_report_interval_s > 0:
                info = {str(k): v for k, v in tags}
                self._memory_ledger.record_gets(
                    info.get("job", ""),
                    str(name),
                    str(info.get("src", "")),
                    str(info.get("node", "")),
                    str(info.get("task", "")),
                    int(value),
                    int(float(info.get("bytes", 0) or 0)),
                    ms=float(info.get("ms", 0.0) or 0.0),
                )
            return
        declared = tuple(rec[4]) if len(rec) > 4 else ()
        tags = tuple(tuple(t) for t in tags)
        entry = self._metrics_table.setdefault(
            name,
            {"kind": kind, "by_tags": {}},
        )
        if declared and "boundaries" not in entry:
            entry["boundaries"] = declared
        # First-seen boundaries win for BOTH bucketing and
        # labels: a same-named histogram re-declared with
        # different boundaries still lands in one
        # consistently-labeled set of buckets.
        boundaries = entry.get("boundaries", ())
        for bucket in (
            entry,
            entry["by_tags"].setdefault(
                tags,
                {},
            ),
        ):
            if kind == "counter":
                bucket["total"] = (
                    bucket.get("total", 0.0) + value
                )
            elif kind == "gauge":
                bucket["value"] = value
            else:  # histogram
                self._observe_histogram(
                    bucket, value, boundaries
                )

    @staticmethod
    def _observe_histogram(
        bucket: dict, value: float, boundaries: tuple
    ) -> None:
        """Fold one observation into a histogram aggregate: running
        count/sum/min/max, Prometheus-style cumulative-le bucket
        counts against the metric's declared boundaries, and a bounded
        sample reservoir (last 1024) for p50/p95/p99 at summary time
        (underscore keys are internal; metrics_summary strips them)."""
        bucket["count"] = bucket.get("count", 0) + 1
        bucket["sum"] = bucket.get("sum", 0.0) + value
        bucket["min"] = min(bucket.get("min", value), value)
        bucket["max"] = max(bucket.get("max", value), value)
        samples = bucket.get("_samples")
        if samples is None:
            samples = bucket["_samples"] = deque(maxlen=1024)
        samples.append(value)
        if boundaries:
            counts = bucket.get("_bucket_counts")
            if counts is None or len(counts) != len(boundaries) + 1:
                counts = bucket["_bucket_counts"] = [0] * (
                    len(boundaries) + 1
                )
            counts[bisect.bisect_left(boundaries, value)] += 1

    @staticmethod
    def _finish_histogram(bucket: dict, boundaries: tuple) -> dict:
        """Wire/user view of a histogram aggregate: percentiles from
        the sample reservoir + named bucket counts; internal keys
        dropped."""
        out = {
            k: v for k, v in bucket.items() if not k.startswith("_")
        }
        samples = bucket.get("_samples")
        if samples:
            ordered = sorted(samples)
            n = len(ordered)

            def pct(p: float) -> float:
                return ordered[
                    min(n - 1, max(0, math.ceil(p * n) - 1))
                ]

            out["p50"] = pct(0.50)
            out["p95"] = pct(0.95)
            out["p99"] = pct(0.99)
        counts = bucket.get("_bucket_counts")
        if boundaries and counts:
            named = {}
            running = 0
            for bound, c in zip(boundaries, counts):
                running += c
                named[f"le_{bound:g}"] = running
            named["inf"] = running + counts[-1]
            out["buckets"] = named
        return out

    def _dag_edge_summary(self) -> dict:
        """Per-edge channel counters for the doctor verdict: for each
        dag/edges.py edge seen by the head, total hops + bytes (summed
        over directions) and send/recv wait percentiles from the
        histogram reservoirs. ``suspect`` names the edge whose
        consumer waits longest at p50 (>= 1 ms and >= 2 edges) — in a
        pipeline that points at the producing stage. Only
        driver-paced pipeline streams (dir fwd/grad) are eligible: a
        compiled-DAG exec loop's input get (dir "dag") also spans
        idle time between execute() calls, which would convict
        healthy stages of merely idle DAGs."""
        edges: dict = {}
        paced: set = set()
        with self._lock:
            for name, field in (
                ("dag_channel_hops_total", "hops"),
                ("dag_channel_bytes_total", "bytes"),
            ):
                entry = self._metrics_table.get(name)
                if not entry:
                    continue
                for tags, bucket in entry["by_tags"].items():
                    edge = dict(tags).get("edge")
                    if edge is None:
                        continue
                    row = edges.setdefault(edge, {})
                    row[field] = row.get(field, 0) + int(
                        bucket.get("total", 0)
                    )
            for name, field in (
                ("dag_channel_send_wait_ms", "send_wait_ms"),
                ("dag_channel_recv_wait_ms", "recv_wait_ms"),
            ):
                entry = self._metrics_table.get(name)
                if not entry:
                    continue
                boundaries = entry.get("boundaries", ())
                for tags, bucket in entry["by_tags"].items():
                    tag_map = dict(tags)
                    edge = tag_map.get("edge")
                    if edge is None:
                        continue
                    if tag_map.get("dir") in ("fwd", "grad"):
                        paced.add(edge)
                    hist = self._finish_histogram(bucket, boundaries)
                    edges.setdefault(edge, {})[field] = {
                        k: hist[k]
                        for k in ("count", "sum", "p50", "p99", "max")
                        if k in hist
                    }
        if not edges:
            return {}
        out: dict = {"edges": edges}
        waits = [
            (row.get("recv_wait_ms", {}).get("p50", 0.0), edge)
            for edge, row in edges.items()
            if edge in paced
        ]
        waits.sort(reverse=True)
        if len(waits) >= 2 and waits[0][0] >= 1.0:
            p50, edge = waits[0]
            out["suspect"] = {
                "edge": edge,
                "recv_wait_p50_ms": p50,
                "detail": (
                    f"edge {edge}: consumer median recv wait "
                    f"{p50:.1f} ms — the producing side is the "
                    "slowest stage of this DAG/pipeline"
                ),
            }
        return out

    def _rl_summary(self) -> dict:
        """Decoupled-RL dataflow series for the doctor verdict: fold
        the rl_* metrics (rollout_queue.py / weight_sync.py /
        dataflow.py) into one view and NAME the bottleneck —
        `learner` when the queue pins at capacity or sheds stale
        fragments (runners outpace the learner), `runners` when the
        learner's polls keep finding the queue empty (actors can't
        feed it), `balanced` otherwise. The same attribution the
        step-telemetry goodput shows as queue_wait stall share."""
        series: dict = {}
        with self._lock:
            for name in (
                "rl_queue_depth",
                "rl_queue_capacity",
                "rl_queue_learner_version",
                "rl_weight_version",
                "rl_weight_lag",
                "rl_env_steps",
            ):
                entry = self._metrics_table.get(name)
                if not entry:
                    continue
                values = [
                    bucket.get("value")
                    for bucket in entry["by_tags"].values()
                    if bucket.get("value") is not None
                ]
                if values:
                    series[name] = max(values)
            for name in (
                "rl_queue_puts_total",
                "rl_queue_gets_total",
                "rl_queue_full_total",
                "rl_queue_throttled_total",
                "rl_queue_stale_dropped_total",
                "rl_queue_empty_gets_total",
                "rl_env_steps_total",
                "rl_learner_updates_total",
            ):
                entry = self._metrics_table.get(name)
                if not entry:
                    continue
                series[name] = sum(
                    bucket.get("total", 0)
                    for bucket in entry["by_tags"].values()
                )
            entry = self._metrics_table.get("rl_weight_sync_ms")
            if entry and entry["by_tags"]:
                bucket = next(iter(entry["by_tags"].values()))
                hist = self._finish_histogram(
                    bucket, entry.get("boundaries", ())
                )
                series["rl_weight_sync_ms"] = {
                    k: hist[k]
                    for k in ("count", "p50", "p99", "max")
                    if k in hist
                }
        if not series:
            return {}
        out: dict = {"series": series}
        puts = series.get("rl_queue_puts_total", 0)
        full = series.get("rl_queue_full_total", 0)
        stale = series.get("rl_queue_stale_dropped_total", 0) + (
            series.get("rl_queue_throttled_total", 0)
        )
        empty = series.get("rl_queue_empty_gets_total", 0)
        gets = series.get("rl_queue_gets_total", 0)
        depth = series.get("rl_queue_depth", 0)
        capacity = series.get("rl_queue_capacity", 0)
        offered = puts + full
        if offered and (
            full >= 0.1 * offered
            or stale >= 0.1 * offered
            or (capacity and depth >= 0.75 * capacity)
        ):
            verdict, detail = "learner", (
                "queue backpressure engaged (full "
                f"{full}/{offered} puts, {stale} stale-gated, depth "
                f"{depth:g}/{capacity:g}) — runners outpace the "
                "learner; scale the learner or raise max_weight_lag"
            )
        elif (gets + empty) and empty >= 0.6 * (gets + empty) and (
            not capacity or depth <= 0.25 * capacity
        ):
            verdict, detail = "runners", (
                f"learner polls found the queue empty {empty}x vs "
                f"{gets} fragments served — actors can't feed it; "
                "add env runners or check policy-inference latency"
            )
        else:
            verdict, detail = "balanced", (
                "queue occupancy and gates show no sustained "
                "one-sided pressure"
            )
        out["bottleneck"] = verdict
        out["detail"] = detail
        return out

    def _h_metrics_summary(self, conn, msg):
        if not self.is_head:
            return self.head.call("metrics_summary")
        from .metric_defs import PIPE_METRICS

        with self._lock:
            out = {}
            for name, entry in self._metrics_table.items():
                boundaries = entry.get("boundaries", ())
                if entry.get("kind") == "histogram":
                    fmt = lambda b: self._finish_histogram(  # noqa: E731
                        b, boundaries
                    )
                else:
                    fmt = dict
                clean = {
                    k: v
                    for k, v in fmt(entry).items()
                    if k != "by_tags"
                }
                clean["by_tags"] = {
                    "|".join(f"{k}={v}" for k, v in tags):
                    fmt(bucket)
                    for tags, bucket in entry["by_tags"].items()
                }
                # Declared pipe metrics carry their metric_defs
                # description so /metrics renders a HELP line.
                declared_meta = PIPE_METRICS.get(name)
                if declared_meta is not None:
                    clean.setdefault("unit", declared_meta[1])
                    clean.setdefault(
                        "description", declared_meta[2]
                    )
                out[name] = clean
        # Core runtime metrics (reference: stats/metric_defs.cc):
        # head scrapes itself; worker nodes' latest snapshots rode
        # heartbeats. Aggregate = sum across nodes, per-node detail
        # under by_node.
        from .metric_defs import (
            CORE_METRICS,
            GAUGE_AGGREGATION,
            collect,
        )

        core_by_node = {self.node_id.hex(): collect(self)}
        for info in self.control.all_nodes():
            if info.is_head or not info.alive:
                continue
            if info.core_metrics:
                core_by_node[info.node_id.hex()] = info.core_metrics
        for name, (kind, unit, desc) in CORE_METRICS.items():
            values = {
                nid: m[name]
                for nid, m in core_by_node.items()
                if name in m
            }
            if not values:
                continue
            entry = {
                "kind": kind,
                "unit": unit,
                "description": desc,
                "by_node": values,
            }
            agg = (
                "sum"
                if kind == "counter"
                else GAUGE_AGGREGATION.get(name, "sum")
            )
            if agg == "max":
                total = max(values.values())
            elif agg == "mean":
                # Request-weighted: an idle node's lifetime mean must
                # not dilute a busy node's.
                weights = {
                    nid: m.get("rt_rpc_requests_total", 0.0)
                    for nid, m in core_by_node.items()
                    if nid in values
                }
                weight_sum = sum(weights.values())
                if weight_sum > 0:
                    total = (
                        sum(
                            values[nid] * weights[nid]
                            for nid in values
                        )
                        / weight_sum
                    )
                else:
                    total = sum(values.values()) / len(values)
            else:
                total = sum(values.values())
            entry["total" if kind == "counter" else "value"] = total
            out[name] = entry
        # Memory-ledger series (rt_job_*, rt_object_owner_*, the
        # transfer matrix): shaped like table entries so the
        # Prometheus exposition and the time-series snapshot loop pick
        # them up without new plumbing. MERGED, not replaced: the
        # ledger's per-job spill/restore tag series must join the core
        # per-node rt_object_spills/restores_total entries already in
        # `out`, not clobber them.
        self._refresh_memory_ledger()
        for name, entry in self._memory_ledger.metric_entries().items():
            existing = out.get(name)
            if existing is None:
                out[name] = entry
            else:
                existing.setdefault("by_tags", {}).update(
                    entry.get("by_tags", {})
                )
        return {"metrics": out}

    def _timeseries_loop(self) -> None:
        """Head-only: append a compacted metric-table snapshot to the
        bounded time-series ring every interval. Snapshots are cheap
        (scalars per series, no reservoirs) and the ring is bounded,
        so this loop costs O(series) per tick forever."""
        interval = self.config.metrics_timeseries_interval_s
        while not self._shutdown:
            time.sleep(interval)
            try:
                self._timeseries_snapshot()
            except Exception:
                # A malformed record set must not kill history for
                # the daemon's lifetime; the next tick retries.
                pass

    def _timeseries_snapshot(self) -> None:
        """Build + append one snapshot: the compacted metric table
        plus the synthetic per-job goodput series (so 'when did
        goodput drop' is answerable from history, not just 'what is
        it now')."""
        from .step_telemetry import goodput_from_records
        from .timeseries import compact_summary

        snapshot = compact_summary(
            self._h_metrics_summary(None, {})["metrics"]
        )
        with self._lock:
            step_records = list(self._step_records)
        goodput = goodput_from_records(step_records)
        if goodput:
            by_tags = {
                f"job={job}": {"value": row["goodput"]}
                for job, row in goodput.items()
            }
            # Top-level scalar = the job that REPORTED most recently
            # (not the one whose first record arrived last): with a
            # finished job B and a still-training job A, the scalar
            # must keep tracking A.
            latest_job = ""
            for rec in reversed(step_records):
                job = str(rec.get("job", ""))
                if job in goodput:
                    latest_job = job
                    break
            row = goodput.get(
                latest_job, next(iter(goodput.values()))
            )
            snapshot["rt_goodput_fraction"] = {
                "kind": "gauge",
                "value": row["goodput"],
                "by_tags": by_tags,
            }
        self._timeseries.append(snapshot)

    def _h_metrics_timeseries(self, conn, msg):
        """Query the head's snapshot ring: optional `name` filters to
        one series, `since` (unix seconds) to newer-than, `limit`
        keeps the newest N. Worker nodes forward to the head."""
        if not self.is_head:
            fwd = {
                k: msg[k]
                for k in ("name", "since", "limit")
                if k in msg
            }
            return self.head.call(
                "metrics_timeseries", timeout=30.0, **fwd
            )
        return {
            "snapshots": self._timeseries.query(
                name=msg.get("name"),
                since=float(msg.get("since", 0.0) or 0.0),
                limit=int(msg.get("limit", 0) or 0),
            ),
            "interval_s": self.config.metrics_timeseries_interval_s,
            "max_snapshots": self._timeseries.max_snapshots,
        }

    # ------------------------------------------------------------------
    # memory ledger (reference: `ray memory` over ObjectTableData +
    # util/state/memory_utils.py; the fold is off-path like the
    # time-series snapshots — no per-seal/per-get work)
    # ------------------------------------------------------------------
    def _node_memory_report(self) -> dict:
        """Fold THIS node's object table into a compact memory report
        (memory_ledger.build_node_report). The lock is held only for
        the tuple snapshot; the fold (size sort, pid probes) runs
        outside it."""
        from .memory_ledger import build_node_report

        with self._lock:
            entries = [
                (
                    oid,
                    e.size,
                    e.owner_job,
                    e.owner,
                    e.owner_pid,
                    e.created_ts,
                    oid in self._primary_pins,
                    e.spilled,
                    e.in_shm,
                )
                for oid, e in self.objects.items()
                if e.in_shm or e.spilled
            ]
        counters = self.core_counters
        with self._lock:
            job_spill_ops = dict(self._job_spill_ops)
            job_restore_ops = dict(self._job_restore_ops)
        return build_node_report(
            self.node_id.hex(),
            entries,
            self.store.size_info(),
            self.spill.stats() if self.spill is not None else None,
            spill_ops=counters.spills,
            restore_ops=counters.restores,
            job_spill_ops=job_spill_ops,
            job_restore_ops=job_restore_ops,
            topk=self.config.memory_report_topk,
        )

    def _memory_report_loop(self) -> None:
        """Every node: fold the local object table into a report each
        `memory_report_interval_s`. Worker nodes push theirs to the
        head (batched off-path, like the metrics pipe); the head folds
        its own straight into the ledger."""
        interval = self.config.memory_report_interval_s
        while not self._shutdown:
            time.sleep(interval)
            try:
                if self.is_head:
                    self._refresh_memory_ledger(max_age_s=0.0)
                elif self.head is not None:
                    self.head.call(
                        "memory_report",
                        report=self._node_memory_report(),
                        timeout=30.0,
                    )
            except Exception:
                # A missed tick is a stale report, never a crash; the
                # next tick re-folds.
                pass

    def _refresh_memory_ledger(self, max_age_s: float = 1.0) -> None:
        """Head only: fold the head's own report into the ledger,
        rate-limited by `max_age_s` so on-demand readers
        (metrics_summary, doctor) stay fresh without re-folding per
        poll. Chip·s accumulates separately, at step-record append
        (`_apply_metric_record`). `memory_report_interval_s=0` is a
        REAL kill switch: on-demand folds stand down too — worker
        nodes aren't reporting, so a head-only fold would dress a
        half-blind ledger up as cluster truth."""
        if not self.is_head or self.config.memory_report_interval_s <= 0:
            return
        now = time.time()
        if now - self._memory_folded_at < max_age_s:
            return
        self._memory_folded_at = now  # rt: noqa[RT201] — rate-limit timestamp: a lost update means one extra idempotent fold in the same window
        self._memory_ledger.fold(self._node_memory_report())

    def _h_memory_report(self, conn, msg):
        """A worker node's periodic memory report (head only; ignored
        when the head's ledger is disabled so a mixed-config cluster
        can't half-populate it)."""
        if not self.is_head or self.config.memory_report_interval_s <= 0:
            return {}
        self._memory_ledger.fold(dict(msg["report"]))
        return {}

    def _h_memory_summary(self, conn, msg):
        """The cluster memory view `ray_tpu_torch memory` / `/api/memory`
        serve: totals + attribution, per-job usage, per-owner bytes,
        top objects, per-node reports, and the doctor's
        `verdict.memory` over the same data."""
        if not self.is_head:
            return self.head.call("memory_summary", timeout=30.0)
        self._refresh_memory_ledger()
        summary = self._memory_ledger.summary()
        summary["verdict"] = self._memory_verdict()
        if self.config.memory_report_interval_s <= 0:
            summary["disabled"] = True
        return {"memory": summary}

    def _h_transfer_summary(self, conn, msg):
        """The cluster transfer matrix `ray_tpu_torch memory --transfers` /
        `/api/transfers` serve: per-(job, src, dst) flows with
        bytes/ms/op counts, per-job get provenance + locality, the
        hottest consumer task classes, and per-job spill/restore ops."""
        if not self.is_head:
            return self.head.call("transfer_summary", timeout=30.0)
        self._refresh_memory_ledger()
        summary = self._memory_ledger.transfer_summary()
        if (
            self.config.memory_report_interval_s <= 0
            or self.config.transfer_report_interval_s <= 0
        ):
            summary["disabled"] = True
        return {"transfers": summary}

    def _h_object_locations(self, conn, msg):
        """Head-side object location/size index (util.state
        .object_locations): which nodes hold a copy of each sealed
        object, its size and owner — the doctor's misplaced-task
        conviction and user-level placement tooling read this instead
        of scraping per-node object tables. Optional `oids` filters to
        specific ids; largest first, `limit` caps rows."""
        if not self.is_head:
            fwd = {
                k: msg[k] for k in ("oids", "limit") if k in msg
            }
            return self.head.call(
                "object_locations", timeout=30.0, **fwd
            )
        limit = int(msg.get("limit", 1000))
        wanted = None
        if msg.get("oids"):
            wanted = {ObjectID(b) for b in msg["oids"]}
        with self._lock:
            entries = [
                (oid, e, tuple(e.locations))
                for oid, e in self.objects.items()
                if e.state == SEALED
                and (wanted is None or oid in wanted)
            ]
        entries.sort(key=lambda item: item[1].size, reverse=True)
        out = []
        for oid, entry, locations in entries[:limit]:
            out.append(
                {
                    "object_id": oid.hex(),
                    "size": entry.size,
                    "inline": entry.inline is not None,
                    "nodes": sorted(
                        NodeID(n).hex() for n in locations
                    ),
                    "spilled": entry.spilled,
                    "job": entry.owner_job,
                    "owner": entry.owner,
                }
            )
        return {"locations": out}

    def _memory_verdict(
        self, leak_age_s: Optional[float] = None
    ) -> dict:
        """`verdict.memory` over the ledger (head only): nodes near
        capacity, leak suspects past the leak deadline, spill
        thrash."""
        ended = {
            info.job_id.hex()
            for info in self.control.jobs.values()
            if info.end_time is not None
        }
        return self._memory_ledger.verdict(
            leak_age_s=(
                self.config.doctor_leak_age_s
                if leak_age_s is None
                else float(leak_age_s)
            ),
            job_ended=lambda job: job in ended,
        )

    def _h_task_event(self, conn, msg):
        """Workers report state events for direct-transport tasks
        (the daemon never sees those specs; reference: workers batch
        task events to the GCS task manager the same way). Completion
        counts may ride the same frame (the worker's flush sends ONE
        notify per drain, not two)."""
        if msg.get("finished") or msg.get("failed"):
            self._h_task_counts(conn, msg)
        if not self.config.task_events_enabled:
            return {}
        if not self.is_head:
            try:
                self.head.notify("task_event", events=msg["events"])
            except RpcError:
                pass
            return {}
        for event in msg["events"]:
            self.control.add_task_event(event)
        return {}

    def _h_task_counts(self, conn, msg):
        """Batched direct-transport completion counts from local
        workers (independent of the disableable task-event stream;
        metric_defs rt_tasks_*_total). Counted on THIS daemon —
        by_node attribution shows where the task ran; daemon-
        scheduled tasks count on the head via _h_task_finished."""
        self.core_counters.bump(
            "tasks_finished", int(msg.get("finished", 0))
        )
        self.core_counters.bump(
            "tasks_failed", int(msg.get("failed", 0))
        )
        return {}

    def _h_span_event(self, conn, msg):
        """Finished tracing spans (util/tracing.span) land in their
        own ring — separate from task events so neither stream can
        evict the other."""
        if not self.is_head:
            try:
                self.head.notify("span_event", spans=msg["spans"])
            except RpcError:
                pass
            return {}
        with self._lock:
            self._spans.extend(msg["spans"])
        return {}

    def _h_list_spans(self, conn, msg):
        limit = int(msg.get("limit", 1000))
        with self._lock:
            return {"spans": list(self._spans)[-limit:]}

    # ------------------------------------------------------------------
    # flight recorder / stall doctor
    # ------------------------------------------------------------------
    def _h_flight_recorder(self, conn, msg):
        """Pull a flight-recorder ring. No routing args: THIS
        process's ring. `pid` alone: a local worker's ring (over its
        direct endpoint). (`node_id`, [`pid`]): routed driver -> head
        -> owning daemon, mirroring profile_worker. Rings are only
        ever pulled — steady-state recording cost stays one deque
        append per event."""
        from .flight_recorder import recorder

        fwd = {
            k: msg[k] for k in ("limit", "kinds", "pid") if k in msg
        }
        reply = self._relay_to_node(
            "flight_recorder", msg.get("node_id"), 30.0, **fwd
        )
        if reply is not None:
            return reply
        pid = msg.get("pid")
        if pid and pid != os.getpid():
            return self._call_worker_direct(
                pid,
                "flight_recorder",
                10.0,
                **{
                    k: msg[k] for k in ("limit", "kinds") if k in msg
                },
            )
        rec = recorder()
        return {
            "pid": os.getpid(),
            "node_id": self.node_id.binary(),
            "records": rec.snapshot(
                limit=msg.get("limit", 0), kinds=msg.get("kinds")
            ),
            "summary": rec.summary(),
        }

    def _h_lock_witness(self, conn, msg):
        """Pull lock-witness state. No routing args: THIS daemon's
        snapshot. `pid`: a local worker's (over its direct endpoint).
        `node_id`: routed driver -> head -> owning daemon. With
        `all_workers`, the daemon folds its own snapshot plus every
        local worker's into one `procs` list — the doctor's one-RPC-
        per-node pull. A disabled process answers {"enabled": False}
        (the witness never turns on implicitly)."""
        from ray_tpu_torch.devtools.lock_witness import snapshot

        fwd = {
            k: msg[k] for k in ("pid", "all_workers") if k in msg
        }
        reply = self._relay_to_node(
            "lock_witness", msg.get("node_id"), 30.0, **fwd
        )
        if reply is not None:
            return reply
        pid = msg.get("pid")
        if pid and pid != os.getpid():
            return self._call_worker_direct(pid, "lock_witness", 10.0)
        own = snapshot()
        own["node_id"] = self.node_id.binary()
        if not msg.get("all_workers"):
            return own
        with self._lock:
            targets = [
                (w.pid, w.direct_address)
                for w in self.workers.values()
            ]
        procs = [own]
        for wpid, addr in targets:
            if not addr:
                continue
            try:
                client = RpcClient(addr, connect_timeout=2.0)
                try:
                    row = client.call("lock_witness", timeout=5.0)
                finally:
                    client.close()
                row["node_id"] = self.node_id.binary()
                procs.append(row)
            except RpcError:
                # An unreachable worker is the doctor's inspect
                # finding, not a witness finding.
                continue
        return {"procs": procs}

    def _h_worker_inspect(self, conn, msg):
        """Current in-flight tasks of every local worker (with
        `node_id`: of another node's workers), pulled from each
        worker's `inspect` direct endpoint. The doctor's hung-task
        source: direct-transport tasks report state events only at
        completion, so an in-flight hang is visible ONLY here."""
        reply = self._relay_to_node(
            "worker_inspect", msg.get("node_id"), 30.0
        )
        if reply is not None:
            return reply
        with self._lock:
            targets = [
                (w.pid, w.direct_address)
                for w in self.workers.values()
            ]

        def probe(target) -> dict:
            pid, addr = target
            row: dict = {"pid": pid, "node_id": self.node_id.binary()}
            if addr:
                try:
                    client = RpcClient(addr, connect_timeout=2.0)
                    try:
                        reply = client.call("inspect", timeout=5.0)
                    finally:
                        client.close()
                    row["inflight"] = reply.get("inflight", [])
                    row["queued"] = reply.get("queued", 0)
                except RpcError as e:
                    # Only a worker STILL registered after the failed
                    # probe is a finding — one that deregistered in
                    # between (idle reap, pool churn) hit a normal
                    # lifecycle race, not a hang.
                    with self._lock:
                        still_registered = any(
                            w.pid == pid
                            and w.direct_address == addr
                            for w in self.workers.values()
                        )
                    if still_registered:
                        row["error"] = str(e)
                    else:
                        row["exited"] = True
            return row

        return {"workers": self._parallel_map(probe, targets)}

    def _h_step_summary(self, conn, msg):
        """Gang-step telemetry digest (head): per-worker step-time
        stats and per-step skew (max - min step_ms across workers of
        the same step index) — the number that says WHICH worker the
        gang is waiting on (PAPERS: Podracer gang-step skew)."""
        if not self.is_head:
            return self.head.call(
                "step_summary",
                limit=msg.get("limit", 1000),
                records=msg.get("records", False),
            )
        limit = int(msg.get("limit", 1000))
        with self._lock:
            records = list(self._step_records)[-limit:]
        from .step_telemetry import goodput_from_records

        summary = _summarize_steps(records)
        # Per-JOB goodput over the same window (summary stats are
        # most-recent-job only; goodput keeps every job apart so
        # concurrent tenants each get their own fraction).
        summary["goodput"] = goodput_from_records(records)
        reply = {"summary": summary}
        if msg.get("records"):
            # Raw per-step dicts are opt-in: summary readers (the
            # dashboard's steady-state poll among them) shouldn't pay
            # for up to `limit` records they discard.
            reply["records"] = records
        return reply

    def _h_diagnose(self, conn, msg):
        """Stall doctor: fold head task state, per-worker in-flight
        views, step telemetry, and flight-recorder digests into one
        verdict — stragglers (median step time > cluster p50 x
        threshold), hung tasks (in flight / RUNNING past a deadline,
        with the offender's stack auto-captured through the profile
        relay), and dead nodes. Served by the head; operator-driven,
        so the cluster-wide pulls happen HERE, never in steady
        state."""
        if not self.is_head:
            fwd = {
                k: msg[k]
                for k in (
                    "hung_task_s",
                    "straggler_threshold",
                    "capture_stacks",
                    "limit",
                    "leak_age_s",
                    "locality_miss_threshold",
                )
                if k in msg
            }
            return self.head.call("diagnose", timeout=120.0, **fwd)
        hung_s = float(
            msg.get("hung_task_s", self.config.doctor_hung_task_s)
        )
        threshold = float(
            msg.get(
                "straggler_threshold",
                self.config.doctor_straggler_threshold,
            )
        )
        capture = bool(msg.get("capture_stacks", True))
        now = time.time()
        problems: list = []

        # Dead nodes first: everything else is noise if the gang lost
        # a member.
        for info in self.control.all_nodes():
            if not info.alive:
                problems.append(
                    {
                        "kind": "dead_node",
                        "node_id": info.node_id.hex(),
                        "detail": (
                            f"node {info.node_id.hex()[:12]} stopped "
                            "heartbeating"
                        ),
                    }
                )

        # Stragglers from step telemetry — same default window as
        # step_summary, so the two surfaces agree on the same
        # cluster (the full 10k ring would keep convicting a worker
        # that was slow thousands of steps ago and has recovered).
        limit = int(msg.get("limit", 1000))
        with self._lock:
            step_records = list(self._step_records)[-limit:]
        steps = _summarize_steps(step_records)
        from .step_telemetry import goodput_from_records

        # Per-job goodput classification over the same window the
        # straggler stats use, so both surfaces describe one cluster.
        steps["goodput"] = goodput_from_records(step_records)

        # Compiled-DAG / MPMD-pipeline channel edges: fold the
        # dag_channel_* metrics (dag/edges.py) into per-edge rows so
        # a straggler STAGE is named like a straggler rank — the edge
        # whose consumer sits longest in recv names its PRODUCER as
        # the slow side.
        dag = self._dag_edge_summary()
        # Decoupled-RL dataflow: queue levels/gates + weight versions
        # folded into an actor-vs-learner bottleneck attribution.
        rl = self._rl_summary()
        # XLA layer: recompile storms from the head's per-program
        # digest rings and HBM pressure from the step records' device
        # memory fields — promoted to problems so the exit-code
        # contract covers the compiler too (a storm IS a sick
        # cluster: every flagged iteration burns seconds of compile).
        compile_verdict = self._compile_verdict(
            step_records,
            threshold=msg.get("compile_storm_threshold"),
        )
        for storm in compile_verdict.get("storms", ()):
            problem = {
                "kind": "recompile_storm",
                "program": storm["program"],
                "compiles": storm["compiles"],
                "distinct_shapes": storm["distinct_shapes"],
                "delta": storm["delta"],
                "detail": storm["detail"],
            }
            # Static bridge: resolve the storming program name against
            # the accel-pass inventory so the verdict names the RT302
            # source line, not just the symptom. Best-effort — a
            # missing/odd inventory must never break diagnose.
            try:
                from .compile_watch import static_hint

                hint = static_hint(storm["program"])
            except Exception:  # noqa: BLE001
                hint = None
            if hint:
                problem["static_hint"] = hint
            problems.append(problem)
        for row in compile_verdict.get("hbm_pressure", ()):
            problems.append(
                {
                    "kind": "hbm_pressure",
                    "rank": row["rank"],
                    "fraction": row["fraction"],
                    "detail": row["detail"],
                }
            )
        # Memory ledger: near-capacity nodes, leak suspects past the
        # leak deadline, spill thrash — each promoted to a problem so
        # the exit-code contract covers memory health too.
        leak_age_s = float(
            msg.get("leak_age_s", self.config.doctor_leak_age_s)
        )
        self._refresh_memory_ledger(max_age_s=0.0)
        memory = self._memory_verdict(leak_age_s=leak_age_s)
        for row in memory.get("near_capacity", ()):
            problems.append(
                {
                    "kind": "node_near_capacity",
                    "node_id": row["node"],
                    "fraction": row["fraction"],
                    "detail": row["detail"],
                }
            )
        for row in memory.get("leak_suspects", ()):
            problems.append(
                {
                    "kind": "object_leak",
                    "object_id": row["object_id"],
                    "node_id": row["node"],
                    "job": row["job"],
                    "owner": row["owner"],
                    "size": row["size"],
                    "age_s": row["age_s"],
                    "detail": row["detail"],
                }
            )
        for row in memory.get("spill_thrash", ()):
            problems.append(
                {
                    "kind": "spill_thrash",
                    "node_id": row["node"],
                    "detail": row["detail"],
                }
            )
        # Data plane: the transfer matrix folded from get/transfer
        # records names the hottest cross-node flow, classifies each
        # job's data_wait as pull- vs restore-dominated, and convicts
        # misplaced task classes — a consumer pulling most of its
        # bytes from a node that had capacity to run it is a
        # scheduling bug an operator can fix, so it exits 1.
        locality_threshold = float(
            msg.get(
                "locality_miss_threshold",
                self.config.doctor_locality_miss_threshold,
            )
        )

        def _node_has_capacity(node_hex: str) -> bool:
            for info in self.control.alive_nodes():
                if info.node_id.hex() != node_hex:
                    continue
                if info.available:
                    return info.available.get("CPU", 0.0) >= 1.0
                return info.resources.get("CPU", 0.0) >= 1.0
            return False

        data = self._memory_ledger.data_verdict(
            locality_miss_threshold=locality_threshold,
            node_has_capacity=_node_has_capacity,
        )
        for row in data.get("misplaced_tasks", ()):
            problems.append(
                {
                    "kind": "misplaced_task",
                    "task": row["task"],
                    "job": row["job"],
                    "src_node": row["src"],
                    "remote_bytes": row["remote_bytes"],
                    "remote_fraction": row["remote_fraction"],
                    "detail": row["detail"],
                }
            )
        workers = steps.get("workers", {})
        if len(workers) >= 2:
            medians = sorted(
                w["p50_step_ms"] for w in workers.values()
            )
            # LOWER median: with an even worker count the upper
            # median is the straggler's own time (2 workers: the slow
            # one could never exceed threshold x itself).
            cluster_p50 = medians[(len(medians) - 1) // 2]
            for rank in sorted(workers):
                w = workers[rank]
                if (
                    cluster_p50 > 0
                    and w["steps"] >= 3
                    and w["p50_step_ms"] > threshold * cluster_p50
                ):
                    problems.append(
                        {
                            "kind": "straggler",
                            "rank": rank,
                            "p50_step_ms": w["p50_step_ms"],
                            "cluster_p50_ms": round(cluster_p50, 3),
                            "ratio": round(
                                w["p50_step_ms"] / cluster_p50, 2
                            ),
                            "detail": (
                                f"worker rank {rank} median step "
                                f"{w['p50_step_ms']:.1f} ms vs "
                                f"cluster p50 {cluster_p50:.1f} ms "
                                f"(x{w['p50_step_ms'] / cluster_p50:.1f}"
                                f" > x{threshold:g} threshold)"
                            ),
                        }
                    )

        # Hung tasks, source 1: live in-flight views pulled from every
        # worker on every node.
        inspects: list = []
        ring_digests: dict = {}
        try:
            inspects.extend(
                self._h_worker_inspect(conn, {})["workers"]
            )
        except Exception as e:  # noqa: BLE001 — folded into verdict
            # A head that cannot inspect its own workers is itself a
            # finding — the verdict reports it rather than dying.
            problems.append(
                {
                    "kind": "unreachable_node",
                    "node_id": self.node_id.hex(),
                    "detail": f"head worker inspect failed: {e!r}",
                }
            )
        from .flight_recorder import recorder as _fr

        ring_digests[self.node_id.hex()] = _fr().summary()
        remote = []
        for info in self.control.alive_nodes():
            nid = info.node_id.binary()
            if nid == self.node_id.binary():
                continue
            client = self._node_client(nid)
            if client is not None:
                remote.append((info.node_id.hex(), client))

        witness_procs: list = []
        try:
            own = self._h_lock_witness(conn, {"all_workers": True})
            witness_procs.extend(own.get("procs", [own]))
        except Exception as e:  # diagnose still replies; the gap is folded into the verdict below, not dropped
            problems.append(
                {
                    "kind": "unreachable_node",
                    "node_id": self.node_id.hex(),
                    "detail": f"head lock-witness pull failed: {e!r}",
                }
            )

        def pull_node(target):
            # A node's calls run sequentially on its own (dedicated)
            # client; nodes pull concurrently.
            node_hex, client = target
            try:
                workers = client.call(
                    "worker_inspect", timeout=30.0
                )["workers"]
                summary = client.call(
                    "flight_recorder", timeout=15.0, limit=1
                )["summary"]
                witness = client.call(
                    "lock_witness", timeout=15.0, all_workers=True
                ).get("procs", [])
                return node_hex, workers, summary, witness, None
            except RpcError as e:
                return node_hex, [], None, [], str(e)

        for (
            node_hex,
            workers,
            summary,
            witness,
            err,
        ) in self._parallel_map(pull_node, remote):
            if err is not None:
                problems.append(
                    {
                        "kind": "unreachable_node",
                        "node_id": node_hex,
                        "detail": f"inspect failed: {err}",
                    }
                )
                continue
            inspects.extend(workers)
            ring_digests[node_hex] = summary
            witness_procs.extend(witness)
        # Lock-order witness: any process whose RECORDED acquisition
        # graph contains a cycle has already interleaved lock orders
        # that can deadlock — promoted to a problem (doctor exits 1)
        # with both sides' acquiring stacks.
        locks = self._lock_verdict(witness_procs)
        for row in locks["cycles"]:
            problems.append(
                {
                    "kind": "lock_order_inversion",
                    "node_id": row["node_id"],
                    "pid": row["pid"],
                    "locks": row["locks"],
                    "legs": row["legs"],
                    "detail": row["detail"],
                }
            )
        # A task that reported step telemetry within the deadline is
        # making progress — a long-lived in-flight train loop, not a
        # hang (a gang fit task runs ONE task for the whole job;
        # flagging it would page on every healthy run). Keyed by TASK
        # id where the record carries one, so a concurrent actor's
        # OTHER, genuinely wedged call is still caught; (node, pid)
        # only covers records from outside any task (hand-rolled
        # loops).
        progressing_tasks: set = set()
        progressing_procs: set = set()
        for rec in step_records:
            if float(rec.get("time", 0.0)) < now - hung_s:
                continue
            if rec.get("task"):
                progressing_tasks.add(str(rec["task"]))
            elif rec.get("pid") is not None:
                progressing_procs.add(
                    (str(rec.get("node", "")), int(rec["pid"]))
                )
        to_capture: list = []
        for row in inspects:
            if row.get("error"):
                problems.append(
                    {
                        "kind": "unresponsive_worker",
                        "pid": row["pid"],
                        "node_id": NodeID(row["node_id"]).hex(),
                        "detail": (
                            f"worker pid {row['pid']} did not answer "
                            f"inspect: {row['error']}"
                        ),
                    }
                )
                continue
            proc_progressing = (
                NodeID(row["node_id"]).hex(),
                row["pid"],
            ) in progressing_procs
            for task in row.get("inflight", []):
                if task.get("age_s", 0.0) <= hung_s:
                    continue
                if (
                    proc_progressing
                    or task["task_id"] in progressing_tasks
                ):
                    continue
                problem = {
                    "kind": "hung_task",
                    "task_id": task["task_id"],
                    "name": task.get("name", ""),
                    "age_s": task["age_s"],
                    "pid": row["pid"],
                    "node_id": NodeID(row["node_id"]).hex(),
                    "detail": (
                        f"task {task.get('name') or task['task_id'][:12]}"
                        f" has run {task['age_s']:.1f}s on pid "
                        f"{row['pid']} (> {hung_s:g}s deadline)"
                    ),
                }
                if capture:
                    to_capture.append((problem, row))
                problems.append(problem)
        if to_capture:
            # Auto-capture every offender's stacks through the SAME
            # profile relay the gang profiler uses (_profile_target —
            # one start/stop/collect implementation) — the dump an
            # operator would ask for next, taken while it still shows
            # the hang.
            def capture_stack(target):
                problem, row = target
                try:
                    reply = self._profile_target(
                        row["node_id"], row["pid"], 35.0, kind="stack"
                    )
                    problem["stack"] = reply.get("stacks", "")
                except Exception as e:  # noqa: BLE001 — verdict survives
                    problem["stack_error"] = repr(e)

            self._parallel_map(capture_stack, to_capture)

        # Hung tasks, source 2: the head event stream — catches
        # daemon-scheduled tasks whose RUNNING event landed at
        # dispatch but whose worker stopped reporting. Tasks visible
        # in ANY live worker's in-flight view were already judged by
        # source 1 (deadline + step-progress exemption) — source 2
        # only fires for RUNNING tasks NO reachable worker claims,
        # a premise that only holds when EVERY node was probed and
        # answered: with a failed probe, an unreachable node, or a
        # DEAD node (its workers were never probed at all — a task
        # last seen RUNNING there is lost with it, not hung) the
        # unclaimed task may simply live behind the gap (already
        # reported as its own problem), and task events carry no
        # node/pid to tell.
        view_complete = not any(
            row.get("error") for row in inspects
        ) and not any(
            p["kind"] in ("unreachable_node", "dead_node")
            for p in problems
        )
        seen = {
            p["task_id"]
            for p in problems
            if p["kind"] == "hung_task"
        }
        seen.update(
            task["task_id"]
            for row in inspects
            if not row.get("error")
            for task in row.get("inflight", [])
        )
        latest: dict = {}
        for event in self.control.list_task_events(10000):
            latest[event["task_id"]] = event
        for tid, event in latest.items():
            if (
                not view_complete
                or event["state"] != "RUNNING"
                or tid in seen
                or now - event["time"] <= hung_s
            ):
                continue
            problems.append(
                {
                    "kind": "hung_task",
                    "task_id": tid,
                    "name": event.get("name", ""),
                    "age_s": round(now - event["time"], 1),
                    "detail": (
                        f"task {event.get('name') or tid[:12]} has "
                        f"been RUNNING {now - event['time']:.1f}s "
                        "with no further state transition"
                    ),
                }
            )

        summary = self.control.summary()
        return {
            "verdict": {
                "healthy": not problems,
                "problems": problems,
                "steps": steps,
                "dag": dag,
                "rl": rl,
                "compile": compile_verdict,
                "memory": memory,
                "data": data,
                "locks": locks,
                "rpc": ring_digests,
                "nodes": {
                    "total": summary["nodes"],
                    "alive": summary["alive_nodes"],
                },
                "params": {
                    "hung_task_s": hung_s,
                    "straggler_threshold": threshold,
                    "leak_age_s": leak_age_s,
                    "locality_miss_threshold": locality_threshold,
                },
            }
        }

    def _lock_verdict(self, procs: list) -> dict:
        """`verdict.locks`: cluster-wide fold of per-process
        lock-witness snapshots — observed order-graph cycles (each leg
        carries the stack that first created that edge) and
        held-while-blocking ledgers. Empty/disabled processes fold to
        a quiet verdict; `enabled` says whether ANY process ran the
        witness, so a clean verdict with the witness off is not
        mistaken for a clean run."""
        enabled_procs = [p for p in procs if p.get("enabled")]
        cycles: list = []
        blocking: list = []
        dropped = 0
        for proc in enabled_procs:
            node_hex = NodeID(proc["node_id"]).hex()
            pid = proc.get("pid")
            dropped += int(proc.get("dropped_edges", 0))
            for legs in proc.get("cycles", ()):
                names = [leg["from"] for leg in legs]
                cycles.append(
                    {
                        "node_id": node_hex,
                        "pid": pid,
                        "locks": names,
                        "legs": legs,
                        "detail": (
                            f"pid {pid} on node {node_hex[:12]} "
                            "acquired locks in a cyclic order: "
                            + " -> ".join(names + names[:1])
                        ),
                    }
                )
            for row in proc.get("held_blocking", ()):
                blocking.append(
                    dict(row, node_id=node_hex, pid=pid)
                )
        return {
            "enabled": bool(enabled_procs),
            "procs": len(enabled_procs),
            "cycles": cycles,
            "held_blocking": blocking,
            "dropped_edges": dropped,
        }

    def _compile_verdict(
        self, step_records: list, threshold=None
    ) -> dict:
        """`verdict.compile`: per-program compile counts, recompile
        storms (same program, >= threshold distinct shape digests —
        the drifting-shape retrace loop), and HBM pressure (latest
        per-(job, rank) device-memory report >= 90% of capacity).
        Caller must NOT hold self._lock."""
        from .compile_watch import detect_storms

        threshold = int(
            threshold
            if threshold is not None
            else self.config.compile_storm_threshold
        )
        with self._lock:
            programs = {
                name: {
                    "compiles": row["compiles"],
                    "total_ms": round(row["total_ms"], 3),
                    "distinct_shapes": len(row["digests"]),
                }
                for name, row in self._compile_programs.items()
            }
            storms = detect_storms(self._compile_programs, threshold)
        out: dict = {
            "programs": programs,
            "storms": storms,
            "storm_threshold": threshold,
            "hbm_pressure": [],
        }
        # HBM pressure: newest RECENT record per (job, rank) that
        # carries both in-use and limit; absent fields (CPU)
        # contribute nothing — never synthesized. The recency cutoff
        # keeps a finished job's final 92%-HBM records (which sit in
        # the bounded ring until new traffic evicts them) from
        # flipping an idle cluster's doctor to exit 1 forever.
        cutoff = time.time() - 120.0
        latest: Dict[tuple, dict] = {}
        for rec in step_records:
            if "hbm_bytes_in_use" not in rec:
                continue
            if float(rec.get("time", 0.0)) < cutoff:
                continue
            key = (str(rec.get("job", "")), int(rec.get("rank", 0)))
            if float(rec.get("time", 0.0)) >= float(
                latest.get(key, {}).get("time", -1.0)
            ):
                latest[key] = rec
        for (job, rank), rec in sorted(latest.items()):
            limit = int(rec.get("hbm_bytes_limit", 0) or 0)
            in_use = int(rec.get("hbm_bytes_in_use", 0) or 0)
            if limit <= 0:
                continue
            fraction = in_use / limit
            if fraction >= 0.9:
                out["hbm_pressure"].append(
                    {
                        "rank": rank,
                        "job": job,
                        "bytes_in_use": in_use,
                        "bytes_limit": limit,
                        "fraction": round(fraction, 4),
                        "detail": (
                            f"rank {rank} HBM at "
                            f"{100.0 * fraction:.1f}% of capacity "
                            f"({in_use / 2**30:.2f} / "
                            f"{limit / 2**30:.2f} GiB) — next "
                            "allocation or fragmentation spike OOMs "
                            "this rank"
                        ),
                    }
                )
        return out

    def _record_task_event(self, spec: dict, state: str) -> None:
        if state == "RETRY":
            self.core_counters.bump("tasks_retried")
        if not self.config.task_events_enabled:
            return
        if not self.is_head:
            return  # head records events from task_finished reports
        self.control.add_task_event(
            {
                "task_id": spec["task_id"].hex()
                if isinstance(spec["task_id"], bytes)
                else str(spec["task_id"]),
                "name": spec.get("name", ""),
                "kind": spec.get("kind", "normal"),
                "state": state,
                "time": time.time(),
            }
        )

    # ------------------------------------------------------------------
    def kill_worker_tree(self) -> None:
        """SIGKILL every worker process this daemon spawned, plus its
        fork-server, with only a brief bounded reap. Safe to call from
        any state — including a partially-wedged runtime: a 7000-worker
        teardown must not depend on the driver's shutdown path
        completing (a saturated 1-core box once wedged there with the
        whole worker tree pinning the pid table). Kills go through the
        proc HANDLES (Popen no-ops on already-reaped children;
        ForkedProc compares /proc start times), never raw recorded
        pids — a recycled pid must not take down a stranger."""
        self._shutdown = True
        procs = list(self._worker_procs)
        for proc in procs:
            try:
                proc.kill()
            except Exception:
                pass
        # Best-effort non-blocking reap so the killed children release
        # their pid-table slots even if the graceful shutdown path
        # never runs (ForkedProc children are the fork-server's to
        # reap — closing it below reparents them to init).
        deadline = time.monotonic() + 1.0
        for proc in procs:
            if time.monotonic() > deadline:
                break
            try:
                proc.poll()
            except Exception:
                pass
        if self._fork_server is not None:
            try:
                self._fork_server.close()
            except Exception:
                pass

    def shutdown(self) -> None:
        self._shutdown = True
        # Stop the heartbeat/reaper thread before closing the store:
        # its reap_dead_pins must not race the arena unmap.
        hb = getattr(self, "_hb_thread", None)
        if hb is not None and hb.is_alive():
            hb.join(timeout=self.config.heartbeat_interval_s + 1.0)
        if self._memory_monitor is not None:
            self._memory_monitor.stop()
        for proc in self._worker_procs:
            try:
                proc.kill()
            except ProcessLookupError:
                pass
        # Bounded TOTAL wait, not per-proc: a per-proc 2s timeout sums
        # to hours across a 7k-worker pool on a loaded box (each stale
        # handle that looks alive burns its full slice); the kill
        # above already guarantees death.
        wait_deadline = time.monotonic() + 10.0
        for proc in self._worker_procs:
            remaining = wait_deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                proc.wait(timeout=min(2.0, remaining))
            except subprocess.TimeoutExpired:
                pass
        # Whatever the deadline cut off still gets a non-blocking reap:
        # SIGKILLed-but-unwaited Popen children of this (long-lived,
        # in-process) daemon host would otherwise sit as zombies
        # pinning pid-table slots.
        for proc in self._worker_procs:
            try:
                proc.poll()
            except Exception:
                pass
        if self._fork_server is not None:
            self._fork_server.close()
        if self.head is not None:
            try:
                self.head.close()
            except Exception:
                pass
        for client in list(self._node_clients.values()) + list(
            self._peer_clients.values()
        ):
            try:
                client.close()
            except Exception:
                pass
        # Detach (never unlink) peers' arenas: the files belong to
        # their daemons.
        for arena in self._peer_arenas.values():
            try:
                arena.close(unlink=False)
            except Exception:
                pass
        self._peer_arenas.clear()
        self.server.close()
        # Reclaim every live shared-memory object of the session.
        with self._lock:
            shm_oids = [
                oid for oid, e in self.objects.items() if e.in_shm
            ]
        with self._lock:
            pinned = list(self._primary_pins)
        for oid in set(pinned) | set(shm_oids):
            self._drop_local_copy(oid)
        self.store.shutdown()
        if self.spill is not None:
            self.spill.shutdown()


class _CallbackConn:
    """Adapter so wait-waiters can sit in ObjectEntry.waiters."""

    def __init__(self, callback):
        self._callback = callback

    def reply(self, mid, payload):
        self._callback()


def _default_store_bytes() -> int:
    try:
        import psutil  # noqa: PLC0415

        total = psutil.virtual_memory().total
    except Exception:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(total * 0.3)
