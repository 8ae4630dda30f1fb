# Copied from ray_tpu/_private/worker.py (JAX-free): module names read ray_tpu_torch.
"""CoreWorker — the per-process runtime for drivers and workers.

Plays the role of the reference's C++ CoreWorker (reference:
src/ray/core_worker/core_worker.h:162 — SubmitTask, CreateActor:876,
SubmitActorTask:930, Put:462, Get:646, Wait:685 — bound into Python via
python/ray/_raylet.pyx:2949). One instance per process; drivers use the
submit/get surface, workers additionally run the task execution loop
(reference: CoreWorkerProcess::RunTaskExecutionLoop,
core_worker_process.h:98).

Differences from the reference by design: small objects and task specs
flow through the node daemon instead of worker-to-worker gRPC (single
socket hop on-node), while large objects go straight into shared
memory and only seal notifications hit the daemon.
"""

from __future__ import annotations

import contextvars
import inspect
import itertools
import os
import queue
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import exceptions as exc
from ..devtools.lock_witness import make_lock
from ..object_ref import ObjectRef
from .config import Config
from .flight_recorder import recorder as _flight
from .function_manager import FunctionManager
from .ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from .object_store import ObjectStoreFullError, make_store
from .rpc import RpcClient, RpcError
from .serialization import SerializationContext
from .task_spec import (
    make_error_payload,
    make_exception_payload,
    raise_from_payload,
)

_global_worker: Optional["CoreWorker"] = None
_global_lock = threading.Lock()  # rt: noqa[RT004] — held for one pointer swap; forked children re-init the worker

#: Marker used to ship kwargs as a trailing positional arg (specs carry
#: a flat arg list; see api_internal._flatten_args).
KWARGS_MARKER = "__kwargs__"

#: Reusable stateless context for tasks with no runtime env (the
#: overwhelming hot path): nullcontext holds no per-entry state, so
#: one instance serves every task.
import contextlib as _contextlib  # noqa: E402

_NULL_CTX = _contextlib.nullcontext()

#: The anonymous session namespace (reference: ray's job config uses
#: an empty/anonymous namespace unless ray.init(namespace=...) names
#: one). Named here once; everywhere else resolves through the
#: session/job context rather than repeating the literal (RT006).
DEFAULT_NAMESPACE = "default"


def _split_kwargs(flat):
    if (
        flat
        and isinstance(flat[-1], tuple)
        and len(flat[-1]) == 2
        and flat[-1][0] == KWARGS_MARKER
    ):
        return list(flat[:-1]), dict(flat[-1][1])
    return list(flat), {}


#: Task identity inside async actor coroutines (thread-locals don't
#: cross onto the shared event-loop thread; see _run_coroutine).
_ASYNC_TASK_ID: contextvars.ContextVar = contextvars.ContextVar(
    "rt_async_task_id", default=None
)


_current_span_context = None


def _trace_ctx() -> Optional[dict]:
    """Current span context for remote propagation (reference: ray's
    OTel integration injects the span context into task metadata)."""
    global _current_span_context
    if _current_span_context is None:  # one-time import, off hot path
        from ..util.tracing import current_span_context

        _current_span_context = current_span_context
    ctx = _current_span_context()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


def global_worker() -> Optional["CoreWorker"]:
    return _global_worker


def set_global_worker(worker: Optional["CoreWorker"]) -> None:
    global _global_worker
    with _global_lock:
        _global_worker = worker


class _TaskContext(threading.local):
    """Per-thread submission context. Each driver thread gets its own
    base task id so concurrent threads can't derive colliding task/put
    ids (the reference gives non-main threads random TaskIDs too)."""

    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.thread_base_id: TaskID = TaskID.from_random()
        self.put_index = 0
        self.submit_index = 0
        # Placement-group capture context of the currently executing
        # task: child submits inherit it (reference: actor.py:890
        # placement_group_capture_child_tasks).
        self.pg_context: Optional[dict] = None
        #: Set by _serialize_ref_arg when the spec being built carries
        #: a still-pending direct result as an arg — such specs must
        #: ride their own frame (see direct._Pending.solo).
        self.pending_direct_dep = False
        #: Name of the task CLASS currently executing on this thread
        #: ("" on the driver): get-provenance aggregates key on it so
        #: the doctor can convict a misplaced task class, never an id.
        self.task_name = ""


_worker_generation = itertools.count()


class _BatchReply:
    """Streams per-spec outcomes of one `execute_tasks` frame back to
    the submitter. Outcomes accumulate and flush as PARTIAL reply
    frames (`_part=True`, callback stays registered client-side) when
    64 pile up, when the owning worker's 2ms batch flusher fires, or
    — final frame, no `_part` — when the last spec completes. Eager
    flushing is what keeps a batch from head-of-line-blocking its own
    results: a quick spec's outcome reaches the driver (and its
    `wait()`ers) within ~2ms even while a slow spec later in the same
    frame is still running. Sends happen INSIDE the lock so the final
    frame can never overtake a straggling partial on the socket."""

    __slots__ = ("_conn", "_mid", "_pending", "_remaining", "_lock",
                 "_flusher")

    FLUSH_COUNT = 64

    def __init__(self, conn, mid, n: int, flusher=None):
        self._conn = conn
        self._mid = mid
        self._pending: List[tuple] = []
        self._remaining = n
        self._lock = threading.Lock()
        self._flusher = flusher

    def slot(self, index: int) -> "_BatchSlot":
        return _BatchSlot(self, index)

    def _complete(self, index: int, payload: dict) -> None:
        arm = False
        with self._lock:
            self._pending.append((index, payload))
            self._remaining -= 1
            done = self._remaining == 0
            if done:
                parts, self._pending = self._pending, []
                self._conn.reply(self._mid, {"parts": parts})
            elif len(self._pending) >= self.FLUSH_COUNT:
                parts, self._pending = self._pending, []
                self._conn.reply(
                    self._mid, {"parts": parts, "_part": True}
                )
            else:
                arm = True
        if done and self._flusher is not None:
            self._flusher.forget(self)
        elif arm and self._flusher is not None:
            self._flusher.arm(self)

    def flush_partial(self) -> None:
        """Timer-driven flush of whatever has completed so far."""
        with self._lock:
            if not self._pending or self._remaining == 0:
                return
            parts, self._pending = self._pending, []
            self._conn.reply(self._mid, {"parts": parts, "_part": True})


class _BatchSlot:
    """reply_to handle for one spec inside a batch: quacks like the
    (conn, mid) deferred-reply pair `_execute` already services."""

    __slots__ = ("_batch", "_index")

    def __init__(self, batch: _BatchReply, index: int):
        self._batch = batch
        self._index = index

    def reply(self, payload: dict) -> None:
        self._batch._complete(self._index, payload)


class _BatchFlusher:
    """One parked thread per worker process flushing batches whose
    outcomes sit pending behind a long-running spec: armed on the
    first unflushed outcome, it wakes ~2ms later and ships whatever
    has completed. Idle (parked on the event) whenever inline flushes
    keep up — the nop-flood hot path never pays for it."""

    def __init__(self):
        self._evt = threading.Event()
        self._lock = threading.Lock()
        self._armed: set = set()
        self._thread: Optional[threading.Thread] = None

    def arm(self, batch: _BatchReply) -> None:
        with self._lock:
            self._armed.add(batch)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="rt-batch-flusher",
                )
                self._thread.start()
        self._evt.set()

    def forget(self, batch: _BatchReply) -> None:
        with self._lock:
            self._armed.discard(batch)

    def _loop(self) -> None:
        while True:
            self._evt.wait()  # rt: noqa[RT008] — deliberate park; arm() sets the event
            self._evt.clear()
            time.sleep(0.002)
            with self._lock:
                batches, self._armed = list(self._armed), set()
            for batch in batches:
                try:
                    batch.flush_partial()
                except Exception:
                    pass


class CoreWorker:
    def __init__(self, socket_path: str, role: str = "driver"):
        self.role = role
        #: Default namespace for named-actor APIs in THIS process.
        #: The driver's is set from rt.init(namespace=...); worker
        #: processes inherit the submitting driver's namespace through
        #: the task/actor spec (`ns_ctx`, applied in _execute) so
        #: in-task get_actor()/named-actor creation resolves against
        #: the session namespace (reference: the job config propagates
        #: ray_namespace to every worker of the job). The explicit
        #: namespace= escape hatch on the APIs remains.
        self.namespace = DEFAULT_NAMESPACE
        #: Namespace context the actor hosted by this worker was
        #: created under; actor tasks restore it (actors keep their
        #: creating job's namespace for life).
        self._actor_namespace: Optional[str] = None
        # Unique per-process token for session-scoped caches (unlike
        # id(), never reused after this worker is collected).
        self.generation = next(_worker_generation)
        # Execution state must exist before the RPC client starts its
        # reader thread: the daemon may push execute_task immediately
        # after (even before) the register reply.
        self._task_queue: "queue.Queue" = queue.Queue()
        #: task_id hex -> {name, kind, started} for every task this
        #: process is executing right now (concurrent actors may hold
        #: several). Read by the `inspect` direct handler — the
        #: doctor's pull-based hung-task scan.
        self._inflight_tasks: Dict[str, dict] = {}
        self._actor_instance: Any = None
        self._actor_id: Optional[ActorID] = None
        self._actor_pg_context: Optional[dict] = None
        self._actor_pool = None  # ThreadPoolExecutor, max_concurrency>1
        #: name -> ThreadPoolExecutor for named concurrency groups.
        self._actor_group_pools: Dict[str, Any] = {}
        self._actor_loop = None  # asyncio loop thread for async methods
        self._actor_loop_lock = threading.Lock()
        self._running = True
        # Direct task transport (reference: normal_task_submitter.cc
        # worker-to-worker task push). Workers serve a tiny RPC
        # endpoint; drivers lease workers and push specs straight to
        # it, with results inline in the reply (_private/direct.py).
        self._direct_server = None
        direct_address = None
        if role == "worker":
            from .rpc import DEFERRED, RpcServer

            session_dir = os.path.dirname(os.path.abspath(socket_path))
            direct_address = os.path.join(
                session_dir, f"dworker-{os.getpid()}.sock"
            )
            self._direct_server = RpcServer(direct_address)

            def _h_direct_execute(conn, msg):
                self._task_queue.put((msg["spec"], (conn, msg["_mid"])))
                return DEFERRED

            self._batch_flusher = _BatchFlusher()
            self._reclaim_evt = threading.Event()
            threading.Thread(
                target=self._batch_reclaim_loop, daemon=True,
                name="rt-batch-reclaim",
            ).start()

            def _h_direct_execute_tasks(conn, msg):
                # Batched submission: one frame carries N flat-codec
                # spec blobs; specs enqueue in order and outcomes
                # stream back as partial reply frames. Error isolation
                # lives in the outcome slots, not the envelope — a
                # blob that fails decode (codec skew after a rolling
                # upgrade) fails ONLY its own slot; the rest of the
                # frame executes.
                from .wire import (
                    SpecCodecError,
                    decode_spec,
                    split_spec_batch,
                )

                blobs = split_spec_batch(msg["specs"])
                batch = _BatchReply(
                    conn, msg["_mid"], len(blobs),
                    flusher=self._batch_flusher,
                )
                put = self._task_queue.put
                for i, blob in enumerate(blobs):
                    try:
                        spec = decode_spec(blob)
                    except SpecCodecError as e:
                        batch.slot(i).reply({"error": make_error_payload(
                            "TaskError", f"undecodable spec blob: {e}"
                        )})
                        continue
                    put((spec, batch.slot(i)))
                self._reclaim_evt.set()
                return DEFERRED

            # Inline dispatch: both handlers only queue.put, so they
            # run on the hub thread — the spec reaches the task loop
            # with ONE thread wakeup instead of two (hub -> pool ->
            # loop). Lease connections carry nothing that orders
            # against these frames.
            self._direct_server.register(
                "execute_task", _h_direct_execute, inline=True
            )
            self._direct_server.register(
                "execute_tasks", _h_direct_execute_tasks, inline=True
            )
            self._direct_server.register("ping", lambda conn, msg: {})

            def _h_profile(conn, msg):
                # Long-running by design (a cpu profile sleeps for its
                # whole window): run on a dedicated thread and reply
                # deferred so the RPC hub never blocks (reference:
                # profile_manager.py attaches py-spy out-of-band).
                mid = msg["_mid"]

                def run():
                    try:
                        from .profiling import run_profile

                        params = {
                            k: msg[k]
                            for k in (
                                "duration_s", "hz", "top", "start_at",
                            )
                            if k in msg
                        }
                        result = run_profile(
                            msg.get("kind", "stack"), **params
                        )
                        conn.reply(mid, result)
                    except Exception as e:  # noqa: BLE001 — to caller
                        conn.reply(mid, {"_error": repr(e)})

                threading.Thread(
                    target=run, daemon=True, name="rt-profiler"
                ).start()
                return DEFERRED

            self._direct_server.register("profile", _h_profile)

            def _h_inspect(conn, msg):
                # Pull-based liveness introspection: what is THIS
                # worker executing right now, and for how long? The
                # doctor's hung-task scan reads this instead of the
                # task-event stream (direct-transport tasks report
                # events only at completion — an in-flight hang is
                # invisible there by design).
                now = time.time()
                return {
                    "pid": os.getpid(),
                    "inflight": [
                        dict(
                            info,
                            age_s=round(now - info["started"], 3),
                        )
                        for info in list(
                            self._inflight_tasks.values()
                        )
                    ],
                    "queued": self._task_queue.qsize(),
                }

            self._direct_server.register("inspect", _h_inspect)

            def _h_flight_recorder(conn, msg):
                rec = _flight()
                return {
                    "pid": os.getpid(),
                    "records": rec.snapshot(
                        limit=msg.get("limit", 0),
                        kinds=msg.get("kinds"),
                    ),
                    "summary": rec.summary(),
                }

            self._direct_server.register(
                "flight_recorder", _h_flight_recorder
            )

            def _h_lock_witness(conn, msg):
                from ray_tpu_torch.devtools.lock_witness import snapshot

                return snapshot()

            self._direct_server.register(
                "lock_witness", _h_lock_witness
            )
            self._direct_server.start()
        self._direct_task_counts = {
            "lock": make_lock("worker.direct_counts"),
            "finished": 0,
            "failed": 0,
            "events": [],
            "last_flush": 0.0,
        }
        # Workers give the daemon a LONG connect window: on an
        # overloaded box (10k-actor waves) the daemon's accept thread
        # can go unscheduled for tens of seconds, and a worker that
        # gives up at the default 10s counts as a startup crash —
        # three of those nuke the whole task queue.
        self._client = RpcClient(
            socket_path,
            push_handler=self._on_push,
            connect_timeout=float(
                os.environ.get("RT_WORKER_CONNECT_TIMEOUT", "60")
            )
            if role == "worker"
            else 10.0,
        )
        reply = self._client.call(
            "register_client",
            role=role,
            pid=os.getpid(),
            is_gpu=os.environ.get("RT_WORKER_GPU") == "1",
            direct_address=direct_address,
        )
        self.node_id = NodeID(reply["node_id"])
        self.config = Config(**reply["config"])
        from .compile_watch import configure as _compile_configure
        from .flight_recorder import configure as _flight_configure
        from ray_tpu_torch.devtools.lock_witness import (
            configure as _witness_configure,
        )

        _flight_configure(self.config)
        _compile_configure(self.config)
        _witness_configure(self.config)
        if role == "driver":
            self.job_id = JobID(reply["job_id"])
            self.worker_id = WorkerID.from_random()
        else:
            self.job_id = JobID.from_int(0)
            self.worker_id = WorkerID(reply["worker_id"])
        self.store = make_store(
            self.node_id.hex(),
            reply["store_capacity"],
            on_evict=self._notify_store_evict,
            use_native=self.config.use_native_object_store,
            client=True,
        )
        self.serialization = SerializationContext(ref_class=ObjectRef)
        self.functions = FunctionManager(self._client)
        self._ctx = _TaskContext()
        self._ref_counts: Dict[ObjectID, int] = {}
        # RLock: remove_local_ref runs from ObjectRef.__del__, which
        # the cyclic GC can fire during an allocation made while this
        # lock is already held on the same thread.
        self._ref_lock = threading.RLock()
        #: Owner-side cache of small put() values (serialized): local
        #: gets never leave the process; the daemon registration rides
        #: an async notify (same-connection FIFO keeps any dependent
        #: message ordered after it). Entries die with the local ref.
        #: (reference: CoreWorkerMemoryStore for small owned objects.)
        self._inline_cache: Dict[ObjectID, bytes] = {}
        #: Get-provenance aggregates: (provenance, src_node, task)
        #: -> [count, bytes, wait_ms]. Drained onto the metrics pipe
        #: once per flush tick (util.metrics._Buffer drain hook) —
        #: classification happens HERE at the source, and the wire
        #: cost is one aggregate record per distinct key per tick,
        #: never a per-get RPC.
        self._get_stats: Dict[tuple, list] = {}
        self._get_stats_lock = threading.Lock()
        #: Buffer generation the drain hook is registered on (fork /
        #: shutdown build a new buffer; re-register lazily).
        self._get_stats_buf = None
        self._get_stats_drained = 0.0
        #: Batched ref-release notifications: one daemon wakeup per
        #: batch instead of one per ObjectRef GC (the wakeup cost
        #: dominates on small hosts). A parked flusher thread drains
        #: the batch ~50ms after the first drop, so deletion stays
        #: prompt without per-ref traffic.
        self._pending_dels: List[bytes] = []
        self._del_flush_evt = threading.Event()
        self._del_flusher: Optional[threading.Thread] = None
        self._direct = None
        self._actor_routers: Dict[ActorID, Any] = {}
        if role == "driver" and self.config.use_direct_calls:
            from .direct import DirectTaskManager

            self._direct = DirectTaskManager(self)
        # Daemon-path batch submission (specs the direct transport
        # can't take: strategies, TPU gangs, runtime envs, or
        # use_direct_calls=False). Kill switch: task_submit_batching.
        self._submit_pipeline = None
        if self.config.task_submit_batching:
            from .submit_queue import SubmitPipeline

            self._submit_pipeline = SubmitPipeline(self)
        if role == "driver":
            # Error events always flow (reference: published error
            # messages print regardless of log streaming); worker
            # stdout/stderr only with log_to_driver. The subscription
            # is per-connection daemon state, so it must be re-sent
            # after any transparent RPC reconnect.
            channels = ["error_event"]
            if self.config.log_to_driver:
                channels.append("log_lines")

            def _subscribe():
                self._client.notify(
                    "subscribe_logs", channels=channels
                )

            _subscribe()
            self._client.set_on_reconnect(_subscribe)

    def _notify_store_evict(self, oid: ObjectID) -> None:
        """Arena evictions can originate in any process; tell the node
        daemon so its object table stays truthful."""
        try:
            self._client.notify("object_evicted", oid=oid.binary())
        except Exception:
            pass

    # ------------------------------------------------------------------
    # reference counting (local handle counts -> daemon refcount)
    # ------------------------------------------------------------------
    def add_local_ref(self, oid: ObjectID) -> None:
        with self._ref_lock:
            self._ref_counts[oid] = self._ref_counts.get(oid, 0) + 1

    def remove_local_ref(self, oid: ObjectID) -> None:
        if not self._running:
            return
        with self._ref_lock:
            count = self._ref_counts.get(oid, 0) - 1
            if count <= 0:
                self._ref_counts.pop(oid, None)
                self._inline_cache.pop(oid, None)
                notify = True
            else:
                self._ref_counts[oid] = count
                notify = False
        if notify:
            if self._direct is not None:
                self._direct.forget(oid)
            start_flusher = None
            with self._ref_lock:
                self._pending_dels.append(oid.binary())
                flush = len(self._pending_dels) >= 64
                if self._del_flusher is None:
                    # Construct/start outside the lock: Thread() can
                    # allocate enough to trigger GC -> __del__ ->
                    # re-entry here.
                    self._del_flusher = start_flusher = threading.Thread(
                        target=self._del_flush_loop,
                        name="rt-del-flusher",
                        daemon=True,
                    )
            if start_flusher is not None:
                start_flusher.start()
            if flush:
                self.flush_pending_dels()
            else:
                self._del_flush_evt.set()

    def _del_flush_loop(self) -> None:
        while self._running:
            self._del_flush_evt.wait()  # rt: noqa[RT008] — deliberate park; shutdown() sets the event
            self._del_flush_evt.clear()
            if not self._running:
                return
            time.sleep(0.05)  # debounce a GC burst into one notify
            self.flush_pending_dels()

    def flush_pending_dels(self) -> None:
        with self._ref_lock:
            if not self._pending_dels:
                return
            batch, self._pending_dels = self._pending_dels, []
        try:
            self._client.notify("del_ref", oids=batch)
        except Exception:
            pass

    def notify_borrowed_ref(self, oid: ObjectID) -> None:
        self._client.notify("add_ref", oids=[oid.binary()])

    # ------------------------------------------------------------------
    # ids
    # ------------------------------------------------------------------
    def _current_task_id(self) -> TaskID:
        return self._ctx.task_id or self._ctx.thread_base_id

    def _next_task_id(self) -> TaskID:
        self._ctx.submit_index += 1
        return TaskID.for_task(
            self.job_id, self._current_task_id(), self._ctx.submit_index
        )

    def _next_put_id(self) -> ObjectID:
        self._ctx.put_index += 1
        return ObjectID.for_put(self._current_task_id(), self._ctx.put_index)

    # ------------------------------------------------------------------
    # object plane
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        oid = self._next_put_id()
        self.put_object(oid, value, cache=True)
        return ObjectRef(oid, owner=self)

    def _store_create(self, oid: ObjectID, size: int) -> memoryview:
        """create() with spill-on-full: if the store can't make room by
        evicting, ask the daemon to spill cold objects to disk and retry
        (reference: plasma create retries after the raylet spills,
        create_request_queue.h). Bounded retries: under concurrent
        producers the freed space can be claimed before our retry."""
        last: Exception = None
        for attempt in range(4):
            try:
                return self.store.create(oid, size)
            except ObjectStoreFullError as e:
                last = e
                if attempt == 3:
                    break  # no retry left: don't pay one more spill
                self._client.call(
                    "spill_request", bytes_needed=size, timeout=60.0
                )
                if attempt:
                    time.sleep(0.05 * attempt)
        raise last

    def _owner_fields(self, oid: Optional[ObjectID] = None) -> dict:
        """Owner attribution riding every seal/put report (the memory
        ledger's per-job accounting): job hex plus the creating
        context — the executing actor, the executing task, or the
        driver itself — and this process's pid for node-local leak
        liveness probes. Direct-transport results are sealed after
        the task context is already cleared, so a worker process
        falls back to the creating task the oid itself embeds
        (ObjectID.for_return/for_put carry it)."""
        if self._actor_id is not None:
            owner = "actor:" + self._actor_id.hex()
        elif self._ctx.task_id is not None:
            owner = "task:" + self._ctx.task_id.hex()
        elif self.role == "worker" and oid is not None:
            owner = "task:" + oid.task_id().hex()
        else:
            owner = "driver"
        return {
            "owner_job": self.job_id.hex(),
            "owner": owner,
            "owner_pid": os.getpid(),
        }

    def _seal_and_report(self, oid: ObjectID, used: int) -> None:
        """Seal a just-written object and report it to the daemon. On
        the shared arena the seal takes a creator pin held until the
        daemon's primary pin is in place — otherwise another process's
        create() could LRU-evict the brand-new (pin-less) object in
        that window, losing the only copy."""
        pin = None
        seal_pinned = getattr(self.store, "seal_pinned", None)
        if seal_pinned is not None:
            pin = seal_pinned(oid)
        else:
            self.store.seal(oid)
        try:
            self._client.call(
                "object_sealed", oid=oid.binary(), size=used,
                **self._owner_fields(oid),
            )
        finally:
            if pin is not None:
                pin.release()

    def put_object(
        self, oid: ObjectID, value: Any, cache: bool = False
    ) -> Tuple[str, Any]:
        rec = _flight()
        if not rec.enabled:
            return self._put_object_inner(oid, value, cache)
        t0 = time.monotonic()
        try:
            kind, payload = self._put_object_inner(oid, value, cache)
        except BaseException:
            # A failed write (store full, serialization error) is
            # exactly the event the ring exists to keep — same
            # discipline as _get_one.
            rec.record(
                "store.put",
                "put",
                (time.monotonic() - t0) * 1e3,
                {"error": True},
            )
            raise
        rec.record(
            "store.put",
            kind,
            (time.monotonic() - t0) * 1e3,
            {"bytes": len(payload) if kind == "inline" else payload},
        )
        return kind, payload

    def _put_object_inner(
        self, oid: ObjectID, value: Any, cache: bool = False
    ) -> Tuple[str, Any]:
        """Serialize and store; returns ("inline", bytes) or ("shm", size).

        `cache=True` (explicit put(): an ObjectRef will hold a local
        ref whose release evicts the entry) keeps small values in the
        owner-side inline cache. Task-return storage passes False —
        no local ref exists to bound the cache."""
        serialized = self.serialization.serialize(value)
        size = serialized.total_size()
        if size <= self.config.max_direct_call_object_size:
            data = serialized.to_bytes()
            if cache:
                with self._ref_lock:
                    self._inline_cache[oid] = data
            # Async registration: the daemon's deferred-waiter get path
            # answers anyone who asks before the notify lands.
            self._client.notify(
                "put_inline", oid=oid.binary(), data=data,
                **self._owner_fields(oid),
            )
            return ("inline", data)
        # Large object: flush deferred ref-drops first so the daemon's
        # eviction view is current when space is tight.
        self.flush_pending_dels()
        buf = self._store_create(oid, size)
        used = serialized.write_to(buf)
        self._seal_and_report(oid, used)
        return ("shm", used)

    def get(
        self, refs: Sequence[ObjectRef], timeout: Optional[float] = None
    ) -> List[Any]:
        deadline = None if timeout is None else time.time() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {ref}"
                )
            out.append(self._get_one(ref.id(), remaining))
        return out

    #: Daemon ObjectEntry.source marker -> the provenance class billed
    #: to the consumer (absent marker = warm local arena hit).
    _VIA_PROVENANCE = {
        "pull": "pull",
        "pull_spill": "restore_remote",
        "restore": "restore_local",
    }

    def _record_get(
        self, provenance: str, src: str, nbytes: int, ms: float
    ) -> None:
        """Classify ONE rt.get resolution at the source and fold it
        into this process's aggregate table. O(one dict update) — this
        is the per-get cost the `get_provenance_overhead_us` bench
        bars; the wire cost is one record per distinct (provenance,
        src, task) per drain, riding the metrics flush tick. Never a
        per-get RPC."""
        if self.config.transfer_report_interval_s <= 0:
            return
        key = (provenance, src, self._ctx.task_name)
        with self._get_stats_lock:
            row = self._get_stats.get(key)
            if row is None:
                self._get_stats[key] = [1, nbytes, ms]
            else:
                row[0] += 1
                row[1] += nbytes
                row[2] += ms
        if ms > 0.0 and self._ctx.task_id is not None:
            # Bill the wait as its own step phase — only while
            # executing a task (driver-side gets between steps would
            # pollute the NEXT report_step's phase bucket with
            # unrelated wall), and only when no enclosing phase_timer
            # (data_wait, recv, ...) is already measuring this wall;
            # phases must stay a partition of the step.
            from .step_telemetry import add_phase, stalls_active

            if not stalls_active():
                add_phase("get_wait_ms", ms)
        self._ensure_get_drain()

    def _ensure_get_drain(self) -> None:
        """Register the drain hook on the CURRENT buffer generation
        (fork and shutdown drop the singleton; re-register lazily)."""
        from ..util.metrics import _Buffer

        buf = _Buffer.get()
        if self._get_stats_buf is buf:
            return
        self._get_stats_buf = buf  # rt: noqa[RT201] — add_drain_hook is idempotent; a racing duplicate registration is a no-op
        buf.add_drain_hook(self._drain_get_stats)

    def _drain_get_stats(self) -> None:
        """Pre-flush drain: push one aggregate "get" record per
        distinct key, rate-limited by `transfer_report_interval_s`."""
        now = time.monotonic()
        with self._get_stats_lock:
            if (
                now - self._get_stats_drained
                < self.config.transfer_report_interval_s
            ):
                return
            self._get_stats_drained = now
            stats, self._get_stats = self._get_stats, {}
        if not stats:
            return
        from ..util.metrics import _Buffer

        buf = _Buffer.get()
        node = self.node_id.hex()
        job = self.job_id.hex()
        for (prov, src, task), (count, nbytes, ms) in stats.items():
            buf.push(
                (
                    "get",
                    prov,
                    float(count),
                    (
                        ("bytes", str(int(nbytes))),
                        ("job", job),
                        ("ms", str(round(ms, 3))),
                        ("node", node),
                        ("src", src),
                        ("task", task),
                    ),
                )
            )

    def _get_one(self, oid: ObjectID, timeout: Optional[float]) -> Any:
        rec = _flight()
        if not rec.enabled:
            return self._get_one_inner(oid, timeout)
        with self._ref_lock:
            cached = self._inline_cache.get(oid)
        if cached is not None:
            # Inline-cache hits are sub-microsecond and arrive
            # thousands per second after a fan-out — recording each
            # would evict the diagnostic events the ring exists to
            # keep (same discipline as the daemon's zero-wait lock
            # acquisitions). Resolved right here so the hot path pays
            # ONE lock acquisition, not a probe plus the inner
            # lookup.
            self._record_get("inline", "", len(cached), 0.0)
            return self.serialization.deserialize(cached)
        t0 = time.monotonic()
        try:
            value = self._get_one_inner(oid, timeout)
        except BaseException:
            rec.record(
                "store.get",
                "fetch",
                (time.monotonic() - t0) * 1e3,
                {"error": True},
            )
            raise
        rec.record(
            "store.get", "fetch", (time.monotonic() - t0) * 1e3
        )
        return value

    def _get_one_inner(
        self, oid: ObjectID, timeout: Optional[float]
    ) -> Any:
        deadline = None if timeout is None else time.time() + timeout
        t0 = time.monotonic()
        with self._ref_lock:
            cached = self._inline_cache.get(oid)
        if cached is not None:
            self._record_get("inline", "", len(cached), 0.0)
            return self.serialization.deserialize(cached)
        if self._direct is not None:
            entry = self._direct.lookup(oid)
            if entry is not None:
                fut, index = entry
                if not fut.wait(timeout):
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for {oid}"
                    )
                # One deadline across future-wait and whatever follows
                # (store read or daemon fallback) — not timeout twice.
                timeout = (
                    None if deadline is None else deadline - time.time()
                )
                if not fut.daemon_fallback:
                    if fut.error is not None:
                        raise_from_payload(fut.error)
                    kind, payload = fut.results[index]
                    if kind == "inline":
                        self._record_get(
                            "inline", "", len(payload),
                            (time.monotonic() - t0) * 1e3,
                        )
                        return self.serialization.deserialize(payload)
                    remaining = (
                        None if deadline is None
                        else deadline - time.time()
                    )
                    value = self._read_local_store(
                        oid, payload, remaining
                    )
                    self._record_get(
                        "local", "", int(payload),
                        (time.monotonic() - t0) * 1e3,
                    )
                    return value
                # fell back to the daemon path: ask it below
        while True:
            timeout = None if deadline is None else deadline - time.time()
            try:
                reply = self._client.call(
                    "get_object", oid=oid.binary(), timeout=timeout
                )
            except RpcError as e:
                if "__timeout__" in str(e):
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for {oid}"
                    ) from None
                raise
            if "error" in reply and reply["error"] is not None:
                raise_from_payload(reply["error"])
            if reply.get("inline") is not None:
                self._record_get(
                    "inline", "", len(reply["inline"]),
                    (time.monotonic() - t0) * 1e3,
                )
                return self.serialization.deserialize(reply["inline"])
            remaining = None if deadline is None else deadline - time.time()
            try:
                value = self._read_local_store(
                    oid, reply["shm_size"], remaining
                )
                # Classify at the source: the daemon's reply says how
                # this node's copy materialised (absent via = warm
                # local hit), so the wait bills to the right
                # provenance class without any extra round trip.
                self._record_get(
                    self._VIA_PROVENANCE.get(
                        reply.get("via"), "local"
                    ),
                    str(reply.get("src", "")),
                    int(reply["shm_size"]),
                    (time.monotonic() - t0) * 1e3,
                )
                return value
            except FileNotFoundError:
                # The daemon spilled/evicted the segment between its
                # reply and our attach; re-ask — the daemon's get path
                # restores from spill (or re-pulls/reconstructs).
                if deadline is not None and deadline - time.time() <= 0:
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for {oid}"
                    ) from None
                time.sleep(0.01)

    def peek_object_error(self, oid: ObjectID) -> Optional[bytes]:
        """Error payload of a KNOWN-READY object, or None if it holds a
        value. Lets generator consumers inspect a failed completion
        marker (e.g. for items_emitted) without raising."""
        if self._direct is not None:
            entry = self._direct.lookup(oid)
            if entry is not None:
                fut = entry[0]
                if fut.done() and not fut.daemon_fallback:
                    return fut.error
        try:
            reply = self._client.call(
                "get_object", oid=oid.binary(), timeout=30.0
            )
        except RpcError:
            return None
        return reply.get("error")

    def _read_local_store(
        self, oid: ObjectID, size: int, timeout: Optional[float]
    ) -> Any:
        """Zero-copy read of a sealed object from the node's shared
        store (segment or native arena)."""
        deadline = None if timeout is None else time.time() + timeout
        # Sealed objects are immutable (plasma semantics): readers get
        # read-only views, so zero-copy numpy arrays can't corrupt them.
        if not getattr(self.store, "needs_release", False):
            view = self.store.get(oid, timeout=0.001)
            if view is None:
                view = self.store.open_remote(oid, size)
            return self.serialization.deserialize(view[:size].toreadonly())
        # Native arena: acquire() pins the slot. The pin must outlive
        # every zero-copy buffer carved from it — not just the fetched
        # container — so its release rides the lifetime of the view's
        # PER-PIN ctypes exporter: every memoryview sliced from the
        # pinned view (numpy arrays reconstructed over out-of-band
        # buffers included) keeps that exporter alive, and a finalizer
        # on the exporter drops the pin when the last view dies
        # (plasma ties Release to buffer destruction the same way).
        # Values whose deserialization copies (or with no out-of-band
        # buffers) release immediately. This replaced the pre-3.12
        # copy-out fallback: a 64 MB get no longer pays a second
        # memcpy on any supported interpreter.
        from .object_store import transfer_pin_to_exporter

        pin = self._acquire_arena_pin(oid, deadline)
        wrapped = 0

        def wrap(mv: memoryview):
            nonlocal wrapped
            wrapped += 1
            return mv

        try:
            value = self.serialization.deserialize(
                pin.view[:size].toreadonly(), buffer_wrap=wrap
            )
        except BaseException:
            pin.release()
            raise
        if wrapped:
            transfer_pin_to_exporter(pin)
        else:
            pin.release()
        return value

    def _acquire_arena_pin(self, oid: ObjectID, deadline: Optional[float]):
        """Wait for `oid` to be sealed in the local arena, respecting
        the caller's get() deadline (shared with the daemon RPC, not
        granted afresh). With no deadline, block like the get()
        contract demands — but re-ask the daemon periodically so an
        eviction mid-wait triggers re-pull/reconstruction rather than
        a silent hang."""
        while True:
            remaining = (
                None if deadline is None else deadline - time.time()
            )
            if remaining is not None and remaining <= 0:
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {oid}"
                )
            slice_t = 5.0 if remaining is None else min(remaining, 5.0)
            pin = self.store.acquire(oid, timeout=slice_t)
            if pin is not None:
                return pin
            # Not local yet: nudge the daemon (re-pulls lost copies,
            # kicks lineage reconstruction if every copy died).
            try:
                self._client.call(
                    "get_object", oid=oid.binary(), timeout=remaining
                )
            except RpcError as e:
                if "__timeout__" in str(e):
                    raise exc.GetTimeoutError(
                        f"get() timed out waiting for {oid}"
                    ) from None
                raise

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int = 1,
        timeout: Optional[float] = None,
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if not refs:
            return [], []
        direct: Dict[ObjectRef, Any] = {}
        if self._direct is not None:
            for ref in refs:
                entry = self._direct.lookup(ref.id())
                if entry is not None:
                    direct[ref] = entry[0]
        if not direct:
            return self._wait_daemon(refs, num_returns, timeout)
        # Direct futures are owner-local; poll them alongside the
        # daemon set in slices (mixed sets are rare — usually a wait()
        # is all-direct, where the loop blocks on an any-completion
        # event with no daemon traffic).
        deadline = None if timeout is None else time.time() + timeout
        daemon_refs = [r for r in refs if r not in direct]
        any_done = threading.Event()

        def _on_done(_fut):
            any_done.set()

        registered = set(direct.values())
        for fut in registered:
            fut.add_done_callback(_on_done)
        try:
            return self._wait_mixed(
                refs, direct, daemon_refs, num_returns, deadline, any_done
            )
        finally:
            for fut in registered:
                fut.remove_done_callback(_on_done)

    def _wait_mixed(
        self, refs, direct, daemon_refs, num_returns, deadline, any_done
    ):
        while True:
            ready, remaining = [], []
            for ref in refs:
                fut = direct.get(ref)
                if fut is None:
                    remaining.append(ref)  # resolved via daemon below
                elif fut.daemon_fallback:
                    daemon_refs.append(ref)
                    del direct[ref]
                    remaining.append(ref)
                elif fut.done():
                    ready.append(ref)
                else:
                    remaining.append(ref)
            if daemon_refs and len(ready) < num_returns:
                d_ready, _ = self._wait_daemon(
                    daemon_refs, len(daemon_refs), 0.0
                )
                ready.extend(d_ready)
                remaining = [r for r in remaining if r not in set(d_ready)]
            if len(ready) >= num_returns:
                return ready[:num_returns], [
                    r for r in refs if r not in set(ready[:num_returns])
                ]
            now = time.time()
            if deadline is not None and now >= deadline:
                return ready, remaining
            slice_t = 0.05 if daemon_refs else (
                None if deadline is None else deadline - now
            )
            if deadline is not None and slice_t is not None:
                slice_t = min(slice_t, max(deadline - now, 0.0))
            pending = [f for f in direct.values() if not f.done()]
            if pending:
                # Any single completion wakes the wait (each future
                # sets any_done via its done-callback).
                any_done.clear()
                if any(f.done() for f in pending):
                    continue  # completed between scan and clear
                any_done.wait(slice_t)
            elif daemon_refs:
                time.sleep(min(slice_t or 0.05, 0.05))
            else:
                # everything direct is done but num_returns unreachable
                return ready, remaining

    def _wait_daemon(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int,
        timeout: Optional[float],
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        by_id = {r.binary(): r for r in refs}
        reply = self._client.call(
            "wait_objects",
            oids=[r.binary() for r in refs],
            num_returns=num_returns,
            wait_timeout=timeout,
            timeout=None if timeout is None else timeout + 10.0,
        )
        ready = [by_id[b] for b in reply["ready"] if b in by_id]
        remaining = [by_id[b] for b in reply["remaining"] if b in by_id]
        return ready, remaining

    # ------------------------------------------------------------------
    # task submission
    # ------------------------------------------------------------------
    def _serialize_args(self, args: Sequence[Any]) -> List[tuple]:
        out = []
        for arg in args:
            if isinstance(arg, ObjectRef):
                out.append(self._serialize_ref_arg(arg))
                continue
            serialized = self.serialization.serialize(arg)
            size = serialized.total_size()
            if size <= self.config.max_direct_call_object_size:
                out.append(("inline", serialized.to_bytes()))
            else:
                # Large plain arg: promoted to a put + ref (reference:
                # DependencyResolver inlining threshold).
                oid = self._next_put_id()
                buf = self._store_create(oid, size)
                used = serialized.write_to(buf)
                self._seal_and_report(oid, used)
                out.append(("ref", oid.binary()))
        return out

    def _serialize_ref_arg(self, arg: ObjectRef) -> tuple:
        """Owner-side dependency resolution for direct-call results
        (reference: normal_task_submitter.cc DependencyResolver —
        the owner waits for locally-owned results and inlines small
        ones into the dependent spec). Non-direct refs pass through."""
        if self._direct is None:
            return ("ref", arg.binary())
        entry = self._direct.lookup(arg.id())
        if entry is None:
            return ("ref", arg.binary())
        fut, index = entry
        if fut.done() and not fut.daemon_fallback:
            if fut.error is not None:
                # Publish the error to the daemon table so the
                # dependent task fails with the underlying cause.
                self._direct.ensure_published(arg.id())
                return ("ref", arg.binary())
            kind, payload = fut.results[index]
            if kind == "inline":
                return ("inline", payload)
            return ("ref", arg.binary())  # shm: worker registered it
        # Still pending (or daemon-owned): never block submission —
        # pass the ref through and publish the result to the daemon's
        # object table when it lands, so the executing worker's fetch
        # resolves (chains stay pipelined; reference: the owner
        # resolves dependencies asynchronously, dependency_resolver.cc).
        # The dependent spec must ship in its own frame: batched
        # behind other specs, its in-worker wait could deadlock
        # against the very reply that publishes this result.
        self._ctx.pending_direct_dep = True
        self._direct.publish_when_done(arg.id())
        return ("ref", arg.binary())

    def ensure_globally_visible(self, oid: ObjectID) -> None:
        """Called when a ref escapes this process (pickled into a
        value or borrowed): direct inline results must reach the
        daemon's object table first or the borrower can never resolve
        them."""
        if self._direct is not None:
            try:
                self._direct.ensure_published(oid)
            except Exception:
                pass

    @staticmethod
    def _prune_spec(spec: dict) -> dict:
        """Drop None-valued optional fields before a spec enters the
        submit queues (absent == None for every .get() consumer; the
        dead entries cost ~100 B/task at the 1M-queue scale). Used on
        the COLD actor paths; the task hot path builds its spec
        without the second pass."""
        return {k: v for k, v in spec.items() if v is not None}

    def submit_task(
        self,
        func_key: str,
        args: Sequence[Any],
        name: str = "",
        num_returns=1,
        resources: Optional[Dict[str, float]] = None,
        max_retries: int = 0,
        scheduling_strategy: Optional[dict] = None,
        pg_context: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
    ) -> List[ObjectRef]:
        task_id = self._next_task_id()
        # Generator tasks ("dynamic"/"streaming") have ONE declared
        # return — the completion marker; item ids are deterministic
        # (object_ref.ObjectRefGenerator).
        mode = num_returns if isinstance(num_returns, str) else None
        n_declared = 1 if mode else num_returns
        returns = [
            ObjectID.for_return(task_id, i + 1) for i in range(n_declared)
        ]
        self._ctx.pending_direct_dep = False
        wire_args = self._serialize_args(args)
        # Optional fields enter the spec only when set: every consumer
        # reads them via .get() (absent == None), and at the 1M-queued
        # scale the dead entries cost ~100 B/task of driver+head RSS.
        spec = {
            "task_id": task_id.binary(),
            "job_id": self.job_id.binary(),
            "kind": "normal",
            "name": name,
            "function_key": func_key,
            "args": wire_args,
            "returns": [r.binary() for r in returns],
            # `resources={}` is a real request (zero-resource task; the
            # reference schedules these anywhere, ray_option_utils.py
            # num_cpus=0) — only None means "caller didn't resolve
            # options" and gets the 1-CPU default.
            "resources": (
                resources if resources is not None else {"CPU": 1.0}
            ),
            "max_retries": max_retries,
        }
        if self.namespace != DEFAULT_NAMESPACE:
            # Session-namespace context: the executing worker adopts it
            # so nested named-actor APIs resolve against the driver's
            # rt.init(namespace=...) (absent == default, like every
            # other optional spec field).
            spec["ns_ctx"] = self.namespace
        trace_ctx = _trace_ctx()
        if trace_ctx is not None:
            spec["trace_ctx"] = trace_ctx
        if scheduling_strategy is not None:
            spec["scheduling_strategy"] = scheduling_strategy
        if pg_context is not None:
            spec["pg_context"] = pg_context
        if runtime_env is not None:
            spec["runtime_env"] = runtime_env
        if mode is not None:
            spec["num_returns_mode"] = mode
        if self._direct is not None and self._direct.eligible(spec):
            fut = self._direct.register(spec)
            fut.hold_refs = [a for a in args if isinstance(a, ObjectRef)]
            self._direct.submit(spec, solo=self._ctx.pending_direct_dep)
        elif self._submit_pipeline is not None:
            self._submit_pipeline.submit(spec)
        else:
            self._client.call("submit_task", spec=spec)
        return [ObjectRef(r, owner=self) for r in returns]

    def create_actor(
        self,
        class_key: str,
        args: Sequence[Any],
        class_name: str,
        name: Optional[str] = None,
        namespace: Optional[str] = None,
        resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        concurrency_groups: Optional[Dict[str, int]] = None,
        handle_meta: Optional[dict] = None,
        scheduling_strategy: Optional[dict] = None,
        pg_context: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
        release_creation_resources: bool = False,
    ) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_actor_creation(actor_id)
        spec = {
            "task_id": task_id.binary(),
            "job_id": self.job_id.binary(),
            "kind": "actor_creation",
            "trace_ctx": _trace_ctx(),
            "name": name,
            # Named-actor registration defaults to the session
            # namespace of the creating process, never a hardcoded one.
            "namespace": namespace or self.namespace,
            "ns_ctx": (
                self.namespace
                if self.namespace != DEFAULT_NAMESPACE
                else None
            ),
            "class_name": class_name,
            "function_key": class_key,
            "args": self._serialize_args(args),
            "returns": [ObjectID.for_return(task_id, 1).binary()],
            # Explicit num_cpus=0 actors request {} — unlimited packing
            # (the reference's many-replica escape hatch); None keeps
            # the 1-CPU scheduling default applied in api_internal.
            "resources": (
                resources if resources is not None else {"CPU": 1.0}
            ),
            # True for default-resource actors: the 1 CPU is a
            # placement-time gate only, returned once the actor is up
            # (reference: DEFAULT_ACTOR_CREATION_CPU_SIMPLE=0 — default
            # actors hold no lifetime CPU).
            "release_creation_resources": release_creation_resources,
            "actor_id": actor_id.binary(),
            "max_restarts": max_restarts,
            "max_concurrency": max_concurrency,
            "concurrency_groups": concurrency_groups or {},
            "handle_meta": handle_meta,
            "scheduling_strategy": scheduling_strategy,
            "pg_context": pg_context,
            "runtime_env": runtime_env,
        }
        spec = self._prune_spec(spec)
        # One-way: the reply is always {} (creation errors surface
        # through actor state / the creation task's return object),
        # and frames on one connection process in order, so a
        # same-connection method submit can never overtake its
        # create. Pipelining the creates instead of paying one
        # driver->head round trip each is worth ~7ms/actor at the
        # 1000-actor scale.
        self._client.notify("create_actor", spec=spec)
        return actor_id

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method: str,
        args: Sequence[Any],
        num_returns=1,
        max_retries: int = 0,
        concurrency_group: Optional[str] = None,
    ) -> List[ObjectRef]:
        task_id = self._next_task_id()
        mode = num_returns if isinstance(num_returns, str) else None
        n_declared = 1 if mode else num_returns
        returns = [
            ObjectID.for_return(task_id, i + 1) for i in range(n_declared)
        ]
        spec = {
            "task_id": task_id.binary(),
            "job_id": self.job_id.binary(),
            "kind": "actor_task",
            "trace_ctx": _trace_ctx(),
            "name": method,
            "method": method,
            "function_key": "",
            "args": self._serialize_args(args),
            "returns": [r.binary() for r in returns],
            "resources": {},
            "actor_id": actor_id.binary(),
            "max_retries": max_retries,
            "num_returns_mode": mode,
            "concurrency_group": concurrency_group,
            # No ns_ctx here: actor tasks run under the namespace the
            # actor was CREATED with (its creation spec carried it) —
            # shipping the caller's would be ~100 B/task of dead
            # weight on the hot path.
        }
        spec = self._prune_spec(spec)
        if self._direct is not None:
            fut = self._direct.register(spec)
            fut.hold_refs = [a for a in args if isinstance(a, ObjectRef)]
            self._actor_router(actor_id).submit(spec, fut)
        else:
            self._client.call("submit_actor_task", spec=spec)
        return [ObjectRef(r, owner=self) for r in returns]

    def _actor_router(self, actor_id: ActorID):
        # Locked check-then-create: a lost setdefault race would leak
        # the loser's router thread (started in its __init__), parked
        # forever on an empty queue.
        with self._ref_lock:
            router = self._actor_routers.get(actor_id)
            if router is None:
                from .direct import ActorDirectRouter

                router = self._actor_routers[actor_id] = (
                    ActorDirectRouter(self, actor_id)
                )
            return router

    # ------------------------------------------------------------------
    # misc API
    # ------------------------------------------------------------------
    def call(self, method: str, **kwargs) -> dict:
        return self._client.call(method, **kwargs)

    def notify(self, method: str, **kwargs) -> None:
        self._client.notify(method, **kwargs)

    # ------------------------------------------------------------------
    # worker-role execution loop
    # ------------------------------------------------------------------
    def _on_push(self, channel: str, msg: dict) -> None:
        if channel == "execute_task":
            self._task_queue.put((msg["spec"], None))
        elif channel == "log_lines":
            self._print_worker_logs(msg)
        elif channel == "error_event":
            # Cluster error surfaced even when no get() will raise it
            # (reference: driver prints published error messages).
            print(
                f"[ray_tpu_torch] ({msg.get('source', '?')}) "
                f"{msg.get('message', '')}",
                file=sys.stderr,
            )
        elif channel == "exit":
            self._running = False
            self._task_queue.put(None)

    def _print_worker_logs(self, msg: dict) -> None:
        """Print streamed worker output with source prefixes
        (reference: worker.py:1966 print_to_stdstream with the
        '(pid=…, ip=…)' prefix convention)."""
        node = msg.get("node", "")
        for batch in msg.get("batches", []):
            prefix = f"(worker-{batch['worker']} pid={batch['pid']}" + (
                f" node={node})" if node else ")"
            )
            for line in batch["lines"]:
                print(f"{prefix} {line}", file=sys.stderr)

    def current_pg_context(self) -> Optional[dict]:
        """Capturing-placement-group context of the task this thread is
        executing, if any."""
        return getattr(self._ctx, "pg_context", None)

    def _batch_reclaim_loop(self) -> None:
        """Hand queued-but-unstarted batch specs back to the submitter
        when the running spec won't finish (blocking gang member, long
        compute): the driver re-spreads them across other leases, so
        stacking N specs on this worker can never serialize — or
        deadlock — work the resource model promised to run
        concurrently. Queue.get is atomic, so a spec is either
        reclaimed here or executed by the loop, never both."""
        q = self._task_queue
        evt = self._reclaim_evt
        while self._running:
            # Parked until a batch handler queues specs — the reclaim
            # scan only matters while work is queued BEHIND a running
            # spec, so an idle or sequential-latency worker never pays
            # the 40 Hz poll.
            if q.empty():
                evt.wait(5.0)  # deliberate park with deadline; enqueue sets the event
                evt.clear()
            time.sleep(0.025)
            if q.empty() or not self._inflight_tasks:
                continue  # idle loop drains the queue itself
            try:
                oldest = min(
                    info["started"]
                    for info in list(self._inflight_tasks.values())
                )
            except ValueError:
                continue  # finished between checks
            if time.time() - oldest < 0.05:
                continue
            kept = []
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not None and type(item[1]) is _BatchSlot:
                    item[1].reply({"requeue": True})
                else:
                    kept.append(item)  # daemon pushes / shutdown None
            for item in kept:
                q.put(item)

    def run_task_loop(self) -> None:
        """Blocking execution loop (reference:
        CoreWorkerProcess::RunTaskExecutionLoop). Consumes both
        daemon-pushed specs (reply_to None) and direct-transport specs
        (reply_to carries the deferred RPC reply handle) from one
        queue, preserving single-threaded execution and per-connection
        arrival order."""
        while self._running:
            item = self._task_queue.get()
            if item is None:
                return
            spec, reply_to = item
            pool = None
            if spec.get("kind") == "actor_task":
                # Concurrent actor: the loop thread only dispatches;
                # up to max_concurrency method calls run on the pool
                # (task context is thread-local, replies are
                # send-locked, so pool threads are safe). Named
                # concurrency groups (reference: concurrency_group_
                # manager.h) each own an independent pool, so a
                # saturated group never stalls another; per-group FIFO
                # order is the pool queue's.
                group = spec.get("concurrency_group")
                if group and self._actor_group_pools:
                    pool = self._actor_group_pools.get(group)
                if pool is None:
                    pool = self._actor_pool
            if pool is not None:
                pool.submit(self._execute, spec, reply_to)
            else:
                self._execute(spec, reply_to)

    def _run_coroutine(self, coro):
        """Execute an async actor method to completion on the actor's
        shared event loop (created on first use). The calling pool
        thread blocks for the result, so max_concurrency bounds
        concurrent coroutines while awaits interleave on the loop."""
        import asyncio

        with self._actor_loop_lock:
            if self._actor_loop is None:
                loop = asyncio.new_event_loop()
                thread = threading.Thread(
                    target=loop.run_forever,
                    name="rt-actor-asyncio",
                    daemon=True,
                )
                thread.start()
                self._actor_loop = loop

        # Thread-local task identity doesn't reach the loop thread, and
        # a thread-local SET there would clobber across interleaved
        # coroutines — carry it in a contextvar, which asyncio keeps
        # task-local (each asyncio.Task copies the context).
        task_id = self._ctx.task_id

        async def _with_task_ctx():
            _ASYNC_TASK_ID.set(task_id)
            return await coro

        return asyncio.run_coroutine_threadsafe(
            _with_task_ctx(), self._actor_loop
        ).result()

    _none_bytes: Optional[bytes] = None

    def _none_wire_bytes(self) -> bytes:
        cached = self._none_bytes
        if cached is None:
            cached = CoreWorker._none_bytes = (
                self.serialization.serialize(None).to_bytes()
            )
        return cached

    def _direct_reply(self, reply_to, payload: dict) -> None:
        if type(reply_to) is tuple:
            conn, mid = reply_to
            conn.reply(mid, payload)
        else:
            reply_to.reply(payload)  # _BatchSlot of an execute_tasks frame

    def _report_direct_task_events(
        self, spec: dict, start: float, failed: bool
    ) -> None:
        """Direct-transport tasks never transit the daemon, so the
        executing worker reports their state events (reference:
        task_event_buffer.h — workers batch events to the GCS). Events
        AND counts accumulate locally and flush as one notify pair
        when the queue drains (rate-limited to 20 Hz) or 0.5 s passes
        — the per-task task_event notify this replaces was its own
        control-plane flood at batched-submit rates."""
        counts = self._direct_task_counts
        events = None
        if self.config.task_events_enabled:
            tid = spec["task_id"]
            base = {
                "task_id": tid.hex() if isinstance(tid, bytes) else str(tid),
                "name": spec.get("name", ""),
                "kind": spec.get("kind", "normal"),
            }
            events = (
                dict(base, state="RUNNING", time=start),
                dict(
                    base,
                    state="FAILED" if failed else "FINISHED",
                    time=time.time(),
                ),
            )
        with counts["lock"]:
            counts["failed" if failed else "finished"] += 1
            if events is not None:
                counts["events"].extend(events)
            now = time.monotonic()
            # Queue-drain flush is UNCONDITIONAL: completion events
            # must reach the daemon before the caller's get() returns
            # (a state/metrics query issued that instant sees the
            # task). Mid-flood the queue is never empty, so events
            # still coalesce into 0.5s/2048-record batches there —
            # the regime the per-task notify was flooding.
            due = (
                now - counts["last_flush"] >= 0.5
                or len(counts["events"]) >= 2048
                or self._task_queue.empty()
            )
            if not due:
                return
            finished, failed_n = counts["finished"], counts["failed"]
            ev_batch = counts["events"]
            counts["finished"] = counts["failed"] = 0
            counts["events"] = []
            counts["last_flush"] = now
        try:
            if ev_batch:
                # One frame carries both events and counts.
                self._client.notify(
                    "task_event", events=ev_batch,
                    finished=finished, failed=failed_n,
                )
            else:
                self._client.notify(
                    "task_counts", finished=finished, failed=failed_n
                )
        except Exception:  # noqa: BLE001 — metrics must not raise
            pass

    def flush_task_events(self) -> None:
        """Force-flush buffered direct-task events/counts (tests and
        state-API consumers that need completion events NOW rather
        than at the next 50ms/queue-drain flush)."""
        counts = self._direct_task_counts
        with counts["lock"]:
            finished, failed_n = counts["finished"], counts["failed"]
            ev_batch = counts["events"]
            counts["finished"] = counts["failed"] = 0
            counts["events"] = []
            counts["last_flush"] = time.monotonic()
        try:
            if ev_batch:
                self._client.notify(
                    "task_event", events=ev_batch,
                    finished=finished, failed=failed_n,
                )
            elif finished or failed_n:
                self._client.notify(
                    "task_counts", finished=finished, failed=failed_n
                )
        except Exception:  # noqa: BLE001 — metrics must not raise
            pass

    def _execute(self, spec: dict, reply_to=None) -> None:
        start_time = time.time()
        task_id = TaskID(spec["task_id"])
        tid_hex = task_id.hex()
        self._inflight_tasks[tid_hex] = {  # rt: noqa[RT201] — per-task dict key: concurrent pool threads touch distinct keys (GIL-atomic setitem)
            "task_id": tid_hex,
            "name": spec.get("name", ""),
            "kind": spec.get("kind", "normal"),
            "started": start_time,
        }
        task_failed = False
        self._ctx.task_id = task_id
        self._ctx.put_index = 0
        self._ctx.submit_index = 0
        self._ctx.task_name = spec.get("name") or spec["kind"]
        # Actor methods inherit the capture context the actor was
        # created with (the creation spec carried it).
        self._ctx.pg_context = spec.get("pg_context") or (
            self._actor_pg_context if spec["kind"] == "actor_task" else None
        )
        # Adopt the submitting driver's session namespace for the span
        # of this task (reference: workers resolve named-actor APIs in
        # the job's ray_namespace). Actors keep the namespace they
        # were CREATED under — it is their identity's namespace — even
        # if a later caller runs in another one.
        if spec["kind"] == "actor_creation":
            self._actor_namespace = spec.get("ns_ctx")  # rt: noqa[RT201] — set once by the creation task, which happens-before any concurrent actor call
        if spec["kind"] in ("actor_creation", "actor_task"):
            self.namespace = self._actor_namespace or DEFAULT_NAMESPACE  # rt: noqa[RT201] — set once by the creation task, which happens-before any concurrent actor call
        else:
            self.namespace = spec.get("ns_ctx") or DEFAULT_NAMESPACE
        if self.job_id._bytes != spec["job_id"]:
            self.job_id = JobID(spec["job_id"])  # rt: noqa[RT201] — set once per task prologue; normal tasks run one at a time on this worker
        trace_stack = None
        try:
            tctx = spec.get("trace_ctx")
            if tctx:
                # Execution span linked under the caller's span
                # (reference: ray's OTel task execution spans).
                import contextlib as _contextlib

                from ..util.tracing import remote_parent
                from ..util.tracing import span as _tspan

                trace_stack = _contextlib.ExitStack()
                trace_stack.enter_context(remote_parent(tctx))
                trace_stack.enter_context(_tspan(
                    "task:" + (spec.get("name") or "anonymous"),
                    kind=spec.get("kind", "normal"),
                ))
            args, kwargs = _split_kwargs(self._deserialize_args(spec["args"]))
            kind = spec["kind"]
            # Actors keep their runtime env for life (they pin this
            # worker); shared task workers restore afterwards. The
            # env-less hot path skips the contextmanager machinery
            # entirely (a reusable nullcontext has no enter state).
            renv = spec.get("runtime_env")
            if renv:
                from .runtime_env import apply_runtime_env

                env_ctx = apply_runtime_env(
                    renv, self, restore=(kind != "actor_creation")
                )
            else:
                env_ctx = _NULL_CTX
            with env_ctx:
                if kind == "actor_creation":
                    cls = self.functions.fetch(spec["function_key"])
                    self._actor_instance = cls(*args, **kwargs)  # rt: noqa[RT201] — creation task publishes the instance before the daemon routes any calls to it
                    self._actor_id = ActorID(spec["actor_id"])  # rt: noqa[RT201] — creation task publishes before any concurrent actor call exists
                    self._actor_pg_context = spec.get("pg_context")  # rt: noqa[RT201] — creation task publishes before any concurrent actor call exists
                    concurrency = int(spec.get("max_concurrency") or 1)
                    groups = spec.get("concurrency_groups") or {}
                    if concurrency > 1 or groups:
                        # Concurrent actor (reference: concurrency_
                        # group_manager.h / threaded+async actors):
                        # method calls dispatch to a pool of N threads;
                        # coroutine-returning methods additionally run
                        # on a shared event loop so they can await each
                        # other while the pool bounds concurrency.
                        # With named groups, the DEFAULT pool exists
                        # even at width 1: default-group calls must
                        # not run inline on the dispatch thread, or a
                        # blocked default method would stall dispatch
                        # into every other group.
                        import concurrent.futures

                        self._actor_pool = (  # rt: noqa[RT201] — pool built during creation, before the concurrency it provides exists
                            concurrent.futures.ThreadPoolExecutor(
                                max_workers=concurrency,
                                thread_name_prefix="rt-actor-exec",
                            )
                        )
                        self._actor_group_pools = {  # rt: noqa[RT201] — group pools built during creation, before the concurrency they provide exists
                            gname: concurrent.futures.ThreadPoolExecutor(
                                max_workers=int(width),
                                thread_name_prefix=f"rt-actor-{gname}",
                            )
                            for gname, width in groups.items()
                        }
                    results = [None]
                elif kind == "actor_task":
                    if self._actor_instance is None:
                        raise exc.ActorDiedError("actor instance missing")
                    if spec["method"] == "__rt_dag_loop__":
                        # Compiled-DAG execution loop: the actor blocks
                        # on its channels until torn down
                        # (dag/compiled.py).
                        from ..dag.compiled import dag_exec_loop

                        value = dag_exec_loop(
                            self._actor_instance, *args, **kwargs
                        )
                    else:
                        method = getattr(
                            self._actor_instance, spec["method"]
                        )
                        value = method(*args, **kwargs)
                        if inspect.iscoroutine(value):
                            value = self._run_coroutine(value)
                    results = self._collect_returns(task_id, spec, value)
                else:
                    func = self.functions.fetch(spec["function_key"])
                    value = func(*args, **kwargs)
                    results = self._collect_returns(task_id, spec, value)
        except BaseException as e:  # noqa: BLE001 — any task failure
            if trace_stack is not None:
                # The stack closes exception-free in `finally` (the
                # error was caught here), so the execution span must be
                # marked failed explicitly.
                from ..util.tracing import add_span_attributes

                add_span_attributes(error=repr(e))
            task_failed = True
            payload = make_exception_payload(e)
            if reply_to is not None:
                # Events before the reply: a state/timeline query
                # issued the moment get() unblocks should see the task.
                self._report_direct_task_events(spec, start_time, True)
                self._direct_reply(reply_to, {"error": payload})
            else:
                self._client.notify(
                    "task_done",
                    task_id=spec["task_id"],
                    error=payload,
                    system_error=False,
                )
            return
        finally:
            if trace_stack is not None:
                trace_stack.close()
            self._inflight_tasks.pop(tid_hex, None)
            rec = _flight()
            if rec.enabled:
                rec.record(
                    "task",
                    spec.get("name") or spec["kind"],
                    (time.time() - start_time) * 1e3,
                    {"task_kind": spec["kind"], "error": True}
                    if task_failed
                    else {"task_kind": spec["kind"]},
                )
            self._ctx.task_id = None
            self._ctx.pg_context = None
            self._ctx.task_name = ""
        if reply_to is not None:
            # Direct transport: results ride the reply — small ones
            # inline (never touching the daemon), large ones sealed
            # into the shared store and reported so any process can
            # map them zero-copy.
            try:
                wire = []
                for oid_bytes, value in zip(spec["returns"], results):
                    if value is None:
                        # The nop/side-effect-task result: one cached
                        # wire blob instead of a fresh cloudpickle per
                        # task at batched-execute rates.
                        wire.append(("inline", self._none_wire_bytes()))
                        continue
                    serialized = self.serialization.serialize(value)
                    size = serialized.total_size()
                    if size <= self.config.max_direct_call_object_size:
                        wire.append(("inline", serialized.to_bytes()))
                    else:
                        oid = ObjectID(oid_bytes)
                        buf = self._store_create(oid, size)
                        used = serialized.write_to(buf)
                        self._seal_and_report(oid, used)
                        wire.append(("shm", used))
            except BaseException as e:  # noqa: BLE001
                self._report_direct_task_events(spec, start_time, True)
                self._direct_reply(reply_to, {"error": make_error_payload(
                    "TaskError", f"failed to store results: {e!r}"
                )})
                return
            self._report_direct_task_events(spec, start_time, False)
            self._direct_reply(reply_to, {"results": wire})
            return
        try:
            for oid_bytes, value in zip(spec["returns"], results):
                self.put_object(ObjectID(oid_bytes), value)
        except BaseException as e:  # noqa: BLE001
            self._client.notify(
                "task_done",
                task_id=spec["task_id"],
                error=make_error_payload(
                    "TaskError", f"failed to store results: {e!r}"
                ),
                system_error=False,
            )
            return
        self._client.notify("task_done", task_id=spec["task_id"], error=None)

    def _deserialize_args(self, wire_args: List[tuple]) -> List[Any]:
        args = []
        ref_slots: List[int] = []
        ref_blobs: List[bytes] = []
        deserialize = self.serialization.deserialize
        for kind, payload in wire_args:
            if kind == "inline":
                args.append(deserialize(payload))
            else:
                ref_slots.append(len(args))
                ref_blobs.append(payload)
                args.append(None)
        if not ref_slots:
            return args
        if len(ref_slots) == 1:
            args[ref_slots[0]] = self._get_one(
                ObjectID(ref_blobs[0]), timeout=None
            )
            return args
        for slot, value in zip(ref_slots, self._get_many(ref_blobs)):
            args[slot] = value
        return args

    def _get_many(self, oid_blobs: List[bytes]) -> List[Any]:
        """Resolve many refs with ONE `get_objects` round trip for
        everything the daemon already holds (the many-arg task path:
        per-arg blocking gets made one 10k-arg task cost 10k RTTs).
        Unready/remote entries fall back to the blocking per-oid get,
        which pulls and waits exactly like before."""
        # The RPC is deduped per unique oid, but DESERIALIZATION runs
        # once per arg position: duplicate ref args must stay
        # independent objects (a task mutating args[0] in place must
        # not see the change through args[1] — the per-arg blocking
        # path always gave fresh deserializations).
        inline_payloads: Dict[bytes, Any] = {}
        shm_sizes: Dict[bytes, int] = {}
        via_src: Dict[bytes, tuple] = {}
        unique = list(dict.fromkeys(oid_blobs))
        remote: List[bytes] = []
        for blob in unique:
            oid = ObjectID(blob)
            with self._ref_lock:
                cached = self._inline_cache.get(oid)
            if cached is not None:
                inline_payloads[blob] = cached
            else:
                remote.append(blob)
        if remote:
            try:
                reply = self._client.call(
                    "get_objects", oids=remote, timeout=120.0
                )
                results = reply.get("results") or []
            except RpcError:
                results = []
            for blob, res in zip(remote, results):
                if res.get("error") is not None:
                    raise_from_payload(res["error"])
                if res.get("inline") is not None:
                    inline_payloads[blob] = res["inline"]
                elif res.get("shm_size") is not None:
                    shm_sizes[blob] = res["shm_size"]
                    if res.get("via"):
                        via_src[blob] = (
                            res["via"], str(res.get("src", ""))
                        )
                # pending: blocking fallback below
        out = []
        for blob in oid_blobs:
            if blob in inline_payloads:
                payload = inline_payloads[blob]
                self._record_get("inline", "", len(payload), 0.0)
                out.append(self.serialization.deserialize(payload))
            elif blob in shm_sizes:
                t0 = time.monotonic()
                try:
                    value = self._read_local_store(
                        ObjectID(blob), shm_sizes[blob], 30.0
                    )
                except (FileNotFoundError, exc.GetTimeoutError):
                    # evicted mid-fetch: blocking path re-pulls
                    out.append(
                        self._get_one(ObjectID(blob), timeout=None)
                    )
                    continue
                via, src = via_src.get(blob, (None, ""))
                self._record_get(
                    self._VIA_PROVENANCE.get(via, "local"), src,
                    shm_sizes[blob],
                    (time.monotonic() - t0) * 1e3,
                )
                out.append(value)
            else:
                out.append(self._get_one(ObjectID(blob), timeout=None))
        return out

    def _collect_returns(
        self, task_id: TaskID, spec: dict, value: Any
    ) -> List[Any]:
        """Normal returns are split across the declared return ids;
        generator tasks ("dynamic"/"streaming") seal each yielded item
        under its deterministic id as produced, then return the
        completion marker (an ObjectRefGenerator carrying the count)
        as the single declared return (reference:
        python/ray/_raylet.pyx streaming generator protocol)."""
        mode = spec.get("num_returns_mode")
        if not mode:
            return self._split_returns(value, len(spec["returns"]))
        if not hasattr(value, "__iter__") and not hasattr(
            value, "__next__"
        ):
            raise TypeError(
                f"num_returns={mode!r} requires the task to return a "
                f"generator or iterable, got {type(value).__name__}"
            )
        from ..object_ref import ObjectRefGenerator

        count = 0
        try:
            for item in value:
                self.put_object(
                    ObjectID.for_return(task_id, count + 2), item
                )
                count += 1
        except BaseException as e:
            # Consumers must still receive the items sealed before the
            # failure; the error payload carries the emitted count.
            e.__rt_items_emitted__ = count
            raise
        return [ObjectRefGenerator(task_id, count=count)]

    @staticmethod
    def _split_returns(value: Any, num_returns: int) -> List[Any]:  # noqa: D102
        if num_returns == 1:
            return [value]
        if not isinstance(value, (tuple, list)) or len(value) != num_returns:
            raise ValueError(
                f"task declared num_returns={num_returns} but returned "
                f"{type(value).__name__}"
            )
        return list(value)

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        self.flush_pending_dels()
        if self._submit_pipeline is not None:
            # Queued batch submissions must reach the daemon before
            # the connection dies (their returns are already handed
            # out as ObjectRefs).
            self._submit_pipeline.flush(5.0)
            self._submit_pipeline.shutdown()
        self._running = False
        self._del_flush_evt.set()  # unpark the flusher so it exits
        if self._direct is not None:
            self._direct.shutdown()
        for router in list(self._actor_routers.values()):
            router.shutdown()
        self._actor_routers.clear()
        if self._direct_server is not None:
            try:
                self._direct_server.close()
            except Exception:
                pass
        try:
            self._client.close()
        except Exception:
            pass
        self.store.shutdown(unlink=False)
