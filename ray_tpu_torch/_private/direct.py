# Copied from ray_tpu/_private/direct.py (JAX-free): module names read ray_tpu_torch, and the TPU resource is the GPU.
"""Direct task transport: submitter-to-worker task push over leased
workers, daemons only for placement.

This is the TPU-native analog of the reference's direct task calls
(reference: src/ray/core_worker/transport/normal_task_submitter.cc:23,
83,141 — the submitter leases a worker per scheduling key from the
raylet, then pushes task specs worker-to-worker with the raylet out of
the data path; and actor_task_submitter.h — actor calls go straight to
the actor's worker over an established connection).

Architecture
------------
- Every worker process serves a tiny RPC endpoint (its *direct
  address*, a Unix socket in the session dir). ``execute_task``
  requests enqueue into the worker's single task loop and the reply —
  carrying inline results — is deferred until execution finishes, so
  per-connection ordering and single-threaded actor semantics are
  preserved while requests pipeline in the socket.
- For **normal tasks**, the driver holds leases per *scheduling key*
  (resources + TPU-ness), granted by the daemon (``request_lease`` — a
  pseudo-task through the LocalScheduler, so resource accounting and
  fairness are shared with the daemon-scheduled path). The hot path
  has NO dedicated threads: the submitting thread sends the spec with
  ``RpcClient.call_async`` and the lease connection's reader thread
  fulfills the result future and dispatches the next queued spec.
  One background "requester" thread serves lease-pool growth, idle
  release, and starvation sweeps off the critical path.
- For **actor tasks**, one router thread per actor handle resolves the
  actor's direct address once (blocking ``actor_address`` call that
  the daemon answers when the actor is ALIVE) and then pushes calls
  directly. Actors hosted off-node (or whose worker died) fall back
  to the daemon path — *sticky*, so per-handle ordering is never
  split across two transports in flight.
- Results come back inline in the RPC reply (small) or as
  ``("shm", size)`` markers after the worker seals them in the node's
  shared store (large — the zero-copy path). The driver fulfills a
  local future per return id; ``get``/``wait`` consult these futures
  before asking the daemon.

Tasks that need daemon machinery — placement groups, node affinity,
runtime envs, TPU gangs — keep the daemon path (eligibility below).
System failures (lease connection lost) retry submitter-side up to the
task's ``max_retries``, matching the reference's handling of leased
worker death.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .ids import ObjectID
from .rpc import ConnectionLost, RpcClient, RpcError
from .task_spec import make_error_payload
from .wire import decode_spec, encode_spec, encode_spec_batch
from ray_tpu_torch.devtools.lock_witness import make_lock

#: In-flight request cap per leased connection when batching is OFF
#: (config task_submit_batching=False). 1 = every task lands on an
#: idle worker (no head-of-line blocking behind a slow task); queued
#: backlog is re-dispatched from reply callbacks, which already
#: pipelines the socket turnaround. With batching ON the cap comes
#: from config submit_inflight_specs instead.
_PIPELINE_CAP = 1


#: Shared mutation lock for every ResultFuture's done/callback/event
#: state. One process-wide lock instead of a Lock + Event + Condition
#: + waiter deque PER future: that threading machinery measured ~1 KB
#: per future — the single largest driver-side allocation at 1M
#: queued tasks (~1 GB of the measured RSS). Critical sections are a
#: few instructions, and completions arrive at RPC rate, so a shared
#: lock contends negligibly.
_fut_lock = threading.Lock()  # rt: noqa[RT004] — driver-only module state; workers re-import post-fork


class ResultFuture:
    """One task's worth of direct results (all return ids). The
    kernel-wait Event is allocated LAZILY — only for futures somebody
    actually blocks on; a pipelined submit-then-collect burst never
    pays for it."""

    __slots__ = (
        "_done", "_event", "results", "error", "daemon_fallback",
        "hold_refs", "_callbacks",
    )

    def __init__(self):
        self._done = False
        self._event: Optional[threading.Event] = None
        self.results: Optional[List[tuple]] = None  # aligned w/ returns
        self.error: Optional[bytes] = None
        self.daemon_fallback = False
        #: Submitter-side arg pinning: ObjectRef args stay referenced
        #: until the task completes, or the daemon may delete a dep the
        #: caller dropped while the worker still needs it (the daemon
        #: path pins args in _pin_args; direct specs never transit it).
        self.hold_refs: Optional[list] = None
        self._callbacks: Optional[List] = None

    def done(self) -> bool:
        return self._done

    def fulfill(self, results: Optional[List[tuple]], error: Optional[bytes]):
        self.results = results
        self.error = error
        self.hold_refs = None
        self._finish()

    def to_daemon(self):
        self.daemon_fallback = True
        self._finish()

    def _finish(self) -> None:
        with _fut_lock:
            callbacks, self._callbacks = self._callbacks, None
            self._done = True
            event = self._event
        if event is not None:
            event.set()
        for cb in callbacks or ():
            try:
                cb(self)
            except Exception:
                pass

    def add_done_callback(self, cb) -> None:
        """Run `cb(self)` when the future completes (immediately if it
        already has). Callbacks run on whichever thread completes the
        future — keep them short and non-blocking on that connection."""
        with _fut_lock:
            if not self._done:
                if self._callbacks is None:
                    self._callbacks = []
                self._callbacks.append(cb)
                return
        cb(self)

    def remove_done_callback(self, cb) -> None:
        """Deregister a pending callback (no-op if already fired) —
        polling wait() loops must not accumulate one closure per call
        on a long-pending future."""
        with _fut_lock:
            if self._callbacks is not None:
                try:
                    self._callbacks.remove(cb)
                except ValueError:
                    pass

    def wait(self, timeout: Optional[float]) -> bool:
        if self._done:
            return True
        with _fut_lock:
            if self._done:
                return True
            if self._event is None:
                self._event = threading.Event()
            event = self._event
        return event.wait(timeout)


class _Lease:
    __slots__ = (
        "lease_id", "worker_id", "address", "client", "in_flight",
        "last_used", "dead", "proven", "blocked",
    )

    def __init__(self, lease_id, worker_id, address):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.address = address
        self.client: Optional[RpcClient] = None
        self.in_flight = 0
        self.last_used = time.monotonic()
        self.dead = False
        #: A lease takes multi-spec frames only after completing at
        #: least one spec. Until then it gets singles, so a burst of
        #: BLOCKING tasks (gang rendezvous, collectives) spreads
        #: across the growing pool exactly like the per-task wire
        #: shape did — stacking gang members behind each other on one
        #: worker deadlocks the gang.
        self.proven = False
        #: The worker reclaimed queued specs because its running spec
        #: wouldn't finish: stop refilling until a real outcome shows
        #: the loop is moving again.
        self.blocked = False


class _Pending:
    """One queued submission in batch mode: the flat-codec blob plus
    the driver-side bookkeeping batching must keep (returns for
    fulfillment, retry budget). The spec DICT is dropped at submit —
    at the 1M-queued-task scale the ~150-byte blob replaces a
    kilobyte-class dict in driver RSS; the rare daemon-fallback path
    recovers the dict via decode_spec."""

    __slots__ = ("blob", "returns", "retries_left", "solo")

    def __init__(
        self,
        blob: bytes,
        returns: list,
        retries_left: int,
        solo: bool = False,
    ):
        self.blob = blob
        self.returns = returns
        self.retries_left = retries_left
        #: Must ride a SIZE-1 frame: one of this spec's args is a
        #: still-pending direct result, and the executing worker will
        #: block on it until the producer's reply lands driver-side
        #: and is published. Inside a multi-spec frame that wait can
        #: deadlock — the producer's own reply may be the tail of a
        #: batch whose earlier spec is doing the waiting.
        self.solo = solo


class _KeyState:
    """Per-scheduling-key backlog + lease pool (lock: ks.lock)."""

    __slots__ = (
        "queue", "lock", "leases", "requests_in_flight", "closed", "hot",
    )

    def __init__(self):
        # Deque, not list: the flood regime (1M queued specs) pops
        # from the head at batch rate — list.pop(0) is O(queue) and
        # turned the drain quadratic exactly when the queue was
        # deepest.
        from collections import deque

        self.queue = deque()
        # One shared witness name for every key-state: two instances
        # are never nested, so merging their order edges is safe.
        self.lock = make_lock("direct.keystate")
        self.leases: Dict[str, _Lease] = {}
        self.requests_in_flight = 0
        self.closed = False
        #: Submission-regime hysteresis (batch mode). Cold: a lone
        #: submit ships immediately to an idle lease (latency mode).
        #: Hot (monotonic deadline): a multi-spec drain proved a
        #: submit loop is outpacing replies — submissions only queue,
        #: and reply-driven drains coalesce them into large frames.
        #: Without this, fast workers make a lease idle between two
        #: `.remote()` calls and every task ships as its own frame:
        #: one sendmsg wakeup per task was the measured flood
        #: ceiling. Time-decayed (not a flag) so one drain that
        #: briefly empties the queue mid-flood doesn't flap the
        #: regime back to per-task frames.
        self.hot = 0.0


def scheduling_key(spec: dict) -> tuple:
    res = spec.get("resources") or {}
    return (tuple(sorted(res.items())), res.get("GPU", 0) > 0)


class DirectTaskManager:
    """Driver-side direct submitter for normal tasks."""

    def __init__(self, core):
        self._core = core  # CoreWorker (driver role)
        # RLock: forget()'s dict pop can drop the last reference to a
        # future whose hold_refs chain ObjectRef.__del__ ->
        # remove_local_ref -> forget() on the SAME thread (cyclic GC
        # fires during the pop). A plain Lock self-deadlocks there.
        self._lock = make_lock("direct.manager", "rlock")
        self._futures: Dict[bytes, Tuple[ResultFuture, int]] = {}
        #: Each pending task's future by its first return, until it
        #: completes: the future holds the task's args (`hold_refs`),
        #: which must outlive every handle to its results. Without it,
        #: dropping the results of a task still running (a shuffle's
        #: outputs, say) drops its args, their results are never
        #: published, and the task's worker waits on them for good.
        self._running: Dict[bytes, ResultFuture] = {}
        #: direct results already published to the daemon object table
        #: (large/shm results are implicitly published by the worker).
        self._published: set = set()
        self._keys: Dict[tuple, _KeyState] = {}
        self._shutdown = False
        cfg = core.config
        self._idle_timeout = cfg.worker_lease_idle_timeout_s
        # Batched + pipelined submission (ROADMAP item 3): coalesce
        # queued specs into execute_tasks frames (flat-codec blobs,
        # wire.encode_spec_batch) under a bounded in-flight window.
        # Batches form only from backlog — an idle lease still gets a
        # single-spec frame immediately, so latency never waits on a
        # flush timer.
        self._batching = cfg.task_submit_batching
        self._batch_max = max(1, cfg.submit_batch_max_specs)
        self._window = (
            max(1, cfg.submit_inflight_specs)
            if self._batching
            else _PIPELINE_CAP
        )
        # The real concurrency gate is the daemon scheduler's resource
        # admission (lease grants reserve the task's resources); this
        # is only an anti-runaway cap. It must NOT be lower than the
        # concurrency the declared resources admit — gang-rendezvous
        # tasks (util.collective) deadlock if fewer workers can run
        # than the resource model promises.
        self._max_leases = max(1, cfg.direct_call_max_leases)
        # One persistent requester/maintenance thread: lease-pool
        # growth, idle lease release, starvation sweep. Never on the
        # submit/reply hot path.
        self._req_cond = threading.Condition()
        self._req_jobs: List = []
        self._req_thread: Optional[threading.Thread] = None

    # -- eligibility ---------------------------------------------------
    def eligible(self, spec: dict) -> bool:
        if self._shutdown:
            return False
        if spec["kind"] != "normal":
            return False
        if spec.get("scheduling_strategy") or spec.get("pg_context"):
            return False
        if spec.get("runtime_env"):
            return False
        # TPU tasks ride the daemon path: gang resources and visibility
        # env handling live there.
        if (spec.get("resources") or {}).get("GPU", 0) > 0:
            return False
        return True

    # -- submission ----------------------------------------------------
    def register(self, spec: dict) -> ResultFuture:
        """Create the shared future covering all of a spec's returns."""
        fut = ResultFuture()
        with self._lock:
            for i, ret in enumerate(spec["returns"]):
                self._futures[ret] = (fut, i)
            if spec["returns"]:
                first = spec["returns"][0]
                self._running[first] = fut
        if spec["returns"]:
            fut.add_done_callback(lambda _fut: self._done_running(first))
        return fut

    def _done_running(self, first: bytes) -> None:
        with self._lock:
            self._running.pop(first, None)

    def submit(self, spec: dict, solo: bool = False) -> None:
        key = scheduling_key(spec)
        ks = self._key_state(key)
        if self._batching:
            # FIFO through the queue, always: a new spec never jumps
            # ahead of queued backlog onto a freshly-idle lease. An
            # idle lease takes a batch NOW (a lone spec ships as a
            # single-spec frame — no flush-timer latency); with every
            # lease busy the spec just queues and reply-driven drains
            # coalesce it into a large frame. That hysteresis is what
            # turns a tight `.remote()` loop into hundreds-of-specs
            # frames instead of one frame per task.
            entry = _Pending(
                encode_spec(spec),
                spec["returns"],
                spec.get("max_retries", 0),
                solo=solo,
            )
            batch = None
            lease = None
            want_more = False
            with ks.lock:
                ks.queue.append(entry)
                if ks.hot < time.monotonic():
                    lease = self._pick_lease(ks)
                    if lease is not None:
                        batch = self._take_batch_locked(ks, lease)
                # Grow the pool ONE request at a time while backlog
                # remains (see the legacy branch's rationale below).
                if ks.queue and (
                    ks.requests_in_flight == 0
                    and len(ks.leases) < self._max_leases
                ):
                    want_more = True
                    ks.requests_in_flight += 1
            if batch:
                self._send_batch(key, ks, lease, batch)
            if want_more:
                self._enqueue_lease_request(key, ks)
            return
        spec["_retries_left"] = spec.get("max_retries", 0)
        lease = None
        want_more = False
        with ks.lock:
            lease = self._pick_lease(ks)
            if lease is not None:
                lease.in_flight += 1
                lease.last_used = time.monotonic()
            else:
                ks.queue.append(spec)
                # Grow the pool ONE request at a time: each grant
                # chains the next while backlog remains (_on_lease_
                # reply), so growth proceeds at grant latency (~1ms)
                # but never floods the daemon's queue with requests it
                # cannot admit — a 64-deep request backlog keeps
                # churning grants/releases for seconds after the burst
                # ends (reference: normal_task_submitter.cc pipelines
                # exactly one lease request per scheduling key).
                want_more = (
                    ks.requests_in_flight == 0
                    and len(ks.leases) < self._max_leases
                )
                if want_more:
                    ks.requests_in_flight += 1
        if lease is not None:
            self._send(key, ks, lease, spec)
        elif want_more:
            self._enqueue_lease_request(key, ks)

    @staticmethod
    def _pick_lease(ks: _KeyState) -> Optional[_Lease]:
        """An IDLE live lease (caller holds ks.lock). Only idle leases
        take a submission inline — busy leases coalesce backlog from
        ks.queue into batch frames as their replies drain, which is
        what turns a tight `.remote()` loop into a few large frames
        instead of one frame per task."""
        for lease in ks.leases.values():
            if not lease.dead and lease.in_flight == 0:
                return lease
        return None

    def _key_state(self, key) -> _KeyState:
        with self._lock:
            ks = self._keys.get(key)
            if ks is None:
                ks = self._keys[key] = _KeyState()
            return ks

    # -- hot path ------------------------------------------------------
    def _send(self, key, ks: _KeyState, lease: _Lease, spec: dict) -> None:
        lease.client.call_async(
            "execute_task",
            lambda reply: self._on_reply(key, ks, lease, spec, reply),
            spec=spec,
        )

    def _send_batch(
        self, key, ks: _KeyState, lease: _Lease, batch: List[_Pending]
    ) -> None:
        """One execute_tasks frame for N specs: blobs were encoded at
        submit, so the frame build is a length-prefixed join plus one
        outer pickle of a single bytes object. Outcomes stream back
        as partial reply frames (`seen` tracks fulfilled indexes
        across them) — a quick spec is never held hostage by a slow
        one later in the same frame."""
        seen: set = set()
        lease.client.call_async(
            "execute_tasks",
            lambda reply: self._on_batch_reply(
                key, ks, lease, batch, seen, reply
            ),
            # Hub-thread delivery: accounting + window refill + fulfill
            # run with zero thread handoffs; refill sends are bounded
            # by the in-flight window, so the socket buffer the hub
            # writes into is one the worker is actively draining.
            inline=True,
            specs=encode_spec_batch(e.blob for e in batch),
            count=len(batch),
        )

    def _take_batch_locked(
        self, ks: _KeyState, lease: _Lease
    ) -> Optional[List[_Pending]]:
        """Reserve the next batch of queued specs for `lease` (caller
        holds ks.lock): bounded by the in-flight window (backpressure)
        and the per-frame batch cap. Maintains the hot/cold regime:
        a multi-spec take proves a submit loop is outpacing replies
        (go hot); an empty queue proves it ended (go cold)."""
        if ks.closed or lease.dead or lease.blocked or not ks.queue:
            return None
        if not lease.proven and lease.in_flight > 0:
            return None  # one spec at a time until the first completes
        room = self._window - lease.in_flight
        if room <= 0:
            return None
        n = min(room, self._batch_max, len(ks.queue))
        if ks.queue[0].solo:
            # Pending-direct-dep spec: its own frame, AND never
            # stacked behind anything on this worker — solo specs
            # block in-worker on results other specs must be free to
            # produce, so each occupies a lease exclusively (the
            # per-task wire shape's concurrency contract).
            if lease.in_flight > 0:
                return None
            n = 1
        elif not lease.proven:
            # Unproven lease (nothing completed yet — could be about
            # to run a blocking gang member): singles until the first
            # completion (see _Lease.proven).
            n = 1
        else:
            # Stop a multi-spec frame BEFORE the first solo entry.
            for i in range(1, n):
                if ks.queue[i].solo:
                    n = i
                    break
        pop = ks.queue.popleft
        now = time.monotonic()
        batch = [pop() for _ in range(n)]
        lease.in_flight += n
        lease.last_used = now
        if n > 1:
            ks.hot = now + 0.005  # stay in coalescing mode ~5ms
        return batch

    def _drain_lease(self, key, ks: _KeyState, lease: _Lease) -> None:
        """Refill `lease`'s in-flight window from the backlog (batch
        mode). Sends run outside ks.lock."""
        while True:
            with ks.lock:
                batch = self._take_batch_locked(ks, lease)
            if not batch:
                return
            self._send_batch(key, ks, lease, batch)

    def _on_batch_reply(
        self, key, ks, lease, batch: List[_Pending], seen: set,
        reply: dict,
    ) -> None:
        """Runs per outcome frame (partial or final) on the lease
        connection's reader thread. Per-spec error isolation: one
        failed spec fails only its own returns — the batch envelope
        succeeds or fails as transport, never as semantics."""
        err = reply.get("_error")
        if err is not None:
            # Only the specs whose outcomes never arrived are
            # affected — earlier partial frames already fulfilled
            # (and window-released) theirs.
            unseen = [
                entry for i, entry in enumerate(batch) if i not in seen
            ]
            if err == "__chaos_injected_failure__":
                # Injected drop (RT_testing_rpc_failure): nothing hit
                # the wire and the worker is healthy — requeue at the
                # front in original order and resend on the SAME
                # lease. No retry budget is spent and nothing can
                # have executed: exactly-once by construction.
                with ks.lock:
                    lease.in_flight -= len(unseen)
                    for entry in reversed(unseen):
                        ks.queue.appendleft(entry)
                self._drain_lease(key, ks, lease)
                return
            self._on_lease_failure_batch(key, ks, lease, unseen, err)
            return
        parts = reply.get("parts") or []
        final = not reply.get("_part")
        # A worker that reclaimed unstarted specs from behind a
        # long-running one returns them as requeue outcomes: they go
        # back to the FRONT of the queue for other leases (the pool
        # grows if none are free) — never re-executed, never failed.
        real_parts = []
        requeued: List[_Pending] = []
        for index, outcome in parts:
            seen.add(index)
            if outcome.get("requeue"):
                requeued.append(batch[index])
            else:
                real_parts.append((index, outcome))
        # Lease accounting (and window refill) BEFORE fulfilling: a
        # fulfilled waiter may submit its next task immediately and
        # must see this lease's window open.
        missing: List[int] = []
        want_more = False
        with ks.lock:
            lease.in_flight -= len(parts)
            if final:
                missing = [
                    i for i in range(len(batch)) if i not in seen
                ]
                lease.in_flight -= len(missing)
            lease.last_used = time.monotonic()
            if real_parts:
                lease.proven = True
                lease.blocked = False
            elif requeued:
                lease.blocked = True
            # APPEND, not appendleft: requeue frames arrive oldest-
            # first (the worker reclaims its queue in FIFO order), so
            # appending preserves the original submission order
            # across frames — prepending inverted it, putting
            # consumers ahead of the producers they block on, which
            # deadlocked dependency chains.
            ks.queue.extend(requeued)
            if requeued and ks.queue and (
                ks.requests_in_flight == 0
                and len(ks.leases) < self._max_leases
            ):
                want_more = True
                ks.requests_in_flight += 1
        # One manager-lock acquisition for the whole frame's future
        # lookups (not one per spec), then fulfill outside the lock.
        fulfills = []
        with self._lock:
            futures = self._futures

            def find(entry):
                for ret in entry.returns:
                    found = futures.get(ret)
                    if found is not None:
                        return found[0]
                # Every handle dropped pre-completion: the running
                # future still completes, releasing its args.
                return self._running.get(entry.returns[0]) if (
                    entry.returns) else None

            for index, outcome in real_parts:
                fut = find(batch[index])
                if fut is not None:
                    fulfills.append((fut, outcome))
            for index in missing:
                # A well-formed final frame accounts for every spec;
                # a gap means the executor dropped one — fail it
                # individually.
                seen.add(index)
                fut = find(batch[index])
                if fut is not None:
                    fulfills.append((fut, {
                        "error": make_error_payload(
                            "WorkerCrashedError",
                            "batch reply missing this spec's outcome",
                        )
                    }))
        if want_more:
            self._enqueue_lease_request(key, ks)
        self._drain_lease(key, ks, lease)
        for fut, outcome in fulfills:
            fut.fulfill(outcome.get("results"), outcome.get("error"))

    def _on_reply(self, key, ks, lease, spec, reply: dict) -> None:
        """Runs on the lease connection's reader thread (per-task
        wire shape: task_submit_batching=False)."""
        if reply.get("_error") is not None:
            if reply["_error"] == "__chaos_injected_failure__":
                # Injected drop: resend on the same (healthy) lease —
                # see _on_batch_reply. Nothing was sent or executed.
                self._send(key, ks, lease, spec)
                return
            self._on_lease_failure(key, ks, lease, spec, reply["_error"])
            return
        # Lease accounting BEFORE fulfilling: the fulfilled waiter may
        # submit its next task immediately, and must see this lease as
        # free or it queues the spec and grows the pool for nothing.
        next_spec = None
        with ks.lock:
            if ks.queue and not ks.closed and not lease.dead:
                next_spec = ks.queue.popleft()
                lease.last_used = time.monotonic()
            else:
                lease.in_flight -= 1
                lease.last_used = time.monotonic()
        if next_spec is not None:
            self._send(key, ks, lease, next_spec)
        self._fulfill(spec, reply)

    # -- lease lifecycle -----------------------------------------------
    def _enqueue_lease_request(self, key, ks: _KeyState) -> None:
        self._enqueue_job(lambda: self._request_lease(key, ks))

    def _enqueue_job(self, job) -> None:
        with self._req_cond:
            self._req_jobs.append(job)
            if self._req_thread is None:
                self._req_thread = threading.Thread(
                    target=self._requester_loop, daemon=True,
                    name="rt-lease-requester",
                )
                self._req_thread.start()
            self._req_cond.notify()

    def _requester_loop(self) -> None:
        """Lease-pool maintenance off the hot path: run queued jobs
        (lease grants/denials), release idle leases, rescue starved
        queues (work queued, no request outstanding — e.g. every lease
        busy with a long task)."""
        while not self._shutdown:
            with self._req_cond:
                if not self._req_jobs:
                    # Timed wait only while there is lease state to
                    # sweep; otherwise park until the next job arrives
                    # (no 10 Hz idle wakeups for the driver's life).
                    with self._lock:
                        has_state = any(
                            ks.leases or ks.queue
                            for ks in self._keys.values()
                        )
                    self._req_cond.wait(0.1 if has_state else None)
                batch, self._req_jobs = self._req_jobs, []
            for job in batch:
                try:
                    job()
                except Exception:
                    pass
            if self._shutdown:
                return
            with self._lock:
                keys = list(self._keys.items())
            now = time.monotonic()
            for key, ks in keys:
                to_release = []
                starved = False
                drain = None
                with ks.lock:
                    for lid, lease in list(ks.leases.items()):
                        if (
                            lease.in_flight == 0
                            and now - lease.last_used > self._idle_timeout
                        ):
                            del ks.leases[lid]
                            to_release.append(lease)
                    if self._batching and ks.queue:
                        # Backlog + an idle survivor (e.g. after a
                        # batch requeue landed while every reply was
                        # already drained): refill its window rather
                        # than leasing another worker.
                        drain = self._pick_lease(ks)
                    starved = (
                        bool(ks.queue)
                        and drain is None
                        and ks.requests_in_flight == 0
                        and self._pick_lease(ks) is None
                        and len(ks.leases) < self._max_leases
                    )
                    if starved:
                        ks.requests_in_flight += 1
                for lease in to_release:
                    self._drop_lease(lease, release=True)
                if drain is not None:
                    self._drain_lease(key, ks, drain)
                if starved:
                    self._request_lease(key, ks)

    def _request_lease(self, key, ks: _KeyState) -> None:
        """Fire the lease request without blocking: the daemon defers
        its reply until a worker is free (no client timeout — a timed
        out request whose grant arrives later would leak the worker),
        and the reply is handled as a requester-thread job."""
        self._core._client.call_async(
            "request_lease",
            lambda reply: self._enqueue_job(
                lambda: self._on_lease_reply(key, ks, reply)
            ),
            resources=dict(key[0]),
            needs_gpu=key[1],
        )

    def _on_lease_reply(self, key, ks: _KeyState, reply: dict) -> None:
        granted = None
        if reply.get("address"):
            granted = _Lease(
                reply["lease_id"], reply["worker_id"], reply["address"]
            )
            try:
                granted.client = RpcClient(granted.address)
            except ConnectionLost:
                self._core.notify(
                    "release_lease", lease_id=granted.lease_id
                )
                granted = None
        if granted is None:
            with ks.lock:
                ks.requests_in_flight -= 1
                # Could not lease (daemon lost/infeasible): if nothing
                # is serving this key, push queued work back to the
                # daemon path so nothing strands.
                if not ks.leases and not ks.requests_in_flight:
                    stranded = list(ks.queue)
                    ks.queue.clear()
                else:
                    stranded = []
            for entry in stranded:
                self._fallback_to_daemon(entry)
            return
        sends = []
        chain = False
        with ks.lock:
            ks.requests_in_flight -= 1
            if self._shutdown or ks.closed:
                leave = True
            else:
                leave = False
                ks.leases[granted.lease_id] = granted
                if not self._batching:
                    while ks.queue and granted.in_flight < _PIPELINE_CAP:
                        sends.append(ks.queue.popleft())
                        granted.in_flight += 1
                granted.last_used = time.monotonic()
                # Backlog remains: chain the next growth request.
                if (
                    ks.queue
                    and ks.requests_in_flight == 0
                    and len(ks.leases) < self._max_leases
                ):
                    ks.requests_in_flight += 1
                    chain = True
        if leave:
            self._drop_lease(granted, release=True)
            return
        if self._batching:
            self._drain_lease(key, ks, granted)
        else:
            for spec in sends:
                self._send(key, ks, granted, spec)
        if chain:
            self._request_lease(key, ks)

    def _drop_lease(self, lease: _Lease, release: bool) -> None:
        lease.dead = True
        if lease.client is not None:
            try:
                lease.client.close()
            except Exception:
                pass
        if release and not self._shutdown:
            try:
                self._core.notify("release_lease", lease_id=lease.lease_id)
            except Exception:
                pass

    def _on_lease_failure(self, key, ks, lease, spec, err) -> None:
        """Leased worker died (or the connection broke) with `spec` in
        flight. System failure: retry on another lease if the task has
        retries left (the task may have executed — at-least-once, the
        reference's semantics for worker-crash retries), else fail."""
        with ks.lock:
            ks.leases.pop(lease.lease_id, None)
        self._drop_lease(lease, release=False)  # daemon saw the death
        if spec.get("_retries_left", 0) > 0:
            spec["_retries_left"] -= 1
            requeued = False
            with ks.lock:
                if not ks.closed:
                    ks.queue.appendleft(spec)
                    if ks.requests_in_flight == 0:
                        ks.requests_in_flight += 1
                        requeued = True
            if requeued:
                self._enqueue_lease_request(key, ks)
        else:
            payload = make_error_payload(
                "WorkerCrashedError",
                f"leased worker died while running task ({err})",
            )
            self._fulfill(spec, {"error": payload})

    def _on_lease_failure_batch(
        self, key, ks, lease, batch: List[_Pending], err
    ) -> None:
        """A whole batch frame failed in transport (lease connection
        broke, chaos injection). The failure maps back to the
        INDIVIDUAL specs: each retries on another lease under its own
        budget (in original submission order) or fails its own
        returns — exactly the per-spec semantics of N separate
        submissions. A chaos-injected drop happens before any bytes
        hit the wire, so the retried batch executes exactly once."""
        with ks.lock:
            ks.leases.pop(lease.lease_id, None)
        self._drop_lease(lease, release=False)  # daemon saw the death
        retry: List[_Pending] = []
        failed: List[_Pending] = []
        for entry in batch:
            if entry.retries_left > 0:
                entry.retries_left -= 1
                retry.append(entry)
            else:
                failed.append(entry)
        requeued = False
        if retry:
            with ks.lock:
                if not ks.closed:
                    # Front of the queue in original order: retried
                    # specs keep their place ahead of younger work.
                    for entry in reversed(retry):
                        ks.queue.appendleft(entry)
                    if ks.requests_in_flight == 0:
                        ks.requests_in_flight += 1
                        requeued = True
                else:
                    failed.extend(retry)
        if requeued:
            self._enqueue_lease_request(key, ks)
        for entry in failed:
            self._fulfill_returns(entry.returns, {
                "error": make_error_payload(
                    "WorkerCrashedError",
                    f"leased worker died while running task ({err})",
                )
            })

    def _fallback_to_daemon(self, entry) -> None:
        """Strip direct bookkeeping and hand the spec to the daemon
        path; mark its futures so get()/wait() consult the daemon.
        Batch-mode entries recover their spec dict from the blob —
        this path runs only when the lease plane is gone."""
        if isinstance(entry, _Pending):
            spec = decode_spec(entry.blob)
        else:
            spec = entry
        spec.pop("_retries_left", None)
        with self._lock:
            futures = {
                self._futures.pop(ret, (None, 0))[0]
                for ret in spec["returns"]
            }
            if spec["returns"]:
                futures.add(self._running.get(spec["returns"][0]))
        for fut in futures:
            if fut is not None:
                fut.to_daemon()
        try:
            self._core.call("submit_task", spec=spec)
        except RpcError as e:
            payload = make_error_payload(
                "TaskError", f"daemon fallback submission failed: {e}"
            )
            for ret in spec["returns"]:
                try:
                    self._core.call("seal_error", oid=ret, error=payload)
                except RpcError:
                    pass
        finally:
            # The daemon has pinned the args (or sealed errors) now.
            for fut in futures:
                if fut is not None:
                    fut.hold_refs = None

    # -- results -------------------------------------------------------
    def _fulfill(self, spec: dict, reply: dict) -> None:
        self._fulfill_returns(spec["returns"], reply)

    def _fulfill_returns(self, returns, reply: dict) -> None:
        fut = None
        with self._lock:
            # Any surviving return's entry holds the shared future
            # (individual returns are forgotten as their refs are GC'd).
            for ret in returns:
                entry = self._futures.get(ret)
                if entry is not None:
                    fut = entry[0]
                    break
            if fut is None and returns:
                # Every handle to the result was dropped before
                # completion: nothing to record (the object was never
                # globally visible), but the running future completes,
                # releasing its args.
                fut = self._running.get(returns[0])
        if fut is None:
            return
        fut.fulfill(reply.get("results"), reply.get("error"))

    def lookup(self, oid: ObjectID):
        with self._lock:
            return self._futures.get(oid.binary())

    def forget(self, oid: ObjectID) -> None:
        with self._lock:
            self._futures.pop(oid.binary(), None)
            self._published.discard(oid.binary())

    def publish_when_done(self, oid: ObjectID) -> None:
        """Arrange for a (possibly still pending) direct result to be
        published to the daemon's object table once it completes —
        used when a dependent spec carries the ref so the executing
        worker's fetch can resolve daemon-side. Never blocks."""
        entry = self.lookup(oid)
        if entry is None:
            return
        fut, _ = entry

        def _publish(_fut):
            # Hop to the requester thread: done-callbacks may fire on
            # the hub thread (inline batch replies), and
            # ensure_published makes BLOCKING calls whose replies only
            # the hub itself could deliver — publishing inline there
            # would self-deadlock.
            self._enqueue_job(lambda: self._ensure_published_safe(oid))

        fut.add_done_callback(_publish)

    def _ensure_published_safe(self, oid: ObjectID) -> None:
        try:
            self.ensure_published(oid)
        except Exception:
            pass

    def ensure_published(self, oid: ObjectID) -> bool:
        """Make a direct inline result globally visible (daemon object
        table) before its ref escapes this process — nested in another
        value, or borrowed cross-process. A still-pending result is
        published on completion (never blocks the caller: consumers
        block daemon-side until the publish lands, so pickling a
        pending ref keeps pipelining). Returns False if `oid` is not a
        direct result."""
        entry = self.lookup(oid)
        if entry is None:
            return False
        fut, index = entry
        if not fut.done():
            self.publish_when_done(oid)
            return True
        if fut.daemon_fallback:
            return True  # daemon already owns it
        key = oid.binary()
        with self._lock:
            if key in self._published:
                return True
        if fut.error is not None:
            self._core.call("seal_error", oid=key, error=fut.error)
        else:
            kind, payload = fut.results[index]
            if kind == "inline":
                self._core.call("put_inline", oid=key, data=payload)
            # kind == "shm": the worker already sealed + reported it.
        with self._lock:
            self._published.add(key)
        return True

    # -- shutdown ------------------------------------------------------
    def shutdown(self) -> None:
        self._shutdown = True
        with self._req_cond:
            self._req_cond.notify_all()
        with self._lock:
            keys = list(self._keys.values())
        for ks in keys:
            with ks.lock:
                ks.closed = True
                leases = list(ks.leases.values())
                ks.leases.clear()
            for lease in leases:
                self._drop_lease(lease, release=False)


_router_pool = None
_router_pool_lock = threading.Lock()  # rt: noqa[RT004] — driver-only module state; workers re-import post-fork


def _router_executor():
    """Shared pool draining actor routers (reference role:
    actor_task_submitter's client callbacks). One THREAD per actor
    handle collapses at the 10k-actor scale; per-actor ordering
    survives because each router drains its own queue with at most one
    pool task at a time."""
    global _router_pool
    with _router_pool_lock:
        if _router_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _router_pool = ThreadPoolExecutor(
                max_workers=int(
                    os.environ.get("RT_DIRECT_ROUTER_THREADS", "64")
                ),
                thread_name_prefix="rt-actor-router",
            )
        return _router_pool


def _reset_router_pool_after_fork() -> None:
    global _router_pool
    _router_pool = None


os.register_at_fork(after_in_child=_reset_router_pool_after_fork)


class ActorDirectRouter:
    """Per-actor direct call router.

    An ORDERED per-actor queue drained by at most one shared-pool task
    at a time preserves submission order across transport decisions:
    the drain resolves the actor's direct address (blocking until the
    actor is ALIVE), then pushes calls over a dedicated connection.
    Remote-node actors and unrecoverable connection failures fall back
    to the daemon path — sticky, so ordering never interleaves
    between transports."""

    def __init__(self, core, actor_id):
        self._core = core
        self._actor_id = actor_id
        self._queue: List[tuple] = []
        self._cond = threading.Condition()
        self._mode = "resolving"  # resolving | direct | daemon | dead
        self._client: Optional[RpcClient] = None
        self._shutdown = False
        self._draining = False

    def submit(self, spec: dict, fut: ResultFuture) -> None:
        with self._cond:
            self._queue.append((spec, fut))
            if self._draining or self._shutdown:
                return
            self._draining = True
        _router_executor().submit(self._drain)

    def _drain(self) -> None:
        while True:
            with self._cond:
                if not self._queue or self._shutdown:
                    self._draining = False
                    return
                spec, fut = self._queue.pop(0)
            try:
                self._dispatch(spec, fut)
            except Exception:
                pass

    def _dispatch(self, spec: dict, fut: ResultFuture) -> None:
        if self._mode == "daemon":
            self._send_daemon(spec, fut)
            return
        client = self._resolve()
        if client is None:
            self._send_daemon(spec, fut)
            return
        # Pipelined send: the reply is handled on the connection's
        # reader thread, so N calls can be in flight at once — the
        # worker's task queue (and its max_concurrency pool) provides
        # the actual concurrency. Send order on one socket preserves
        # per-handle submission order.
        client.call_async(
            "execute_task",
            lambda reply: self._on_reply(spec, fut, reply),
            spec=spec,
        )

    def _on_reply(self, spec: dict, fut: ResultFuture, reply: dict) -> None:
        if reply.get("_error") is not None:
            # Actor worker died (or connection broke) with this call in
            # flight. The call may already have executed — re-running
            # would break at-most-once actor semantics, so without
            # retries it fails like the daemon path fails in-flight
            # tasks on actor death (reference: actor_task_submitter
            # DisconnectRpcClient will_retry=false path). Subsequent
            # calls re-resolve: the daemon's actor_address defers while
            # the actor restarts and answers with the NEW worker once
            # ALIVE (or empty if it stays dead).
            self._teardown_client()
            with self._cond:
                self._mode = "resolving"
            if spec.get("max_retries", 0) > 0:
                spec["max_retries"] -= 1
                rearm = False
                with self._cond:
                    self._queue.insert(0, (spec, fut))
                    if not self._draining and not self._shutdown:
                        self._draining = True
                        rearm = True
                if rearm:
                    _router_executor().submit(self._drain)
            else:
                fut.fulfill(None, make_error_payload(
                    "ActorDiedError",
                    "actor worker died while executing direct call",
                ))
            return
        fut.fulfill(reply.get("results"), reply.get("error"))

    def _resolve(self) -> Optional[RpcClient]:
        with self._cond:
            client = self._client
        if client is not None:
            return client
        # Retry around the window where the actor's worker died but the
        # daemon hasn't processed the death yet: actor_address still
        # answers the OLD address (connect fails) until the daemon sees
        # the disconnect, after which it defers until restart completes.
        for attempt in range(50):
            try:
                reply = self._core.call(
                    "actor_address",
                    actor_id=self._actor_id.binary(),
                    timeout=None,
                )
            except RpcError:
                break
            address = reply.get("address")
            if not address:
                break  # remote node / dead — daemon path owns it
            try:
                client = RpcClient(address, connect_timeout=0.5)
            except ConnectionLost:
                time.sleep(min(0.02 * (attempt + 1), 0.2))
                continue
            # Publish under _cond: the reply-reader thread's
            # _teardown_client swaps this attribute concurrently — an
            # unguarded store here could leak the client it replaces
            # (never closed) or hand back one already being closed.
            with self._cond:
                self._client = client
                self._mode = "direct"
            return client
        with self._cond:
            self._mode = "daemon"
        return None

    def _send_daemon(self, spec: dict, fut: ResultFuture) -> None:
        fut.to_daemon()
        try:
            self._core.call("submit_actor_task", spec=spec)
        except RpcError as e:
            payload = make_error_payload(
                "ActorDiedError", f"actor submission failed: {e}"
            )
            for ret in spec["returns"]:
                try:
                    self._core.call("seal_error", oid=ret, error=payload)
                except RpcError:
                    pass
        finally:
            fut.hold_refs = None  # daemon owns arg pinning now

    def _teardown_client(self) -> None:
        # Swap under the lock, close outside it: exactly one caller
        # wins the swap (no double-close when the reader thread and
        # shutdown() race), and the potentially-blocking socket close
        # never runs while holding _cond.
        with self._cond:
            client, self._client = self._client, None
        if client is not None:
            try:
                client.close()
            except Exception:
                pass

    def shutdown(self) -> None:
        self._shutdown = True
        self._teardown_client()
