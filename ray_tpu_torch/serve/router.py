# Copied from ray_tpu/serve/router.py (JAX-free): module names read ray_tpu_torch.
"""DeploymentHandle + least-outstanding-tokens routing.

Reference: python/ray/serve/handle.py (DeploymentHandle /
DeploymentResponse) and _private/replica_scheduler/pow_2_scheduler.py:52
for the candidate-selection skeleton (model-warm replicas first, then
replicas on THIS node). Routing itself (ISSUE 11) is by LEAST
OUTSTANDING TOKENS: the router keeps a per-replica estimate of queued
work in TOKENS (prompt + token budget parsed from LLM payloads, a
flat default otherwise), decays it as stream chunks come back, and
sends each request to the candidate with the smallest estimate — a
40-token chat turn and a 200-token completion stop counting as equal
load the way in-flight REQUEST counts made them
(`serve_routing_policy=pow2` restores power-of-two-choices on request
counts). The estimate is released on EVERY exit path — exhaustion,
`.close()`/abandon, stream error — and entries for replicas that left
the membership (engine death, redeploy) are pruned on the long-poll
push, so phantom load can't pile onto a dead or cancelled stream's
replica. SLO admission control rides the same estimate: when even the
least-loaded candidate is over `serve_slo_queue_threshold_tokens`,
`remote()` raises DeploymentOverloaded and the proxy sheds with
503 + Retry-After instead of queueing into TTFT collapse (kill
switch RT_serve_slo_admission_enabled).

Replica membership and deployment specs arrive by CONTROLLER PUSH
over a long-poll listener (reference: long_poll.py LongPollClient) —
a redeploy is visible here within one push round-trip, not a
cache-TTL window. Batched methods group concurrent calls handle-side
into one replica call (reference: serve/batching.py, relocated to the
router because replicas execute serially here).
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from .controller import CONTROLLER_NAME


class DeploymentOverloaded(RuntimeError):
    """Every candidate replica's outstanding-token estimate is over
    the SLO admission threshold; shed (HTTP: 503 + Retry-After)
    instead of queueing."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


#: Outstanding-token estimate for requests whose payload carries no
#: prompt/budget (non-LLM deployments): one flat unit of work.
DEFAULT_TOKEN_ESTIMATE = 64


#: Process-wide routing/admission config, resolved from the
#: environment ONCE (the router sits on every request's hot path —
#: re-scanning os.environ per call would tax every chunk of every
#: stream). Tests that monkeypatch RT_serve_* env vars call
#: _reset_config_cache().
_config_cache = None


def _serve_config():
    global _config_cache
    if _config_cache is None:
        from .._private.config import Config

        _config_cache = Config.from_env()
    return _config_cache


def _reset_config_cache() -> None:
    global _config_cache
    _config_cache = None


def estimate_request_tokens(args: tuple, kwargs: dict) -> int:
    """Outstanding-token estimate for one request: prompt length +
    token budget when the payload exposes them (LLM dict payloads and
    proxy Request bodies), DEFAULT_TOKEN_ESTIMATE otherwise. A
    heuristic for LOAD RANKING — it only needs to order replicas, not
    to be exact."""
    del kwargs
    payload = args[0] if args else None
    if hasattr(payload, "json"):
        try:
            payload = payload.json()
        except Exception:
            payload = None
    if isinstance(payload, dict):
        estimate = 0
        prompt = payload.get("prompt")
        if isinstance(prompt, (list, tuple, str)):
            estimate += len(prompt)
        budget = payload.get("max_new_tokens")
        if budget is not None:
            try:
                estimate += max(0, int(budget))
            except (TypeError, ValueError):
                pass
        elif estimate:
            estimate += DEFAULT_TOKEN_ESTIMATE
        if estimate > 0:
            return estimate
    return DEFAULT_TOKEN_ESTIMATE


def pick_least_outstanding(
    replicas: List[dict], outstanding: Dict[str, int]
) -> dict:
    """The routing policy, as a pure function (unit-tested in
    tests/test_router_policy.py): the candidate with the fewest
    estimated outstanding tokens, ties broken uniformly at random
    (reservoir over the tied prefix) so idle replicas share cold
    traffic instead of all of it landing on the first in list
    order."""
    best = None
    best_load = None
    ties = 0
    for replica in replicas:
        load = outstanding.get(replica["id"], 0)
        if best is None or load < best_load:
            best, best_load, ties = replica, load, 1
        elif load == best_load:
            ties += 1
            if random.random() < 1.0 / ties:
                best = replica
    return best


def _controller():
    import ray_tpu_torch as rt

    return rt.get_actor(CONTROLLER_NAME, namespace="serve")


#: Bumped by serve.shutdown(): long-poll listener threads exit when
#: their start-time epoch is stale instead of retrying a dead
#: controller at 5 Hz forever.
_shutdown_epoch = 0


def notify_shutdown() -> None:
    global _shutdown_epoch
    _shutdown_epoch += 1


def _local_node_id() -> Optional[str]:
    try:
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()
    except Exception:
        return None


class DeploymentResponse:
    """Future for one request (reference: serve/handle.py
    DeploymentResponse.result())."""

    def __init__(self, waiter, router: "DeploymentHandle"):
        self._waiter = waiter  # callable(timeout) -> value
        self._router = router
        self._resolved = False
        self._released = False
        self._value = None
        self._tokens = 0  # outstanding-token estimate to release

    def _release(self) -> None:
        """Release the in-flight count + outstanding-token estimate
        exactly once — from result(), or from GC for a response the
        caller fired and dropped (without this, a handful of dropped
        responses would pin phantom load on a replica forever and
        eventually trip SLO admission into permanent 503s)."""
        if self._released:
            return
        self._released = True
        replica_id = getattr(self, "_replica_id", None)
        self._router._ongoing_done(replica_id)
        self._router._tokens_done(replica_id, self._tokens)
        self._tokens = 0

    def result(self, timeout: Optional[float] = 30.0):
        if not self._resolved:
            try:
                self._value = self._waiter(timeout)
            finally:
                self._release()
            self._resolved = True
        if isinstance(self._value, BaseException):
            raise self._value
        return self._value

    def __del__(self):
        self._release()


class DeploymentResponseGenerator:
    """Iterator over a streaming replica method's yields (reference:
    handle.py DeploymentResponseGenerator). Chunks arrive as the
    replica produces them — the transport is the runtime's streaming
    generator path, so a slow consumer doesn't buffer the whole
    response anywhere, and each stream is consumed independently: one
    stream blocking on its next chunk must never head-of-line block a
    sibling stream from the same (batched) replica — the
    continuous-batching engine serves many interleaved token streams
    from one replica (regression: test_serve.py
    test_interleaved_streams_not_serialized)."""

    def __init__(
        self,
        ref_gen,
        router: "DeploymentHandle",
        replica_id,
        actor=None,
        request_id: str = "",
        tokens: int = 0,
    ):
        self._gen = ref_gen
        self._router = router
        self._replica_id = replica_id
        self._actor = actor
        self._request_id = request_id
        self._tokens_left = int(tokens)
        self._finished = False
        self._exhausted = False

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch as rt

        if self._finished:
            raise StopIteration
        try:
            ref = next(self._gen)
            value = rt.get(ref, timeout=60)
        except StopIteration:
            self._exhausted = True
            self.close()
            raise
        except BaseException:
            self.close()
            raise
        # One chunk ≈ one token of the estimate done: the replica's
        # outstanding-token load decays AS the stream progresses, so
        # routing sees a request 90% through its budget as almost
        # free, not as a full request's worth of load.
        if self._tokens_left > 0:
            self._tokens_left -= 1
            self._router._tokens_done(self._replica_id, 1)
        return value

    def close(self) -> None:
        """Release the ongoing-count slot and the REMAINING
        outstanding-token estimate exactly once, and tell the replica
        when the stream was ABANDONED (client disconnect, break)
        rather than exhausted: a continuous-batching engine frees the
        request's KV slot mid-decode instead of decoding the rest of
        the token budget for nobody. The token release is the
        router-side half of that cancel path (ISSUE 11 phantom-load
        fix): without it an abandoned or engine-failed stream would
        keep its full remaining budget counted against the replica
        until process exit, skewing least-outstanding-tokens routing
        and SLO admission forever."""
        if self._finished:
            return
        self._finished = True
        self._router._ongoing_done(self._replica_id)
        self._router._tokens_done(self._replica_id, self._tokens_left)
        self._tokens_left = 0
        if (
            not self._exhausted
            and self._actor is not None
            and self._request_id
        ):
            try:
                ref = self._actor.cancel_stream.remote(
                    self._request_id
                )
                del ref  # fire-and-forget: cancel is best-effort
            except Exception:
                pass

    def __del__(self):
        self.close()


class _BatchQueue:
    """Handle-side batcher for @serve.batch methods."""

    def __init__(self, handle: "DeploymentHandle", method: str, cfg: dict):
        self._handle = handle
        self._method = method
        self._max = cfg["max_batch_size"]
        self._wait = cfg["batch_wait_timeout_s"]
        self._lock = threading.Lock()
        self._pending: List[dict] = []
        self._timer: Optional[threading.Timer] = None

    def submit(self, args: tuple) -> "DeploymentResponse":
        entry = {
            "args": args,
            "event": threading.Event(),
            "value": None,
        }
        flush_now = False
        with self._lock:
            self._pending.append(entry)
            if len(self._pending) >= self._max:
                flush_now = True
            elif self._timer is None:
                self._timer = threading.Timer(self._wait, self._flush)
                self._timer.daemon = True
                self._timer.start()
        if flush_now:
            self._flush()
        self._handle._ongoing_sent()

        def waiter(timeout):
            if not entry["event"].wait(timeout):
                raise TimeoutError(
                    f"batched call to {self._method} timed out"
                )
            return entry["value"]

        return DeploymentResponse(waiter, self._handle)

    def _flush(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            batch, self._pending = self._pending, []
        if not batch:
            return
        import ray_tpu_torch as rt

        replica = self._handle._pick_replica()
        ref = replica["actor"].handle_batch.remote(
            self._method,
            [e["args"] for e in batch],
            self._handle._request_ctx(),
        )

        def deliver():
            try:
                values = rt.get(ref, timeout=60)
                if not isinstance(values, list) or len(values) != len(
                    batch
                ):
                    raise ValueError(
                        "@serve.batch method must return a list with "
                        "one output per input"
                    )
            except BaseException as e:  # noqa: BLE001 — forwarded
                values = [e] * len(batch)
            for entry, value in zip(batch, values):
                entry["value"] = value
                entry["event"].set()

        threading.Thread(target=deliver, daemon=True).start()


class DeploymentHandle:
    def __init__(
        self,
        app_name: str,
        deployment_name: str,
        method_name: str = "__call__",
    ):
        self.app_name = app_name
        self.deployment_name = deployment_name
        self._method = method_name
        self._handle_id = uuid.uuid4().hex[:8]
        self._lock = threading.Lock()
        # Replica membership + spec live in a SHARED mutable box so
        # every method clone of this handle family sees long-poll
        # pushes (clone-time attribute snapshots would strand clones
        # on killed replicas after a redeploy).
        self._state: Dict[str, Any] = {
            "replicas": [],
            "replicas_ts": 0.0,
            "spec": None,
        }
        self._ongoing: Dict[str, int] = {}  # replica_id -> in flight
        #: replica_id -> estimated outstanding TOKENS (the routing +
        #: SLO-admission signal; shared across method clones like
        #: _ongoing so one handle family sees one load picture).
        self._outstanding_tokens: Dict[str, int] = {}
        self._sent = 0
        self._done = 0
        self._batchers: Dict[str, _BatchQueue] = {}
        self._reporter: Optional[threading.Thread] = None
        # Mutable box shared across method clones (plain attributes
        # would be snapshotted at clone time): one listener per
        # handle family.
        self._listener_box: Dict[str, Any] = {"thread": None}
        self._stream = False
        self._model_id = ""  # multiplexed model id for this clone
        self._request_id = ""  # proxy-pinned request id, if any

    # -- routing -------------------------------------------------------
    def _refresh(self, force: bool = False) -> None:
        """Pull the current snapshot once, then keep it current by
        long-poll PUSH (the listener thread below)."""
        with self._lock:
            fresh = bool(self._state["replicas_ts"]) and not force
        if fresh:
            self._ensure_listener()
            return
        import ray_tpu_torch as rt

        controller = _controller()
        replicas = rt.get(
            controller.get_replicas.remote(
                self.app_name, self.deployment_name
            ),
            timeout=30,
        )
        spec = rt.get(
            controller.get_deployment_spec.remote(
                self.app_name, self.deployment_name
            ),
            timeout=30,
        )
        with self._lock:
            self._state["replicas"] = replicas
            self._state["replicas_ts"] = time.time()
            self._state["spec"] = spec
            self._prune_gone_locked()
        self._ensure_listener()

    def _ensure_listener(self) -> None:
        with self._lock:
            if self._listener_box["thread"] is not None:
                return
            self._listener_box["thread"] = threading.Thread(
                target=self._listen_loop, daemon=True,
                name=f"serve-longpoll:{self.deployment_name}",
            )
            self._listener_box["thread"].start()

    def _listen_loop(self) -> None:
        """Long-poll client (reference: long_poll.py LongPollClient):
        each round blocks controller-side until replicas or spec
        change, then applies the pushed values."""
        import ray_tpu_torch as rt

        dep = f"{self.app_name}/{self.deployment_name}"
        keys = {f"replicas:{dep}": 0, f"spec:{dep}": 0}
        epoch = _shutdown_epoch
        backoff = 0.2
        while epoch == _shutdown_epoch:
            try:
                controller = _controller()
                changed = rt.get(
                    controller.listen_for_change.remote(dict(keys)),
                    timeout=60,
                )
                backoff = 0.2
            except Exception:
                # Controller restart/redeploy window — or it is gone
                # for good; back off so a dead controller costs ~one
                # lookup per 5s, and exit on serve.shutdown().
                time.sleep(backoff)
                backoff = min(backoff * 2, 5.0)
                continue
            if not changed:
                continue
            with self._lock:
                for key, update in changed.items():
                    keys[key] = update["snapshot_id"]
                    if key.startswith("replicas:"):
                        self._state["replicas"] = update["value"] or []
                        self._state["replicas_ts"] = time.time()
                        # Replicas that left the membership (engine/
                        # replica death, redeploy) take their load
                        # estimates with them — their streams will
                        # never decrement, and phantom load on a dead
                        # id must not deter routing to its
                        # replacement (ISSUE 11 phantom-load fix).
                        self._prune_gone_locked()
                    elif update["value"] is not None:
                        self._state["spec"] = update["value"]

    def _pick_replica(self) -> dict:
        self._refresh()
        deadline = time.time() + 30
        while True:
            with self._lock:
                replicas = list(self._state["replicas"])
            if replicas:
                break
            if time.time() > deadline:
                raise RuntimeError(
                    f"no replicas for {self.app_name}/"
                    f"{self.deployment_name}"
                )
            time.sleep(0.05)
            self._refresh(force=True)
        # Model warmth beats locality: a replica already holding the
        # request's multiplexed model skips a load (reference: the
        # replica scheduler ranks multiplexed-model holders first).
        if self._model_id:
            warm = [
                r
                for r in replicas
                if self._model_id in (r.get("model_ids") or ())
            ]
            if warm:
                replicas = warm
        # Locality: prefer replicas on this node when any exist
        # (reference: pow_2 replica scheduler's locality-preferred
        # candidate set); pow-2 needs >=2 candidates to choose among.
        local_node = _local_node_id()
        if local_node is not None:
            local = [
                r for r in replicas if r.get("node_id") == local_node
            ]
            if local:
                replicas = local
        if len(replicas) == 1:
            return replicas[0]
        if _serve_config().serve_routing_policy == "pow2":
            # Legacy policy: power of two choices on this router's
            # in-flight REQUEST counts.
            a, b = random.sample(replicas, 2)
            with self._lock:
                na = self._ongoing.get(a["id"], 0)
                nb = self._ongoing.get(b["id"], 0)
            return a if na <= nb else b
        # Least outstanding tokens over the full candidate set
        # (replica counts are small; a full scan beats sampling noise).
        with self._lock:
            return pick_least_outstanding(
                replicas, self._outstanding_tokens
            )

    def _ongoing_sent(
        self, replica_id: Optional[str] = None, tokens: int = 0
    ) -> None:
        with self._lock:
            self._sent += 1
            if replica_id:
                self._ongoing[replica_id] = (
                    self._ongoing.get(replica_id, 0) + 1
                )
                if tokens > 0:
                    self._outstanding_tokens[replica_id] = (
                        self._outstanding_tokens.get(replica_id, 0)
                        + tokens
                    )
        self._ensure_reporter()

    def _ongoing_done(self, replica_id: Optional[str] = None) -> None:
        with self._lock:
            self._done += 1
            if replica_id and self._ongoing.get(replica_id, 0) > 0:
                self._ongoing[replica_id] -= 1

    def _tokens_done(
        self, replica_id: Optional[str], tokens: int
    ) -> None:
        """Release `tokens` of a replica's outstanding estimate,
        floored at zero (estimates are heuristic; a floor beats a
        slowly-accreting negative bias)."""
        if not replica_id or tokens <= 0:
            return
        with self._lock:
            remaining = (
                self._outstanding_tokens.get(replica_id, 0) - tokens
            )
            if remaining > 0:
                self._outstanding_tokens[replica_id] = remaining
            else:
                self._outstanding_tokens.pop(replica_id, None)

    def _prune_gone_locked(self) -> None:
        """Drop load accounting for replicas no longer in the
        membership (caller holds the lock)."""
        live = {r["id"] for r in self._state["replicas"]}
        for table in (self._ongoing, self._outstanding_tokens):
            for replica_id in list(table):
                if replica_id not in live:
                    del table[replica_id]

    def _ensure_reporter(self) -> None:
        """Push ongoing-load metrics to the controller for autoscaling
        (reference: autoscaling_state consumes handle metrics)."""
        with self._lock:
            if self._reporter is not None:
                return
            self._reporter = threading.Thread(
                target=self._report_loop, daemon=True
            )
            self._reporter.start()

    def _report_loop(self) -> None:
        try:
            while True:
                time.sleep(0.25)
                try:
                    controller = _controller()
                    with self._lock:
                        ongoing = self._sent - self._done
                    controller.report_metrics.remote(
                        self.app_name,
                        self.deployment_name,
                        self._handle_id,
                        float(max(0, ongoing)),
                    )
                except Exception:
                    # Transient controller hiccups (redeploys, races)
                    # must not kill autoscaling reporting for good.
                    continue
        finally:
            # If the thread ever exits (interpreter teardown), allow a
            # later send to restart it.
            with self._lock:
                self._reporter = None

    # -- calls ---------------------------------------------------------
    def _share_state_with(self, clone: "DeploymentHandle") -> None:
        # Share routing state so ongoing counts aggregate and the
        # long-poll listener is started once per handle family.
        clone.__dict__.update(
            {
                k: self.__dict__[k]
                for k in (
                    "_handle_id",
                    "_lock",
                    "_state",
                    "_ongoing",
                    "_outstanding_tokens",
                    "_batchers",
                    "_listener_box",
                )
            }
        )

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        clone = DeploymentHandle(
            self.app_name, self.deployment_name, name
        )
        self._share_state_with(clone)
        clone._method = name
        clone._model_id = self._model_id
        clone._request_id = self._request_id
        return clone

    def options(
        self,
        *,
        stream: bool = False,
        multiplexed_model_id: str = "",
        request_id: str = "",
    ) -> "DeploymentHandle":
        """`stream=True` makes remote() return a
        DeploymentResponseGenerator whose chunks arrive as the replica
        yields them (reference: handle.py
        DeploymentHandle.options(stream=True)).
        `multiplexed_model_id` tags requests with the model they need;
        the router prefers replicas already holding it and the replica
        exposes it via serve.get_multiplexed_model_id() (reference:
        handle.options(multiplexed_model_id=...)).
        `request_id` pins the next call's request id (the proxy
        propagates the client's ``x-request-id`` this way); by default
        each call mints its own."""
        clone = DeploymentHandle(
            self.app_name, self.deployment_name, self._method
        )
        self._share_state_with(clone)
        clone._stream = stream
        clone._model_id = multiplexed_model_id or self._model_id
        clone._request_id = request_id or self._request_id
        return clone

    def _request_ctx(self) -> dict:
        """Request context shipped with the replica call: id (minted
        here unless the proxy pinned one via options), deployment
        identity, the send timestamp the replica turns into queue
        wait, and the current span context so the replica's span
        nests under the caller's trace."""
        from ..util.tracing import inject_context

        from .observability import new_request_context

        return new_request_context(
            self.app_name,
            self.deployment_name,
            request_id=self._request_id or None,
            trace=inject_context(),
        )

    def remote(self, *args, **kwargs):
        from .observability import observe_routing

        self._refresh()
        with self._lock:
            batched = (
                self._state["spec"] or {}
            ).get("batched_methods", {}).get(
                self._method
            )
        if batched:
            with self._lock:
                batcher = self._batchers.get(self._method)
                if batcher is None:
                    batcher = _BatchQueue(self, self._method, batched)
                    self._batchers[self._method] = batcher
            if kwargs:
                raise TypeError(
                    "@serve.batch methods take positional args only"
                )
            return batcher.submit(args)
        t0 = time.perf_counter()
        replica = self._pick_replica()
        observe_routing(
            self.app_name,
            self.deployment_name,
            (time.perf_counter() - t0) * 1e3,
        )
        tokens = estimate_request_tokens(args, kwargs)
        self._slo_admit(replica, tokens)
        ctx = self._request_ctx()
        if self._stream:
            ref_gen = replica["actor"].handle_request_streaming.options(
                num_returns="streaming"
            ).remote(self._method, args, kwargs, self._model_id, ctx)
            self._ongoing_sent(replica["id"], tokens)
            return DeploymentResponseGenerator(
                ref_gen,
                self,
                replica["id"],
                actor=replica["actor"],
                request_id=str(ctx.get("request_id", "")),
                tokens=tokens,
            )
        ref = replica["actor"].handle_request.remote(
            self._method, args, kwargs, self._model_id, ctx
        )
        self._ongoing_sent(replica["id"], tokens)

        def waiter(timeout):
            import ray_tpu_torch as rt

            try:
                return rt.get(ref, timeout=timeout)
            except BaseException as e:  # noqa: BLE001 — surfaced at
                return e  # .result()

        response = DeploymentResponse(waiter, self)
        response._replica_id = replica["id"]
        response._tokens = tokens
        return response

    def _slo_admit(self, replica: dict, tokens: int) -> None:
        """SLO admission control: `replica` is already the LEAST-
        loaded candidate, so its estimate over the threshold means
        every candidate is over — queueing this request would only
        deepen a queue that is already past the latency budget. Shed
        instead (the proxy turns this into 503 + Retry-After)."""
        cfg = _serve_config()
        if not cfg.serve_slo_admission_enabled:
            return
        threshold = cfg.serve_slo_queue_threshold_tokens
        if threshold <= 0:
            return
        with self._lock:
            load = self._outstanding_tokens.get(replica["id"], 0)
        if load >= threshold:
            raise DeploymentOverloaded(
                f"{self.app_name}/{self.deployment_name}: least-"
                f"loaded replica has ~{load} outstanding tokens "
                f"(threshold {threshold}); shedding {tokens}-token "
                "request"
            )

    def __reduce__(self):
        return (
            DeploymentHandle,
            (self.app_name, self.deployment_name, self._method),
        )
