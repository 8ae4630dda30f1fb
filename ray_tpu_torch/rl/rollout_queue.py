# Copied from ray_tpu/rl/rollout_queue.py (JAX-free).
"""Bounded, backpressured rollout-fragment queue (ISSUE 13).

The hand-off point of the decoupled RL dataflow (PAPERS: "Podracer
architectures" — Sebulba splits acting and learning into pipelined
stages; "MindSpeed RL" — a distributed-dataflow buffer between
rollout and train): env-runner actors PUSH fixed-shape rollout
fragments, the learner PULLS them, and neither side ever waits on the
other's compute — only on this queue's two explicit gates:

* **Capacity** (``rl_rollout_queue_capacity``): a full queue refuses
  puts (``"full"``) — the learner has fallen behind and runners must
  throttle instead of growing an unbounded staleness backlog.
* **Weight lag** (``rl_max_weight_lag``): each fragment carries the
  policy-weight version that generated it. A put more than
  ``max_weight_lag`` versions behind the learner's current version is
  refused (``"throttle"``: refresh weights, then retry), and a
  fragment that AGED past the bound while queued is dropped at get
  (counted, never trained on) — off-policy staleness is bounded by
  construction, not by hope.

Zero-copy discipline: fragments ride as *wrapped* object-store refs
(``{"ref": [ObjectRef]}``) — a ref nested in a container serializes
as a borrowed reference, so the payload bytes go runner → store →
learner without ever passing through this actor (the PR 9 arena makes
both hops zero-copy on one host). The queue holds only refs + a small
meta dict per fragment.

Every gate and level is a first-class metric (``rl_queue_*`` on
/metrics via the PR 7 pipe), which is what lets `ray_tpu_torch doctor`
attribute an actor-vs-learner bottleneck: a queue pinned at capacity
convicts the learner; a queue pinned at zero with starving gets
convicts the runners.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = ["RolloutQueue", "QUEUE_METRIC_TAGS"]

QUEUE_METRIC_TAGS = ("queue",)


class RolloutQueue:
    """Actor body: deploy with ``rt.remote(num_cpus=0)(RolloutQueue)``
    (rl/dataflow.py does). Pure bookkeeping — never opens fragment
    payloads, never blocks a caller: both gates answer immediately
    and the CALLER decides how to wait (runners sleep-and-retry,
    the learner polls under its ``queue_wait_ms`` phase timer)."""

    def __init__(
        self,
        capacity: int = 16,
        max_weight_lag: int = 4,
        name: str = "rollout",
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_weight_lag < 0:
            raise ValueError(
                f"max_weight_lag must be >= 0, got {max_weight_lag}"
            )
        self.capacity = int(capacity)
        self.max_weight_lag = int(max_weight_lag)
        self._name = name
        self._frags: Deque[Dict[str, Any]] = deque()
        # Returned fragments are RETAINED for a while: this actor's
        # wrapped ref is what keeps the object-store payload alive
        # between "get_batch reply serialized" and "consumer
        # deserialized it" (the producer dropped its own ref right
        # after the put) — releasing at method return would race the
        # reply's borrow registration under load and free the block
        # mid-flight. A bounded ring of recent hand-offs closes the
        # window; consumers always resolve payloads promptly.
        self._returned: Deque[Dict[str, Any]] = deque(maxlen=64)
        self._learner_version = 0
        self._puts = 0
        self._gets = 0
        self._rejected_full = 0
        self._rejected_stale = 0
        self._dropped_stale = 0
        self._empty_gets = 0
        self._env_steps_in = 0
        # Occupancy integral for mean-depth reporting (rlbench's
        # queue-occupancy series): sum of depth x dwell-time.
        self._occ_t0 = time.monotonic()
        self._occ_area = 0.0
        self._tags = {"queue": name}

    # -- producer side -------------------------------------------------
    def put(self, item: Any, meta: Optional[dict] = None) -> str:
        """Offer one fragment. Returns ``"ok"`` (accepted),
        ``"full"`` (capacity backpressure: learner behind — wait and
        retry), or ``"throttle"`` (weight-lag gate: this fragment's
        policy version is already > max_weight_lag behind the
        learner — refresh weights before sampling more)."""
        meta = dict(meta or {})
        # Lag gate FIRST: a fragment too stale to ever be accepted
        # must throttle (drop + refresh) immediately — answering
        # "full" for it would have the runner spin-retrying data
        # that can only be rejected once space frees.
        version = int(meta.get("weight_version", self._learner_version))
        if self._learner_version - version > self.max_weight_lag:
            self._rejected_stale += 1
            self._observe("rl_queue_throttled_total")
            return "throttle"
        if len(self._frags) >= self.capacity:
            self._rejected_full += 1
            self._observe("rl_queue_full_total")
            return "full"
        self._tick_occupancy()
        self._frags.append({"item": item, "meta": meta})
        self._puts += 1
        self._env_steps_in += int(meta.get("env_steps", 0))
        self._observe("rl_queue_puts_total")
        self._gauges()
        return "ok"

    # -- consumer side -------------------------------------------------
    def get_batch(self, max_fragments: int = 8) -> List[Dict[str, Any]]:
        """Pop up to ``max_fragments`` fragments in FIFO order,
        dropping (and counting) any that aged past the weight-lag
        bound while queued. Returns immediately — an empty list means
        the runners have nothing ready (runner-bound signal)."""
        out: List[Dict[str, Any]] = []
        while self._frags and len(out) < int(max_fragments):
            self._tick_occupancy()
            frag = self._frags.popleft()
            version = int(
                frag["meta"].get(
                    "weight_version", self._learner_version
                )
            )
            if self._learner_version - version > self.max_weight_lag:
                self._dropped_stale += 1
                self._observe("rl_queue_stale_dropped_total")
                continue
            out.append(frag)
            self._returned.append(frag)
        if out:
            self._gets += len(out)
            self._observe("rl_queue_gets_total", float(len(out)))
        else:
            self._empty_gets += 1
            self._observe("rl_queue_empty_gets_total")
        self._gauges()
        return out

    def set_learner_version(self, version: int) -> int:
        """Advance the learner's published weight version — the
        reference point of both staleness gates. Monotonic."""
        self._learner_version = max(
            self._learner_version, int(version)
        )
        return self._learner_version

    # -- views ---------------------------------------------------------
    def depth(self) -> int:
        return len(self._frags)

    def ping(self) -> str:
        return "ok"

    def stats(self) -> Dict[str, Any]:
        elapsed = max(1e-9, time.monotonic() - self._occ_t0)
        area = self._occ_area + len(self._frags) * (
            time.monotonic()
            - getattr(self, "_occ_last", self._occ_t0)
        )
        return {
            "depth": len(self._frags),
            "capacity": self.capacity,
            "max_weight_lag": self.max_weight_lag,
            "learner_version": self._learner_version,
            "puts": self._puts,
            "gets": self._gets,
            "rejected_full": self._rejected_full,
            "rejected_stale": self._rejected_stale,
            "dropped_stale": self._dropped_stale,
            "empty_gets": self._empty_gets,
            "env_steps_in": self._env_steps_in,
            "mean_depth": round(area / elapsed, 3),
        }

    # -- internals -----------------------------------------------------
    def _tick_occupancy(self) -> None:
        now = time.monotonic()
        last = getattr(self, "_occ_last", self._occ_t0)
        self._occ_area += len(self._frags) * (now - last)
        self._occ_last = now

    def _observe(self, counter: str, value: float = 1.0) -> None:
        # Metrics must never fail queue traffic (same contract as the
        # engine's observe hooks); outside a session they're dropped
        # by the buffer, so unit tests need no cluster.
        try:
            from ..util.metrics import Counter

            metric = _METRICS.get(counter)
            if metric is None:
                metric = _METRICS[counter] = Counter(
                    counter,
                    description=_COUNTER_HELP.get(counter, counter),
                    tag_keys=QUEUE_METRIC_TAGS,
                )
            metric.inc(value, tags=self._tags)
        except Exception:
            pass

    def _gauges(self) -> None:
        try:
            from ..util.metrics import Gauge

            for name, value in (
                ("rl_queue_depth", float(len(self._frags))),
                ("rl_queue_capacity", float(self.capacity)),
                (
                    "rl_queue_learner_version",
                    float(self._learner_version),
                ),
            ):
                metric = _METRICS.get(name)
                if metric is None:
                    metric = _METRICS[name] = Gauge(
                        name,
                        description=_GAUGE_HELP.get(name, name),
                        tag_keys=QUEUE_METRIC_TAGS,
                    )
                metric.set(value, tags=self._tags)
        except Exception:
            pass


_METRICS: Dict[str, Any] = {}

_COUNTER_HELP = {
    "rl_queue_puts_total": "Rollout fragments accepted by the queue",
    "rl_queue_gets_total": "Rollout fragments handed to the learner",
    "rl_queue_full_total": (
        "Puts refused by capacity backpressure (learner behind)"
    ),
    "rl_queue_throttled_total": (
        "Puts refused by the weight-lag gate (runner weights stale)"
    ),
    "rl_queue_stale_dropped_total": (
        "Queued fragments dropped after aging past max_weight_lag"
    ),
    "rl_queue_empty_gets_total": (
        "Learner polls that found no fragment ready (runner-bound)"
    ),
}

_GAUGE_HELP = {
    "rl_queue_depth": "Rollout fragments currently queued",
    "rl_queue_capacity": "Rollout queue capacity bound",
    "rl_queue_learner_version": (
        "Learner weight version the staleness gates compare against"
    ),
}
