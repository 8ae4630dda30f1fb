# Copied from ray_tpu/rl/weight_sync.py (JAX-free).
"""Versioned, drainless policy-weight synchronization (ISSUE 13).

Two halves, one version counter:

* **WeightStore** — an actor publishing ``(version, wrapped ref)`` of
  the learner's latest params. PULL side of the sync: env runners
  doing LOCAL policy inference poll ``latest_version()`` (an int —
  cheap) between fragments and fetch the ref only when it moved; the
  payload rides the object store (zero-copy on one host), never this
  actor.
* **push_weights** — the PUSH side: one `rt.put` of the params, then
  a concurrent fan-out to every inference engine's
  ``update_weights`` (the ISSUE 13 engine API: in-flight requests
  finish token-exact on the old generation, the next admission
  serves the new one — the engine is never drained), plus the store
  publish and the rollout queue's ``set_learner_version`` (which
  arms the staleness gates). Returns the end-to-end latency — the
  ``weight_sync_ms`` series rlbench commits and the learner bills as
  a first-class stall phase next to data_wait.

The version counter is owned by the caller (the learner loop): it
increments per publish, tags every fragment the runners produce, and
its gap to the queue's learner version IS the weight lag —
``rl_weight_version`` / ``rl_weight_lag`` gauges on /metrics.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["WeightStore", "push_weights", "observe_weight_lag"]


class WeightStore:
    """Actor body: versioned weight publication for pull-side sync.
    Weights are held as a WRAPPED object-store ref (``[ref]``) so the
    store never materializes the payload; `get()` hands the wrapper
    back and the runner resolves it straight from the store."""

    def __init__(self, name: str = "policy"):
        from collections import deque

        self._name = name
        self._version = 0
        self._item: Optional[list] = None
        # Superseded wrappers retained briefly: a runner's get()
        # reply may still be in flight when the next publish lands —
        # dropping the old wrapper immediately would race the
        # reply's borrow registration and free the params mid-fetch.
        self._old: "deque" = deque(maxlen=4)
        self._publishes = 0

    def publish(self, item: list, version: int) -> int:
        """Install `item` (a wrapped ref ``[ref]``) as `version`.
        Stale publishes (version <= current) are ignored — a late
        retry must never roll weights back."""
        version = int(version)
        if version > self._version:
            if self._item is not None:
                self._old.append(self._item)
            self._item = item
            self._version = version
            self._publishes += 1
            self._observe()
        return self._version

    def latest_version(self) -> int:
        return self._version

    def get(self, min_version: int = 0):
        """(version, wrapped ref) of the latest weights; the wrapper
        is ``None`` until the first publish. `min_version` is advisory
        (callers poll; the store never blocks)."""
        return self._version, self._item

    def ping(self) -> str:
        return "ok"

    def stats(self) -> Dict[str, Any]:
        return {
            "version": self._version,
            "publishes": self._publishes,
            "has_weights": self._item is not None,
        }

    def _observe(self) -> None:
        try:
            from ..util.metrics import Gauge

            global _STORE_GAUGE
            if _STORE_GAUGE is None:
                _STORE_GAUGE = Gauge(
                    "rl_weight_version",
                    description=(
                        "Latest policy-weight version published by "
                        "the learner"
                    ),
                    tag_keys=("store",),
                )
            _STORE_GAUGE.set(
                float(self._version), tags={"store": self._name}
            )
        except Exception:
            pass


_STORE_GAUGE = None
_LAG_GAUGE = None
_SYNC_HIST = None


def observe_weight_lag(lag: float, *, role: str = "runner") -> None:
    """Publish the observed weight lag (learner version minus the
    version actually generating/serving rollouts) as the
    ``rl_weight_lag`` gauge — the /metrics half of the
    ``max_weight_lag`` contract."""
    try:
        from ..util.metrics import Gauge

        global _LAG_GAUGE
        if _LAG_GAUGE is None:
            _LAG_GAUGE = Gauge(
                "rl_weight_lag",
                description=(
                    "Weight-version lag between the learner and the "
                    "policy generating rollouts"
                ),
                tag_keys=("role",),
            )
        _LAG_GAUGE.set(float(lag), tags={"role": role})
    except Exception:
        pass


def push_weights(
    params: Any,
    version: int,
    *,
    engines: Sequence[Any] = (),
    store: Optional[Any] = None,
    queue: Optional[Any] = None,
    timeout: float = 60.0,
) -> float:
    """One drainless weight sync: put the params ONCE, fan the ref out
    concurrently to every engine (`update_weights`), the weight store
    and the rollout queue, and wait for all acks. Returns wall ms —
    the committed ``rl_weight_sync_ms`` number.

    The engines receive the ref TOP-LEVEL (materialized engine-side
    from the store, one zero-copy read each); the store/queue receive
    it WRAPPED (version bookkeeping only, no payload)."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    ref = rt.put(params)
    acks: List[Any] = []
    for engine in engines:
        acks.append(
            engine.update_weights.remote(ref, version=int(version))
        )
    if store is not None:
        acks.append(store.publish.remote([ref], int(version)))
    if queue is not None:
        acks.append(
            queue.set_learner_version.remote(int(version))
        )
    if acks:
        rt.get(acks, timeout=timeout)
    ms = (time.perf_counter() - t0) * 1e3
    try:
        from ..util.metrics import Histogram

        global _SYNC_HIST
        if _SYNC_HIST is None:
            _SYNC_HIST = Histogram(
                "rl_weight_sync_ms",
                description=(
                    "End-to-end drainless weight push: put + engine/"
                    "store/queue fan-out + acks"
                ),
                boundaries=(
                    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                    500.0, 1000.0, 2500.0,
                ),
                tag_keys=(),
            )
        _SYNC_HIST.observe(ms)
    except Exception:
        pass
    return ms
