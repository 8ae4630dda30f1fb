# Copied from ray_tpu/rl/actor_manager.py (JAX-free).
"""Fault-tolerant actor management for RL worker fleets.

Reference: rllib/utils/actor_manager.py:198 FaultTolerantActorManager —
fan a method call across a set of actors, tolerate individual failures
(mark unhealthy instead of raising), and restore actors on a later
probe. RLlib wraps gRPC actor calls; here failures surface as
ActorDiedError/ActorUnavailableError/RpcError from the runtime and the
manager recreates dead actors from a factory, so a killed env-runner
costs one sample's worth of data, never the training iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class CallResult:
    """One actor's result or error (reference: ResultOrError)."""

    actor_id: int
    ok: bool
    value: Any = None
    error: Optional[BaseException] = None


class FaultTolerantActorManager:
    """Owns a fleet of actors indexed by small integer ids.

    `actor_factory(actor_id)` builds a replacement when a slot's actor
    is found dead; `on_restore(actor_id, handle)` re-initializes it
    (e.g. re-sync policy weights) before it rejoins the healthy set.
    """

    def __init__(
        self,
        actors: List[Any],
        *,
        actor_factory: Optional[Callable[[int], Any]] = None,
        on_restore: Optional[Callable[[int, Any], None]] = None,
        max_remote_requests_in_flight: int = 2,
    ):
        self._actors: Dict[int, Any] = dict(enumerate(actors))
        self._healthy: Dict[int, bool] = {
            idx: True for idx in self._actors
        }
        self._factory = actor_factory
        self._on_restore = on_restore
        self.max_remote_requests_in_flight = (
            max_remote_requests_in_flight
        )

    # -- introspection -------------------------------------------------
    def num_actors(self) -> int:
        return len(self._actors)

    def num_healthy_actors(self) -> int:
        return sum(1 for ok in self._healthy.values() if ok)

    def healthy_actor_ids(self) -> List[int]:
        return [idx for idx, ok in self._healthy.items() if ok]

    def actor(self, actor_id: int) -> Any:
        return self._actors[actor_id]

    # -- fan-out -------------------------------------------------------
    def foreach_actor(
        self,
        method: str,
        *args,
        healthy_only: bool = True,
        timeout: float = 120.0,
        mark_unhealthy_on_failure: bool = True,
        **kwargs,
    ) -> List[CallResult]:
        """Call `method` on every (healthy) actor; per-actor failures
        become CallResult(ok=False) and the actor is marked unhealthy
        (reference: foreach_actor + ResultOrError, never raising for a
        single lost worker)."""
        import ray_tpu_torch as rt

        targets = [
            idx
            for idx in sorted(self._actors)
            if not healthy_only or self._healthy[idx]
        ]
        refs = {}
        results: List[CallResult] = []
        for idx in targets:
            try:
                refs[idx] = getattr(
                    self._actors[idx], method
                ).remote(*args, **kwargs)
            except Exception as e:  # submit-side failure
                results.append(
                    CallResult(actor_id=idx, ok=False, error=e)
                )
                if mark_unhealthy_on_failure:
                    self._healthy[idx] = False
        # CONCURRENT gather (ISSUE 13 satellite): one rt.wait over
        # the whole fan-out instead of serial per-ref round-trips —
        # N healthy actors complete in one pass and a single dead
        # actor costs the remaining budget ONCE, not once per
        # still-pending ref behind it. ONE deadline bounds the pass
        # (sequential timeouts would compound: 3 hung actors = 3x
        # the budget), matching the reference manager's contract.
        import time as _time

        deadline = _time.monotonic() + timeout
        pending = dict(refs)
        while pending:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                break
            ready, _ = rt.wait(
                list(pending.values()),
                num_returns=len(pending),
                timeout=remaining,
            )
            ready_set = set(ready)
            drained = [
                idx for idx, ref in pending.items()
                if ref in ready_set
            ]
            if not drained:
                break  # deadline hit with nothing new
            for idx in drained:
                ref = pending.pop(idx)
                try:
                    value = rt.get(ref, timeout=5)
                    results.append(
                        CallResult(actor_id=idx, ok=True, value=value)
                    )
                except Exception as e:
                    results.append(
                        CallResult(actor_id=idx, ok=False, error=e)
                    )
                    if mark_unhealthy_on_failure:
                        self._healthy[idx] = False
        for idx, ref in pending.items():  # never completed: timeout
            results.append(
                CallResult(
                    actor_id=idx,
                    ok=False,
                    error=TimeoutError(
                        f"{method} on actor {idx} exceeded the "
                        f"{timeout}s fan-out deadline"
                    ),
                )
            )
            if mark_unhealthy_on_failure:
                self._healthy[idx] = False
        results.sort(key=lambda r: r.actor_id)
        return results

    def ok_values(self, results: List[CallResult]) -> List[Any]:
        return [r.value for r in results if r.ok]

    # -- health management --------------------------------------------
    def probe_unhealthy_actors(self, timeout: float = 30.0) -> List[int]:
        """Ping unhealthy slots; replace dead actors from the factory
        and run on_restore on each comeback (reference:
        probe_unhealthy_actors + restored-actor sync). Returns the ids
        restored to the healthy set."""
        import ray_tpu_torch as rt

        restored: List[int] = []
        for idx, ok in list(self._healthy.items()):
            if ok:
                continue
            actor = self._actors[idx]
            alive = False
            try:
                rt.get(actor.ping.remote(), timeout=timeout)
                alive = True
            except Exception:
                alive = False
            if not alive and self._factory is not None:
                try:
                    rt.kill(actor)
                except Exception:
                    pass
                actor = self._factory(idx)
                self._actors[idx] = actor
                try:
                    rt.get(actor.ping.remote(), timeout=timeout)
                    alive = True
                except Exception:
                    alive = False
            if alive:
                if self._on_restore is not None:
                    self._on_restore(idx, actor)
                self._healthy[idx] = True
                restored.append(idx)
        return restored

    def shutdown(self) -> None:
        import ray_tpu_torch as rt

        for actor in self._actors.values():
            try:
                rt.kill(actor)
            except Exception:
                pass
        self._actors.clear()
        self._healthy.clear()
