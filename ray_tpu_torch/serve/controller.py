# Copied from ray_tpu/serve/controller.py (JAX-free): module names read ray_tpu_torch.
"""Serve controller actor.

Reference: python/ray/serve/_private/controller.py:84 — a singleton
controller reconciles declared application/deployment state against
live replica actors (deployment_state.py), autoscales on reported
ongoing-request load (autoscaling_state.py), and serves route +
replica-membership lookups to routers/proxies via LONG-POLL PUSH
(long_poll.py LongPollHost: listeners block on a snapshot id and are
released the moment state changes — no TTL staleness window).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

CONTROLLER_NAME = "SERVE_CONTROLLER"

#: Server-side cap on one long-poll blocking call; listeners loop.
LONG_POLL_TIMEOUT_S = 30.0


class ServeController:
    def __init__(self):
        import ray_tpu_torch as rt

        self._rt = rt
        self._lock = threading.RLock()
        # apps[app] = {"route_prefix", "ingress", "deployments": {name: spec}}
        self._apps: Dict[str, dict] = {}
        # replicas[(app, dep)] = [{"id", "actor", "version"}]
        self._replicas: Dict[Tuple[str, str], List[dict]] = {}
        # handle metrics: {(app, dep): {handle_id: (ts, ongoing)}}
        self._metrics: Dict[Tuple[str, str], Dict[str, tuple]] = {}
        self._desired_since: Dict[Tuple[str, str], tuple] = {}
        self._replica_seq = 0
        self._shutdown = False
        # Long-poll host state (reference: long_poll.py LongPollHost):
        # every pushable key has a monotonically increasing snapshot
        # id; listeners block on the condvar until a key they watch
        # moves past the id they already have.
        self._snapshot_ids: Dict[str, int] = {}
        self._longpoll_cv = threading.Condition(self._lock)
        self._autoscaler = threading.Thread(
            target=self._autoscale_loop, daemon=True
        )
        self._autoscaler.start()

    # -- deploy --------------------------------------------------------
    def deploy_app(
        self, app_name: str, route_prefix: Optional[str], specs: List[dict]
    ) -> bool:
        with self._lock:
            ingress = next(s["name"] for s in specs if s.get("ingress"))
            self._apps[app_name] = {
                "route_prefix": route_prefix,
                "ingress": ingress,
                "deployments": {s["name"]: s for s in specs},
            }
        for spec in specs:
            self._reconcile_deployment(app_name, spec)
        self._bump(
            "routes",
            *(f"spec:{app_name}/{s['name']}" for s in specs),
        )
        return True

    def _reconcile_deployment(self, app: str, spec: dict) -> None:
        key = (app, spec["name"])
        with self._lock:
            existing = self._replicas.setdefault(key, [])
            # Version change: replace every replica (reference:
            # deployment_state rolling update, simplified to recreate).
            stale = [
                r for r in existing if r["version"] != spec["version"]
            ]
            keep = [r for r in existing if r["version"] == spec["version"]]
            self._replicas[key] = keep
        for replica in stale:
            self._stop_replica(replica)
        if stale:
            self._bump(f"replicas:{app}/{spec['name']}")
        target = spec["num_replicas"]
        if spec.get("autoscaling"):
            target = max(
                spec["autoscaling"]["min_replicas"],
                min(target, spec["autoscaling"]["max_replicas"]),
            )
        self._scale_to(app, spec, target)

    def _scale_to(self, app: str, spec: dict, target: int) -> None:
        key = (app, spec["name"])
        while True:
            with self._lock:
                current = len(self._replicas[key])
                if current >= target:
                    excess = self._replicas[key][target:]
                    self._replicas[key] = self._replicas[key][:target]
                else:
                    excess = None
            if excess is not None:
                for replica in excess:
                    self._stop_replica(replica)
                if excess:
                    self._bump(f"replicas:{app}/{spec['name']}")
                return
            self._start_replica(app, spec)

    def _start_replica(self, app: str, spec: dict) -> None:
        import cloudpickle

        from .replica import Replica

        with self._lock:
            self._replica_seq += 1
            replica_id = f"{app}#{spec['name']}#{self._replica_seq}"
        options = dict(spec.get("actor_options") or {})
        options.setdefault("num_cpus", 1)
        # Replicas interleave requests up to max_ongoing_requests via
        # actor concurrency (reference: serve replicas are async actors
        # bounded by max_ongoing_requests) — before max_concurrency
        # existed, batching had to live handle-side in the router.
        options.setdefault(
            "max_concurrency", int(spec.get("max_ongoing_requests") or 8)
        )
        actor_cls = self._rt.remote(**options)(Replica)
        handle = actor_cls.remote(
            cloudpickle.loads(spec["cls_blob"]),
            spec["init_args"],
            spec["init_kwargs"],
            replica_id,
            app_name=app,
            deployment_name=spec["name"],
        )
        # Block until the replica's constructor ran (readiness probe);
        # it reports its node so routers can prefer local replicas.
        node_id = self._rt.get(handle.node_id.remote(), timeout=60)
        with self._lock:
            self._replicas[(app, spec["name"])].append(
                {
                    "id": replica_id,
                    "actor": handle,
                    "version": spec["version"],
                    "node_id": node_id,
                }
            )
        self._bump(f"replicas:{app}/{spec['name']}")

    def _stop_replica(self, replica: dict) -> None:
        try:
            self._rt.kill(replica["actor"])
        except Exception:
            pass

    # -- long poll -----------------------------------------------------
    def _bump(self, *keys: str) -> None:
        """Advance snapshot ids and release blocked listeners (caller
        need not hold the lock)."""
        with self._longpoll_cv:
            for key in keys:
                self._snapshot_ids[key] = (
                    self._snapshot_ids.get(key, 0) + 1
                )
            self._longpoll_cv.notify_all()

    def _snapshot_value(self, key: str):
        if key == "routes":
            return self.get_routes()
        kind, _, rest = key.partition(":")
        if kind == "replicas":
            app, _, dep = rest.partition("/")
            return self.get_replicas(app, dep)
        if kind == "spec":
            app, _, dep = rest.partition("/")
            try:
                return self.get_deployment_spec(app, dep)
            except KeyError:
                return None
        raise ValueError(f"unknown long-poll key {key!r}")

    def listen_for_change(self, watched: Dict[str, int]) -> dict:
        """Block until any watched key's snapshot id exceeds the
        caller's, then return {key: {"snapshot_id", "value"}} for the
        changed keys; {} on server-side timeout (caller re-arms).
        Runs on the controller's thread pool (max_concurrency), so
        many routers/proxies can hold open polls concurrently
        (reference: long_poll.py LongPollHost.listen_for_change)."""
        deadline = time.time() + LONG_POLL_TIMEOUT_S
        with self._longpoll_cv:
            while not self._shutdown:
                changed = {
                    key: seen
                    for key, seen in watched.items()
                    if self._snapshot_ids.get(key, 0) > seen
                }
                if changed:
                    break
                remaining = deadline - time.time()
                if remaining <= 0:
                    return {}
                self._longpoll_cv.wait(timeout=remaining)
            if self._shutdown:
                return {}
            out = {}
            for key in changed:
                out[key] = {
                    "snapshot_id": self._snapshot_ids.get(key, 0),
                    "value": self._snapshot_value(key),
                }
            return out

    # -- lookups -------------------------------------------------------
    def get_routes(self) -> Dict[str, Tuple[str, str]]:
        with self._lock:
            return {
                state["route_prefix"]: (app, state["ingress"])
                for app, state in self._apps.items()
                if state["route_prefix"]
            }

    def get_replicas(self, app: str, deployment: str) -> List[dict]:
        with self._lock:
            return [
                {
                    "id": r["id"],
                    "actor": r["actor"],
                    "node_id": r.get("node_id"),
                    # Multiplexed model ids loaded on this replica;
                    # routers prefer warm holders (reference:
                    # multiplexed_replicas ranking in the replica
                    # scheduler).
                    "model_ids": list(r.get("model_ids", ())),
                }
                for r in self._replicas.get((app, deployment), [])
            ]

    def record_multiplexed(
        self,
        app: str,
        deployment: str,
        replica_id: str,
        model_ids: List[str],
    ) -> bool:
        """A replica's multiplex LRU changed; push the new holder set
        to routers over the replicas long-poll key (reference:
        replicas push model ids via controller long-poll)."""
        with self._lock:
            for r in self._replicas.get((app, deployment), []):
                if r["id"] == replica_id:
                    r["model_ids"] = list(model_ids)
                    break
            else:
                return False
        self._bump(f"replicas:{app}/{deployment}")
        return True

    def get_deployment_spec(self, app: str, deployment: str) -> dict:
        with self._lock:
            spec = self._apps[app]["deployments"][deployment]
            return {
                k: spec.get(k)
                for k in (
                    "name",
                    "num_replicas",
                    "version",
                    "batched_methods",
                    "autoscaling",
                    "ingress_streaming",
                )
            }

    def _in_flight(self, app: str, name: str, now: float) -> float:
        """Requests currently routed-but-unresolved for a deployment:
        the sum of every handle's freshly-reported ongoing count
        (stale handles — exited drivers — age out of the sum). Caller
        holds the lock."""
        return sum(
            value
            for ts, value in self._metrics.get(
                (app, name), {}
            ).values()
            if now - ts < 2.0
        )

    def status(self) -> dict:
        now = time.time()
        with self._lock:
            return {
                app: {
                    "route_prefix": state["route_prefix"],
                    "deployments": {
                        name: {
                            "replicas": len(
                                self._replicas.get((app, name), [])
                            ),
                            "version": spec["version"],
                            "in_flight": self._in_flight(
                                app, name, now
                            ),
                        }
                        for name, spec in state["deployments"].items()
                    },
                }
                for app, state in self._apps.items()
            }

    # -- autoscaling ---------------------------------------------------
    def report_metrics(
        self, app: str, deployment: str, handle_id: str, ongoing: float
    ) -> None:
        with self._lock:
            self._metrics.setdefault((app, deployment), {})[
                handle_id
            ] = (time.time(), ongoing)

    def _autoscale_loop(self) -> None:
        while not self._shutdown:
            time.sleep(0.25)
            try:
                self._autoscale_tick()
            except Exception:
                pass

    def _autoscale_tick(self) -> None:
        now = time.time()
        with self._lock:
            work = []
            for app, state in self._apps.items():
                for name, spec in state["deployments"].items():
                    cfg = spec.get("autoscaling")
                    if not cfg:
                        continue
                    ongoing = self._in_flight(app, name, now)
                    current = len(self._replicas.get((app, name), []))
                    desired = max(
                        cfg["min_replicas"],
                        min(
                            cfg["max_replicas"],
                            math.ceil(
                                ongoing
                                / max(
                                    cfg["target_ongoing_requests"], 1e-9
                                )
                            ),
                        ),
                    )
                    key = (app, name)
                    prev = self._desired_since.get(key)
                    if prev is None or prev[0] != desired:
                        self._desired_since[key] = (desired, now)
                        continue
                    held = now - prev[1]
                    delay = (
                        cfg["upscale_delay_s"]
                        if desired > current
                        else cfg["downscale_delay_s"]
                    )
                    if desired != current and held >= delay:
                        work.append((app, dict(spec), desired))
        for app, spec, desired in work:
            self._scale_to(app, spec, desired)

    # -- teardown ------------------------------------------------------
    def delete_app(self, app_name: str) -> bool:
        with self._lock:
            state = self._apps.pop(app_name, None)
            if state is None:
                return False
            keys = [
                (app_name, name) for name in state["deployments"]
            ]
            doomed = []
            for key in keys:
                doomed.extend(self._replicas.pop(key, []))
        for replica in doomed:
            self._stop_replica(replica)
        self._bump(
            "routes", *(f"replicas:{app}/{dep}" for app, dep in keys)
        )
        return True

    def shutdown_all(self) -> bool:
        with self._lock:
            apps = list(self._apps)
        for app in apps:
            self.delete_app(app)
        self._shutdown = True
        with self._longpoll_cv:  # release all blocked listeners
            self._longpoll_cv.notify_all()
        return True
