# Copied from ray_tpu/autoscaler/v2/reconciler.py (JAX-free): module names read ray_tpu_torch.
"""Declarative reconcile pass.

Reference: python/ray/autoscaler/v2/instance_manager/reconciler.py —
one idempotent function diffs three sources of truth (the instance
table, the cloud provider's non-terminated list, the cluster's
reported node states) and emits InstanceUpdateEvents:

  passive transitions (sync with observed reality)
    REQUESTED  -> ALLOCATED          cloud instance appeared
    REQUESTED  -> QUEUED / ALLOCATION_FAILED   launch timeout or error
    ALLOCATED  -> RAY_RUNNING        daemon(s) registered with head
    ALLOCATED  -> RAY_INSTALL_FAILED boot timeout
    RAY_RUNNING-> RAY_STOPPED        daemons vanished from head view
    *          -> TERMINATED         cloud instance vanished
    TERMINATING-> TERMINATION_FAILED terminate call failed (retried)

  active transitions (make reality match demand)
    new QUEUED instances             unmet demand / min_workers floor
    QUEUED     -> REQUESTED          launch slot available
    RAY_RUNNING-> RAY_STOP_REQUESTED idle past timeout, above floor
    RAY_STOPPING / RAY_STOPPED -> TERMINATING
    leaked cloud instances           terminated directly

Slice granularity carries over from v1: one instance whose node type
has slice_hosts > 1 is a whole TPU pod slice; gangs launch one slice,
idle checks require every host daemon idle, termination kills the
whole slice.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..autoscaler import (
    PROVIDER_NODE_LABEL,
    NodeTypeConfig,
    _consume,
    _fits,
)
from .instance import ACTIVE_STATUSES, Instance, InstanceStatus as S
from .instance_manager import InstanceManager, InstanceUpdateEvent


@dataclass
class ReconcileConfig:
    #: REQUESTED older than this retries (or fails permanently).
    request_timeout_s: float = 30.0
    max_launch_attempts: int = 3
    #: ALLOCATED / RAY_INSTALLING older than this is a failed boot.
    install_timeout_s: float = 120.0
    idle_timeout_s: float = 5.0
    max_concurrent_requests: int = 8


@dataclass
class ProviderError:
    """Launch/terminate failure surfaced by the cloud provider."""

    kind: str  # "launch" | "terminate"
    instance_id: Optional[str] = None
    cloud_instance_id: Optional[str] = None
    details: str = ""


@dataclass
class CloudInstance:
    cloud_instance_id: str
    instance_type: str
    #: Launch tag: which Instance requested this cloud node.
    instance_id: Optional[str] = None


class Reconciler:
    """Stateless; everything it needs arrives as arguments."""

    @staticmethod
    def reconcile(
        manager: InstanceManager,
        *,
        node_types: Dict[str, NodeTypeConfig],
        cloud_instances: Dict[str, CloudInstance],
        load: dict,
        config: ReconcileConfig,
        provider_errors: Optional[List[ProviderError]] = None,
        node_ids_of=None,
    ) -> dict:
        """One pass. Applies events through `manager` (versioned) and
        returns {"events": n, "leaked": [cloud ids], "demand": n}.

        `load` is the head's cluster_load payload (nodes / infeasible /
        pending_placement_groups). `node_ids_of(cloud_id) -> [node]`
        maps a cloud instance to its registered daemons; defaults to
        matching the rt.io/provider-node label.
        """
        version, instances = manager.get_state()
        by_id = instances
        events: List[InstanceUpdateEvent] = []
        errors = provider_errors or []
        err_by_instance = {
            e.instance_id: e for e in errors if e.instance_id
        }
        err_by_cloud = {
            e.cloud_instance_id: e
            for e in errors
            if e.cloud_instance_id
        }

        nodes = load.get("nodes", [])

        if node_ids_of is None:

            def node_ids_of(cloud_id: str) -> List[dict]:
                return [
                    n
                    for n in nodes
                    if (n.get("labels") or {}).get(PROVIDER_NODE_LABEL)
                    == cloud_id
                ]

        cloud_by_tag: Dict[str, CloudInstance] = {
            ci.instance_id: ci
            for ci in cloud_instances.values()
            if ci.instance_id
        }
        claimed: Set[str] = {
            inst.cloud_instance_id
            for inst in by_id.values()
            if inst.cloud_instance_id
        }

        # ---- passive: sync instance table with observed reality -----
        for inst in by_id.values():
            if inst.status == S.REQUESTED:
                err = err_by_instance.get(inst.instance_id)
                ci = cloud_by_tag.get(inst.instance_id)
                if ci is not None:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.ALLOCATED,
                            cloud_instance_id=ci.cloud_instance_id,
                            details="cloud instance appeared",
                        )
                    )
                elif err is not None or (
                    inst.seconds_in_status() > config.request_timeout_s
                ):
                    why = (
                        err.details
                        if err
                        else f"launch timeout "
                        f"({config.request_timeout_s}s)"
                    )
                    if (
                        inst.launch_attempts
                        >= config.max_launch_attempts
                    ):
                        events.append(
                            InstanceUpdateEvent(
                                instance_id=inst.instance_id,
                                new_status=S.ALLOCATION_FAILED,
                                details=why,
                            )
                        )
                    else:
                        events.append(
                            InstanceUpdateEvent(
                                instance_id=inst.instance_id,
                                new_status=S.QUEUED,
                                details=f"retrying: {why}",
                            )
                        )
            elif inst.status in (S.ALLOCATED, S.RAY_INSTALLING):
                if inst.cloud_instance_id not in cloud_instances:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.TERMINATED,
                            details="cloud instance vanished",
                        )
                    )
                    continue
                daemons = node_ids_of(inst.cloud_instance_id)
                if daemons:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.RAY_RUNNING,
                            node_ids=[
                                d["node_id"] for d in daemons
                            ],
                            details=f"{len(daemons)} daemon(s) up",
                        )
                    )
                elif (
                    inst.seconds_in_status()
                    > config.install_timeout_s
                ):
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.RAY_INSTALL_FAILED,
                            details="boot timeout",
                        )
                    )
            elif inst.status == S.RAY_RUNNING:
                if inst.cloud_instance_id not in cloud_instances:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.TERMINATED,
                            details="cloud instance vanished",
                        )
                    )
                elif not node_ids_of(inst.cloud_instance_id):
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.RAY_STOPPED,
                            details="daemons gone from head view",
                        )
                    )
            elif inst.status == S.RAY_STOP_REQUESTED:
                # The stopper subscriber normally advances this; the
                # passive edge covers daemons dying under the request.
                if inst.cloud_instance_id not in cloud_instances:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.TERMINATED,
                            details="cloud instance vanished",
                        )
                    )
                elif not node_ids_of(inst.cloud_instance_id):
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.RAY_STOPPED,
                            details="daemons gone from head view",
                        )
                    )
            elif inst.status in (
                S.RAY_STOPPING,
                S.RAY_STOPPED,
                S.RAY_INSTALL_FAILED,
            ):
                if inst.cloud_instance_id not in cloud_instances:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.TERMINATED,
                            details="cloud instance vanished",
                        )
                    )
                else:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.TERMINATING,
                            details="reclaiming cloud instance",
                        )
                    )
            elif inst.status == S.TERMINATING:
                err = err_by_cloud.get(inst.cloud_instance_id)
                if inst.cloud_instance_id not in cloud_instances:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.TERMINATED,
                            details="terminated",
                        )
                    )
                elif err is not None:
                    events.append(
                        InstanceUpdateEvent(
                            instance_id=inst.instance_id,
                            new_status=S.TERMINATION_FAILED,
                            details=err.details,
                        )
                    )
            elif inst.status == S.TERMINATION_FAILED:
                events.append(
                    InstanceUpdateEvent(
                        instance_id=inst.instance_id,
                        new_status=S.TERMINATING,
                        details="retrying terminate",
                    )
                )

        # ---- leaked cloud instances ---------------------------------
        # Unclaimed, and not about to be adopted: only a REQUESTED
        # instance can adopt its tag. A node whose tagged instance
        # already moved on (timed-out retry that later completed, so a
        # SECOND launch got adopted — or the instance failed) must be
        # reclaimed, not orphaned forever.
        leaked = [
            cid
            for cid, ci in cloud_instances.items()
            if cid not in claimed
            and not (
                ci.instance_id is not None
                and ci.instance_id in by_id
                and by_id[ci.instance_id].status == S.REQUESTED
            )
        ]

        # ---- active: scale up ---------------------------------------
        counts: Dict[str, int] = {}
        for inst in by_id.values():
            if inst.is_active():
                counts[inst.instance_type] = (
                    counts.get(inst.instance_type, 0) + 1
                )
        # Account events already emitted this pass that deactivate an
        # instance (vanished cloud nodes etc.) so the floor check
        # relaunches immediately.
        deactivated = {
            ev.instance_id
            for ev in events
            if ev.new_status
            not in ACTIVE_STATUSES | {S.RAY_RUNNING}
            and ev.instance_id
        }
        for iid in deactivated:
            inst = by_id.get(iid)
            if inst is not None and inst.is_active():
                counts[inst.instance_type] = (
                    counts.get(inst.instance_type, 1) - 1
                )

        to_launch: Dict[str, int] = {}
        for name, cfg in node_types.items():
            have = counts.get(name, 0)
            if have < cfg.min_workers:
                to_launch[name] = cfg.min_workers - have

        flat: List[Dict[str, float]] = [
            r for r in load.get("infeasible", []) if r
        ]
        gangs: List[List[Dict[str, float]]] = []
        for pg in load.get("pending_placement_groups", []):
            bundles = [dict(b) for b in pg.get("bundles", []) if b]
            if not bundles:
                continue
            if pg.get("strategy") in ("STRICT_SPREAD", "SPREAD"):
                gangs.append(bundles)
            else:
                flat.extend(bundles)

        # Capacity pool: live daemons' availability + full per-host
        # shape for every active-but-not-yet-registered instance.
        pool: List[Dict[str, float]] = [
            dict(n.get("available", {})) for n in nodes
        ]
        for inst in by_id.values():
            if inst.status in (
                S.QUEUED,
                S.REQUESTED,
                S.ALLOCATED,
                S.RAY_INSTALLING,
            ):
                cfg = node_types.get(inst.instance_type)
                if cfg is not None:
                    pool.extend(
                        dict(cfg.resources)
                        for _ in range(max(1, cfg.slice_hosts))
                    )

        def _room(name: str) -> int:
            cfg = node_types[name]
            return cfg.max_workers - (
                counts.get(name, 0) + to_launch.get(name, 0)
            )

        def _launch_for(request, distinct_needed=1):
            for name, cfg in sorted(
                node_types.items(),
                key=lambda kv: (
                    kv[1].slice_hosts < distinct_needed,
                    kv[1].slice_hosts,
                    kv[0],
                ),
            ):
                if _room(name) <= 0:
                    continue
                if not _fits(request, cfg.resources):
                    continue
                needed = max(
                    1, math.ceil(distinct_needed / cfg.slice_hosts)
                )
                if _room(name) < needed:
                    continue
                to_launch[name] = to_launch.get(name, 0) + needed
                fresh = [
                    dict(cfg.resources)
                    for _ in range(needed * cfg.slice_hosts)
                ]
                pool.extend(fresh)
                return fresh
            return None

        for request in flat:
            for capacity in pool:
                if _fits(request, capacity):
                    _consume(capacity, request)
                    break
            else:
                added = _launch_for(request)
                if added:
                    _consume(added[0], request)

        for bundles in gangs:
            used: set = set()
            unplaced: List[Dict[str, float]] = []
            for request in bundles:
                placed = False
                for idx, capacity in enumerate(pool):
                    if idx in used:
                        continue
                    if _fits(request, capacity):
                        _consume(capacity, request)
                        used.add(idx)
                        placed = True
                        break
                if not placed:
                    unplaced.append(request)
            if unplaced:
                need: Dict[str, float] = {}
                for request in unplaced:
                    for rname, amount in request.items():
                        need[rname] = max(
                            need.get(rname, 0.0), amount
                        )
                added = _launch_for(need, len(unplaced))
                if added:
                    for request, capacity in zip(unplaced, added):
                        _consume(capacity, request)

        for name, n in to_launch.items():
            for _ in range(n):
                events.append(
                    InstanceUpdateEvent(
                        instance_id=None,
                        instance_type=name,
                        new_status=S.QUEUED,
                        details="demand",
                    )
                )

        # ---- active: QUEUED -> REQUESTED (bounded in-flight) --------
        in_flight = sum(
            1
            for i in by_id.values()
            if i.status == S.REQUESTED
        )
        for inst in by_id.values():
            if inst.status != S.QUEUED:
                continue
            if in_flight >= config.max_concurrent_requests:
                break
            events.append(
                InstanceUpdateEvent(
                    instance_id=inst.instance_id,
                    new_status=S.REQUESTED,
                    details="launch slot",
                )
            )
            in_flight += 1

        # ---- active: idle scale-down --------------------------------
        for inst in by_id.values():
            if inst.status != S.RAY_RUNNING:
                continue
            cfg = node_types.get(inst.instance_type)
            if cfg is None:
                continue
            if counts.get(inst.instance_type, 0) <= cfg.min_workers:
                continue
            daemons = node_ids_of(inst.cloud_instance_id)
            if not daemons:
                continue
            busy = any(
                d.get("queued", 0) > 0
                or any(
                    d.get("available", {}).get(k, 0.0) != v
                    for k, v in d.get("total", {}).items()
                )
                for d in daemons
            )
            now = time.time()
            if busy:
                inst.last_busy = now
                continue
            # Idle since whichever is later: last observed busy, or
            # the moment the instance became RAY_RUNNING.
            anchor = max(
                inst.last_busy, inst.history[-1].timestamp
            )
            if now - anchor >= config.idle_timeout_s:
                events.append(
                    InstanceUpdateEvent(
                        instance_id=inst.instance_id,
                        new_status=S.RAY_STOP_REQUESTED,
                        details="idle",
                    )
                )
                counts[inst.instance_type] -= 1

        manager.update(events, expected_version=version)
        return {
            "events": len(events),
            "leaked": leaked,
            "demand": len(flat) + sum(len(g) for g in gangs),
        }
