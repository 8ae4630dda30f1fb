# Copied from ray_tpu/autoscaler/autoscaler.py (JAX-free): module names read ray_tpu_torch.
"""Demand-driven autoscaler.

Reference: python/ray/autoscaler/_private/autoscaler.py
(StandardAutoscaler.update reconcile loop) + resource_demand_scheduler
.py (bin-pack pending demand into node types) + monitor.py (the
polling daemon); v2 reads the same demand from
GcsAutoscalerStateManager — which is what our `cluster_load` head RPC
mirrors.

Loop: read demand (infeasible tasks + pending placement-group
bundles) -> bin-pack what doesn't fit on live/launching nodes into the
cheapest satisfying node types (bounded by max_workers) -> launch;
terminate workers idle past idle_timeout (respecting min_workers).

Slice granularity: a node type with `slice_hosts > 1` is a TPU pod
slice — ONE provider node that boots N host daemons (reference:
gcp/node.py GCPTPUNode spans numNetworkEndpoints hosts). Pending
STRICT_SPREAD gangs (slice_placement_group) are packed onto distinct
hosts, and an unmet gang launches one slice — never N separate nodes —
so slice scale-up is atomic.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .node_provider import NodeProvider

#: Cluster-side label a daemon carries to name its cloud node; N slice
#: host daemons share one value (gcp/node_provider.py writes it into
#: the startup script).
PROVIDER_NODE_LABEL = "rt.io/provider-node"


@dataclass
class NodeTypeConfig:
    resources: Dict[str, float]  # PER-HOST resources
    min_workers: int = 0
    max_workers: int = 10
    labels: Dict[str, str] = field(default_factory=dict)
    #: Hosts that join per provider node (1 = plain VM; >1 = pod slice).
    slice_hosts: int = 1


def _fits(request: Dict[str, float], capacity: Dict[str, float]) -> bool:
    return all(
        capacity.get(name, 0.0) >= amount
        for name, amount in request.items()
    )


def _consume(capacity: Dict[str, float], request: Dict[str, float]):
    for name, amount in request.items():
        capacity[name] = capacity.get(name, 0.0) - amount


class StandardAutoscaler:
    def __init__(
        self,
        provider: NodeProvider,
        node_types: Dict[str, NodeTypeConfig],
        *,
        idle_timeout_s: float = 5.0,
        upscaling_speed: float = 1.0,
        launch_timeout_s: float = 600.0,
    ):
        self.provider = provider
        self.node_types = node_types
        self.idle_timeout_s = idle_timeout_s
        self.upscaling_speed = upscaling_speed
        #: How long a provider node's not-yet-joined hosts count as
        #: launching capacity. Past it, a missing host is presumed
        #: dead, not booting — its capacity stops masking demand, so a
        #: gang waiting on it launches replacements instead of
        #: wedging forever (reference: the autoscaler's node launch
        #: timeout / NODE_STARTUP_TIMEOUT).
        self.launch_timeout_s = launch_timeout_s
        self._last_busy: Dict[str, float] = {}
        #: provider node -> first time this reconcile loop saw it
        #: (drives the launch timeout above).
        self._first_seen: Dict[str, float] = {}
        self._client = None
        self._launched_types: Dict[str, int] = {}

    # -- demand --------------------------------------------------------
    def _load(self) -> dict:
        from .._private.rpc import RpcClient

        if self._client is None:
            self._client = RpcClient(self.provider.head_address)
        return self._client.call("cluster_load")

    def _daemons_of(self, provider_id: str, load: dict) -> List[dict]:
        """Cluster nodes belonging to one provider node: by the
        provider-node label (slice nodes, N daemons), falling back to
        the provider's own single-node mapping."""
        daemons = [
            n
            for n in load["nodes"]
            if (n.get("labels") or {}).get(PROVIDER_NODE_LABEL)
            == provider_id
        ]
        if daemons:
            return daemons
        cid = self.provider.cluster_node_id(provider_id)
        return [n for n in load["nodes"] if n["node_id"] == cid]

    # -- one reconcile pass (reference: StandardAutoscaler.update) ----
    def update(self) -> dict:
        load = self._load()

        # Demand. Gangs (STRICT_SPREAD / SPREAD placement groups) need
        # DISTINCT hosts per bundle; everything else packs freely.
        flat: List[Dict[str, float]] = [
            r for r in load["infeasible"] if r
        ]
        gangs: List[List[Dict[str, float]]] = []
        for pg in load["pending_placement_groups"]:
            bundles = [dict(b) for b in pg["bundles"] if b]
            if not bundles:
                continue
            if pg.get("strategy") in ("STRICT_SPREAD", "SPREAD"):
                gangs.append(bundles)
            else:
                flat.extend(bundles)

        # Capacity pools: one entry per live daemon + one per HOST of
        # every launching provider node (a booting v5e-16 slice is 4
        # distinct prospective hosts, not one blob). Two parallel
        # views of the same hosts:
        #   pool     — AVAILABLE capacity; pending task/gang demand
        #              packs here (it will actually consume it);
        #   req_pool — TOTAL capacity; explicit resource_requests pack
        #              here (reference: HandleRequestClusterResource-
        #              Constraint checks node totals regardless of
        #              utilization — a standing target asks "can the
        #              cluster HOLD this", so a busy node still
        #              satisfies its bundle and must not trigger an
        #              over-launch or flap when tasks consume it).
        pool: List[Dict[str, float]] = [
            dict(node["available"]) for node in load["nodes"]
        ]
        req_pool: List[Dict[str, float]] = [
            dict(node["total"]) for node in load["nodes"]
        ]
        now = time.time()
        provider_nodes = self.provider.non_terminated_nodes()
        self._first_seen = {
            p: self._first_seen.get(p, now) for p in provider_nodes
        }
        counts: Dict[str, int] = {}
        for p in provider_nodes:
            node_type = self.provider.node_type(p)
            counts[node_type] = counts.get(node_type, 0) + 1
            cfg = self.node_types.get(node_type)
            if cfg is None:
                continue
            # Launching capacity is counted PER HOST, not per node: a
            # booting v5e-16 slice whose first daemon has joined still
            # owes 3 more hosts, and those prospective hosts must
            # cover the pending gang's remainder — or every reconcile
            # tick during the multi-host boot window launches another
            # whole slice (the test_slice_pg double-launch bug). Only
            # within the launch timeout: past it a missing host is
            # dead, and phantom capacity would wedge the gang forever.
            if now - self._first_seen[p] > self.launch_timeout_s:
                continue
            joined = len(self._daemons_of(p, load))
            missing = max(1, cfg.slice_hosts) - joined
            for _ in range(max(0, missing)):
                pool.append(dict(cfg.resources))
                req_pool.append(dict(cfg.resources))

        # min_workers floor. Floor-booked nodes contribute capacity to
        # the pools so demand packed later (requests, tasks) does not
        # double-launch what the floor already covers.
        to_launch: Dict[str, int] = {}
        for name, cfg in self.node_types.items():
            if counts.get(name, 0) < cfg.min_workers:
                short = cfg.min_workers - counts.get(name, 0)
                to_launch[name] = short
                for _ in range(short * max(1, cfg.slice_hosts)):
                    pool.append(dict(cfg.resources))
                    req_pool.append(dict(cfg.resources))

        def _type_room(name: str) -> int:
            cfg = self.node_types[name]
            return cfg.max_workers - (
                counts.get(name, 0) + to_launch.get(name, 0)
            )

        def _launch_for(request: Dict[str, float], distinct_needed=1):
            """Pick the first node type that fits `request` per host
            and can supply `distinct_needed` hosts in as few provider
            nodes as possible. Returns (available-pool entries,
            total-pool entries) added — one per new host — or None."""
            for name, cfg in sorted(
                self.node_types.items(),
                # Prefer types whose slice covers the whole gang in
                # one node (slice-granular scale-up), then fewer
                # wasted hosts.
                key=lambda kv: (
                    kv[1].slice_hosts < distinct_needed,
                    kv[1].slice_hosts,
                    kv[0],
                ),
            ):
                if _type_room(name) <= 0:
                    continue
                if not _fits(request, cfg.resources):
                    continue
                nodes_needed = max(
                    1, math.ceil(distinct_needed / cfg.slice_hosts)
                )
                if _type_room(name) < nodes_needed:
                    continue
                to_launch[name] = to_launch.get(name, 0) + nodes_needed
                fresh = [
                    dict(cfg.resources)
                    for _ in range(nodes_needed * cfg.slice_hosts)
                ]
                fresh_total = [
                    dict(cfg.resources)
                    for _ in range(nodes_needed * cfg.slice_hosts)
                ]
                pool.extend(fresh)
                req_pool.extend(fresh_total)
                return fresh, fresh_total
            return None

        # Explicit resource requests (reference: autoscaler sdk
        # request_resources): a standing TARGET the cluster must be
        # able to hold. Bundles pack against node TOTALS (req_pool) —
        # matching HandleRequestClusterResourceConstraint — so a node
        # whose availability is temporarily consumed by tasks still
        # satisfies its bundle instead of triggering extra launches
        # and flapping. Satisfied bundles HOLD their nodes against
        # idle scale-down — terminating one would immediately recreate
        # the demand and flap the node back up.
        held_nodes: set = set()
        unsatisfied_requests = 0
        daemon_count = len(load["nodes"])
        requests = load.get("resource_requests") or []
        for request in requests:
            placed = False
            for idx, capacity in enumerate(req_pool):
                if _fits(request, capacity):
                    _consume(capacity, request)
                    if idx < daemon_count:
                        held_nodes.add(load["nodes"][idx]["node_id"])
                    placed = True
                    break
            if not placed:
                added = _launch_for(request)
                if added:
                    _consume(added[1][0], request)
                else:
                    # No node type fits (or max_workers reached): the
                    # standing target cannot be met — surface it
                    # rather than silently dropping it every tick.
                    unsatisfied_requests += 1

        # Bin-pack flat demand (reference: resource_demand_scheduler).
        for request in flat:
            placed = False
            for capacity in pool:
                if _fits(request, capacity):
                    _consume(capacity, request)
                    placed = True
                    break
            if not placed:
                added = _launch_for(request)
                if added:
                    _consume(added[0][0], request)
            # Unplaceable anywhere: reported, not fatal.

        # Pack gangs: each bundle on a DISTINCT pool entry; an unmet
        # remainder launches whole slices (one provider node covers up
        # to slice_hosts bundles — the slice_placement_group ->
        # tpu-v5e-16 path).
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
                # Launch hosts each able to hold ANY of the unplaced
                # bundles: size the per-host requirement as the
                # elementwise max across bundles (slice gangs are
                # uniform chip sets, but a heterogeneous STRICT_SPREAD
                # must not pick a host shape that fits only one
                # bundle kind).
                need: Dict[str, float] = {}
                for request in unplaced:
                    for name, amount in request.items():
                        need[name] = max(need.get(name, 0.0), amount)
                added = _launch_for(need, len(unplaced))
                if added:
                    for request, capacity in zip(unplaced, added[0]):
                        _consume(capacity, request)

        launched = []
        for name, count in to_launch.items():
            cfg = self.node_types[name]
            for _ in range(count):
                launched.append(
                    self.provider.create_node(
                        name, cfg.resources, cfg.labels
                    )
                )

        # Scale down idle provider nodes. A slice node is idle only
        # when EVERY host daemon is idle (reference: idle node
        # termination; v2 kills whole TPU pods, never partial slices).
        terminated = []
        for p in list(provider_nodes):
            daemons = self._daemons_of(p, load)
            if not daemons:
                continue  # still launching
            if any(n["node_id"] in held_nodes for n in daemons):
                # Capacity pinned by an explicit resource request.
                self._last_busy[p] = now
                continue
            busy = any(
                node["queued"] > 0
                or any(
                    node["available"].get(k, 0.0) != v
                    for k, v in node["total"].items()
                )
                for node in daemons
            )
            if busy:
                self._last_busy[p] = now
                continue
            idle_for = now - self._last_busy.setdefault(p, now)
            node_type = self.provider.node_type(p)
            cfg = self.node_types.get(node_type)
            type_count = counts.get(node_type, 0)
            if (
                cfg is not None
                and idle_for >= self.idle_timeout_s
                and type_count > cfg.min_workers
            ):
                self.provider.terminate_node(p)
                counts[node_type] = type_count - 1
                terminated.append(p)
        return {
            "demand": len(flat)
            + sum(len(g) for g in gangs)
            + len(requests),
            "unsatisfied_requests": unsatisfied_requests,
            "launched": launched,
            "terminated": terminated,
        }


class Monitor:
    """Background reconcile loop (reference: _private/monitor.py)."""

    def __init__(
        self, autoscaler: StandardAutoscaler, interval_s: float = 0.5
    ):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception:
                pass
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
