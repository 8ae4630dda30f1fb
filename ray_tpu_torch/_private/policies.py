# Copied from ray_tpu/_private/policies.py (JAX-free): module names read ray_tpu_torch.
"""Cluster scheduling policies.

Reimplements the reference's pluggable node-selection policies
(reference: src/ray/raylet/scheduling/policy/ — hybrid policy
hybrid_scheduling_policy.h:14-40 packs onto the local node up to a
utilization threshold then spreads; spread_scheduling_policy.cc
round-robins; node_affinity_scheduling_policy.cc pins to a node with a
soft fallback; node_label_scheduling_policy.cc matches label
expressions). Placement here is centralized on the head daemon, which
holds the cluster load view refreshed by heartbeats — functionally the
path a task takes through GCS-based scheduling rather than raylet
spillback.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .scheduler import ResourceSet


@dataclass
class NodeView:
    """Head-side snapshot of one node used for placement decisions."""

    node_id: bytes
    total: ResourceSet
    available: ResourceSet
    labels: Dict[str, str] = field(default_factory=dict)
    is_local: bool = False  # the head node itself


def _utilization(node: NodeView) -> float:
    total = node.total.to_dict()
    avail = node.available.to_dict()
    worst = 0.0
    for name, cap in total.items():
        if cap <= 0:
            continue
        used = cap - avail.get(name, 0.0)
        worst = max(worst, used / cap)
    return worst


def _feasible(nodes: List[NodeView], request: ResourceSet) -> List[NodeView]:
    return [n for n in nodes if request.fits_in(n.total)]


def _label_match(node: NodeView, expr: Dict[str, list]) -> bool:
    # expr: {key: [allowed values]}; empty list means "key exists".
    for key, allowed in expr.items():
        value = node.labels.get(key)
        if value is None:
            return False
        if allowed and value not in allowed:
            return False
    return True


class PlacementPolicy:
    """Stateful picker: round-robin memory for SPREAD lives here."""

    def __init__(self, spread_threshold: float = 0.5, top_k_frac: float = 0.2):
        self._spread_threshold = spread_threshold
        self._top_k_frac = top_k_frac
        self._spread_index = 0

    def pick(
        self,
        nodes: List[NodeView],
        request: ResourceSet,
        strategy: Optional[dict] = None,
    ) -> Optional[bytes]:
        """Return the chosen node_id, or None if no feasible node exists
        (the task is infeasible until the cluster changes)."""
        strategy = strategy or {"type": "DEFAULT"}
        kind = strategy.get("type", "DEFAULT")
        if kind == "NODE_AFFINITY":
            target = strategy["node_id"]
            if isinstance(target, str):
                target = bytes.fromhex(target)
            for n in nodes:
                if n.node_id == target and request.fits_in(n.total):
                    return target
            if strategy.get("soft"):
                return self._hybrid(nodes, request)
            return None
        if kind == "NODE_LABEL":
            hard = strategy.get("hard") or {}
            soft = strategy.get("soft") or {}
            matching = [n for n in nodes if _label_match(n, hard)]
            preferred = [n for n in matching if _label_match(n, soft)]
            return self._hybrid(preferred or matching, request)
        if kind == "SPREAD":
            return self._spread(nodes, request)
        return self._hybrid(nodes, request)

    def _spread(
        self, nodes: List[NodeView], request: ResourceSet
    ) -> Optional[bytes]:
        feasible = _feasible(nodes, request)
        if not feasible:
            return None
        feasible.sort(key=lambda n: n.node_id)
        # Prefer nodes that can run it now, keeping round-robin order.
        for offset in range(len(feasible)):
            node = feasible[(self._spread_index + offset) % len(feasible)]
            if request.fits_in(node.available):
                self._spread_index = (
                    self._spread_index + offset + 1
                ) % len(feasible)
                return node.node_id
        node = feasible[self._spread_index % len(feasible)]
        self._spread_index = (self._spread_index + 1) % len(feasible)
        return node.node_id

    def _hybrid(
        self, nodes: List[NodeView], request: ResourceSet
    ) -> Optional[bytes]:
        """Local-first up to the utilization threshold, then best-fit
        across the cluster; ties broken randomly over the top-k least
        utilized (reference: HybridSchedulingPolicy)."""
        feasible = _feasible(nodes, request)
        if not feasible:
            return None
        local = next((n for n in feasible if n.is_local), None)
        if (
            local is not None
            and request.fits_in(local.available)
            and _utilization(local) <= self._spread_threshold
        ):
            return local.node_id
        runnable = [n for n in feasible if request.fits_in(n.available)]
        pool = runnable or feasible
        pool = sorted(pool, key=_utilization)
        k = max(1, int(len(pool) * self._top_k_frac))
        return random.choice(pool[:k]).node_id
