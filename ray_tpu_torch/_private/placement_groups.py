# Copied from ray_tpu/_private/placement_groups.py (JAX-free): module names read ray_tpu_torch.
"""Placement-group bookkeeping and bundle placement.

Reference semantics: gcs_server/gcs_placement_group_manager.cc drives a
2PC prepare/commit of bundle resources against raylets
(raylet/placement_group_resource_manager.h); committed bundles surface
as formatted node resources `{R}_group_{pg}` / `{R}_group_{idx}_{pg}`
plus a `bundle_group_*` marker pool, and tasks scheduled into the group
have their resource requests rewritten to those names — so the ordinary
cluster scheduler handles placement-group affinity with no special
cases. Bundle-placement strategies per
raylet/scheduling/policy/bundle_scheduling_policy.cc: PACK / SPREAD /
STRICT_PACK / STRICT_SPREAD.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .policies import NodeView
from .scheduler import ResourceSet

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")

# Marker-pool size per bundle; tasks gated on the group take 0.001 of
# it (reference: BundleSpecification::GetFormattedResources).
BUNDLE_POOL = 1000.0


@dataclass
class PGEntry:
    pg_id: bytes
    bundles: List[dict]
    strategy: str
    name: str
    state: str = "PENDING"  # PENDING|CREATED|RESCHEDULING|REMOVED
    bundle_nodes: List[Optional[bytes]] = field(default_factory=list)

    def __post_init__(self):
        if not self.bundle_nodes:
            self.bundle_nodes = [None] * len(self.bundles)

    def to_table_entry(self) -> dict:
        return {
            "placement_group_id": self.pg_id.hex(),
            "name": self.name,
            "strategy": self.strategy,
            "bundles": list(self.bundles),
            "state": self.state,
            "bundle_nodes": [
                n.hex() if n else None for n in self.bundle_nodes
            ],
        }


def group_resources(pg_hex: str, index: int, bundle: dict) -> dict:
    """Node resources created when a bundle commits."""
    out: Dict[str, float] = {}
    for name, amount in bundle.items():
        out[f"{name}_group_{pg_hex}"] = (
            out.get(f"{name}_group_{pg_hex}", 0.0) + amount
        )
        out[f"{name}_group_{index}_{pg_hex}"] = amount
    out[f"bundle_group_{pg_hex}"] = BUNDLE_POOL
    out[f"bundle_group_{index}_{pg_hex}"] = BUNDLE_POOL
    return out


def rewrite_request(resources: dict, pg_hex: str, index: int) -> dict:
    """Rewrite a task's resource request to target the group's
    formatted resources (wildcard when index < 0)."""
    out: Dict[str, float] = {}
    for name, amount in resources.items():
        if index >= 0:
            out[f"{name}_group_{index}_{pg_hex}"] = amount
        else:
            out[f"{name}_group_{pg_hex}"] = amount
    marker = (
        f"bundle_group_{index}_{pg_hex}"
        if index >= 0
        else f"bundle_group_{pg_hex}"
    )
    out[marker] = 0.001
    return out


class _SimNode:
    """Mutable available-view used while assigning bundles."""

    __slots__ = ("node_id", "available", "used")

    def __init__(self, view: NodeView):
        self.node_id = view.node_id
        self.available = view.available
        self.used = False

    def fits(self, request: ResourceSet) -> bool:
        return request.fits_in(self.available)

    def take(self, request: ResourceSet) -> None:
        self.available = self.available.subtract(request)
        self.used = True


def place_bundles(
    bundles: Sequence[dict],
    strategy: str,
    views: Sequence[NodeView],
    *,
    exclude: Sequence[bytes] = (),
) -> Optional[List[bytes]]:
    """Pick a node for every bundle; None if infeasible right now.

    `exclude` bars nodes from selection (used when rescheduling a
    STRICT_SPREAD group whose surviving bundles already occupy nodes).
    """
    sims = [
        _SimNode(v) for v in views if v.node_id not in set(exclude)
    ]
    requests = [ResourceSet(b) for b in bundles]
    if strategy == "STRICT_PACK":
        whole = ResourceSet()
        for r in requests:
            whole = whole.add(r)
        for sim in sims:
            if sim.fits(whole):
                return [sim.node_id] * len(bundles)
        return None
    if strategy == "STRICT_SPREAD":
        if len(sims) < len(bundles):
            return None
        return _assign_spread(requests, sims, strict=True)
    if strategy == "SPREAD":
        return _assign_spread(requests, sims, strict=False)
    return _assign_pack(requests, sims)


def _assign_pack(
    requests: List[ResourceSet], sims: List[_SimNode]
) -> Optional[List[bytes]]:
    """Greedy: keep filling nodes already holding bundles of this
    group before opening a new node (minimises node count)."""
    assignment: List[Optional[bytes]] = [None] * len(requests)
    for i, req in enumerate(requests):
        chosen = None
        for sim in sims:
            if sim.used and sim.fits(req):
                chosen = sim
                break
        if chosen is None:
            for sim in sims:
                if sim.fits(req):
                    chosen = sim
                    break
        if chosen is None:
            return None
        chosen.take(req)
        assignment[i] = chosen.node_id
    return assignment  # type: ignore[return-value]


def _assign_spread(
    requests: List[ResourceSet], sims: List[_SimNode], *, strict: bool
) -> Optional[List[bytes]]:
    """Distinct nodes first; soft spread falls back to reuse."""
    assignment: List[Optional[bytes]] = [None] * len(requests)
    for i, req in enumerate(requests):
        fresh = [s for s in sims if not s.used and s.fits(req)]
        if fresh:
            chosen = fresh[0]
        elif strict:
            return None
        else:
            reusable = [s for s in sims if s.fits(req)]
            if not reusable:
                return None
            chosen = reusable[0]
        chosen.take(req)
        assignment[i] = chosen.node_id
    return assignment  # type: ignore[return-value]
