# Copied from ray_tpu/util/scheduling_strategies.py (JAX-free): module names read ray_tpu_torch.
"""Scheduling strategies for tasks and actors.

Reference: python/ray/util/scheduling_strategies.py —
NodeAffinitySchedulingStrategy:41, NodeLabelSchedulingStrategy:135,
plus the "SPREAD"/"DEFAULT" string strategies accepted by
`.options(scheduling_strategy=...)`. PlacementGroupSchedulingStrategy
is added with placement groups.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin a task/actor to a node. `soft=True` falls back to the
    default policy when the node is gone or infeasible."""

    node_id: str  # hex node id (from ray_tpu_torch.nodes())
    soft: bool = False

    def to_spec(self) -> dict:
        return {
            "type": "NODE_AFFINITY",
            "node_id": self.node_id,
            "soft": self.soft,
        }


@dataclass
class NodeLabelSchedulingStrategy:
    """Match nodes by labels: `hard` must match; `soft` is preferred.
    Values map label key -> list of allowed values (empty = exists)."""

    hard: Dict[str, List[str]] = field(default_factory=dict)
    soft: Dict[str, List[str]] = field(default_factory=dict)

    def to_spec(self) -> dict:
        return {"type": "NODE_LABEL", "hard": self.hard, "soft": self.soft}


@dataclass
class PlacementGroupSchedulingStrategy:
    """Schedule a task/actor into a placement group's reserved bundle
    resources. `placement_group_bundle_index=-1` targets any bundle
    (the group's wildcard resources)."""

    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    def to_spec(self) -> dict:
        return {
            "type": "PLACEMENT_GROUP",
            "pg_id": self.placement_group.id,
            "bundle_index": self.placement_group_bundle_index,
            "capture": self.placement_group_capture_child_tasks,
        }


def strategy_to_spec(strategy) -> dict | None:
    """Normalize a user-facing strategy option into the wire dict."""
    if strategy is None:
        return None
    if isinstance(strategy, str):
        if strategy not in ("DEFAULT", "SPREAD"):
            raise ValueError(f"unknown scheduling strategy {strategy!r}")
        return {"type": strategy}
    if hasattr(strategy, "to_spec"):
        return strategy.to_spec()
    raise TypeError(f"bad scheduling strategy: {strategy!r}")
