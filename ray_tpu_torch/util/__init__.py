# Copied from ray_tpu/util/__init__.py (JAX-free): module names read ray_tpu_torch.
"""Utility APIs (reference: python/ray/util/)."""

from .placement_group import (
    PlacementGroup,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from .scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)



def list_named_actors(all_namespaces: bool = False):
    """Names of all live named actors (reference:
    ray.util.list_named_actors). With all_namespaces=True, returns
    [{"name": ..., "namespace": ...}] across every namespace;
    otherwise a flat name list scoped to the session's namespace
    (rt.init(namespace=...), "default" otherwise)."""
    from . import state

    rows = [
        row
        for row in state.list_actors()
        if row.get("name") and row.get("state") != "DEAD"
    ]
    if all_namespaces:
        return [
            {"name": row["name"], "namespace": row.get("namespace")}
            for row in rows
        ]
    mine = state._worker().namespace
    return [
        row["name"]
        for row in rows
        if row.get("namespace", "default") == mine  # rt: noqa[RT006] — wire-compat: rows from old daemons lack the field
    ]


__all__ = [
    "list_named_actors",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
    "PlacementGroup",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
    "get_placement_group",
]
