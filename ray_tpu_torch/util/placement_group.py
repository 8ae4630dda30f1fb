# Copied from ray_tpu/util/placement_group.py (JAX-free): module names read ray_tpu_torch.
"""Placement-group public API.

Reference: python/ray/util/placement_group.py — placement_group():145
creates a group with PACK/SPREAD/STRICT_PACK/STRICT_SPREAD strategies
(:162-164); PlacementGroup.ready() returns an ObjectRef gated on the
group's bundle-marker resource; remove_placement_group() tears the
group down and releases bundle resources.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .. import exceptions as exc
from .._private.ids import PlacementGroupID
from .._private.placement_groups import STRATEGIES, rewrite_request


def _worker():
    from .._private.worker import global_worker

    worker = global_worker()
    if worker is None:
        raise exc.RayTpuError("ray_tpu_torch.init() has not been called")
    return worker


class PlacementGroup:
    """Handle to a (possibly still-creating) placement group."""

    def __init__(self, pg_id: PlacementGroupID, bundles: List[dict]):
        self._pg_id = pg_id
        self._bundles = list(bundles)

    @property
    def id(self) -> str:
        return self._pg_id.hex()

    @property
    def bundle_specs(self) -> List[dict]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self):
        """ObjectRef that resolves once every bundle is committed.

        Implemented the reference's way: a no-op task whose resource
        request is the group's bundle-marker resource, so it can only
        schedule after commit (reference: placement_group.py ready()
        via bundle_reservation_check_func)."""
        from ..remote_function import RemoteFunction

        marker = rewrite_request({}, self.id, -1)

        def _bundle_reservation_check():
            return True

        rf = RemoteFunction(
            _bundle_reservation_check,
            {"num_cpus": 0, "resources": marker, "_skip_pg_rewrite": True},
        )
        return rf.remote()

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until the group is created (True) or timeout."""
        deadline = time.time() + timeout_seconds
        while True:
            if self.state() == "CREATED":
                return True
            if time.time() >= deadline:
                return False
            time.sleep(0.02)

    def state(self) -> Optional[str]:
        reply = _worker().call(
            "placement_group_state", pg_id=self._pg_id.binary()
        )
        return reply.get("state")

    def __reduce__(self):
        return (PlacementGroup, (self._pg_id, self._bundles))

    def __repr__(self):
        return f"PlacementGroup({self.id[:12]}, {len(self._bundles)} bundles)"


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
) -> PlacementGroup:
    """Asynchronously create a placement group; use `.wait()` or
    `.ready()` to block on creation."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"strategy must be one of {STRATEGIES}, got {strategy!r}"
        )
    if not bundles or not all(
        isinstance(b, dict) and b and all(v > 0 for v in b.values())
        for b in bundles
    ):
        raise ValueError(
            "bundles must be a non-empty list of non-empty "
            "{resource: amount>0} dicts"
        )
    pg_id = PlacementGroupID.from_random()
    clean = [{k: float(v) for k, v in b.items()} for b in bundles]
    reply = _worker().call(
        "create_placement_group",
        pg_id=pg_id.binary(),
        bundles=clean,
        strategy=strategy,
        name=name,
    )
    if reply.get("error"):
        raise ValueError(reply["error"])
    return PlacementGroup(pg_id, clean)


def remove_placement_group(pg: PlacementGroup) -> None:
    _worker().call(
        "remove_placement_group", pg_id=pg._pg_id.binary()
    )


def placement_group_table() -> List[dict]:
    return _worker().call("placement_group_table")["table"]


def get_placement_group(name: str) -> PlacementGroup:
    for entry in placement_group_table():
        if entry["name"] == name and entry["state"] != "REMOVED":
            return PlacementGroup(
                PlacementGroupID(bytes.fromhex(entry["placement_group_id"])),
                entry["bundles"],
            )
    raise ValueError(f"placement group {name!r} not found")
