# Copied from ray_tpu/autoscaler/v2/instance_manager.py (JAX-free): module names read ray_tpu_torch.
"""Versioned instance store + subscriber fan-out.

Reference: python/ray/autoscaler/v2/instance_manager/
{instance_storage.py, instance_manager.py} — the instance table is
updated only through versioned batches (optimistic concurrency: an
update carries the version it was computed against and is rejected if
the table moved), and every applied status change is fanned out to
subscribers (CloudInstanceUpdater launches/terminates on the provider,
RayStopper drains nodes) so side effects happen exactly once per
transition.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .instance import Instance, InstanceStatus


@dataclass
class InstanceUpdateEvent:
    """One requested mutation of the instance table."""

    instance_id: Optional[str] = None  # None => new instance
    new_status: Optional[InstanceStatus] = None
    instance_type: Optional[str] = None  # for new instances
    cloud_instance_id: Optional[str] = None
    node_ids: Optional[List[str]] = None
    details: str = ""
    #: Extra payload subscribers may need (e.g. per-host resources for
    #: a launch).
    metadata: dict = field(default_factory=dict)


class InstanceManager:
    """The only writer of the instance table."""

    def __init__(self):
        self._lock = threading.RLock()
        self._instances: Dict[str, Instance] = {}
        self._version = 0
        self._subscribers: List[
            Callable[[Instance, InstanceUpdateEvent], None]
        ] = []

    # -- read ----------------------------------------------------------
    def get_state(self) -> tuple:
        """(version, {instance_id: Instance}) snapshot. Instances are
        the live objects; callers must not mutate them directly."""
        with self._lock:
            return self._version, dict(self._instances)

    def instances(self) -> List[Instance]:
        with self._lock:
            return list(self._instances.values())

    # -- write ---------------------------------------------------------
    def subscribe(
        self, fn: Callable[[Instance, InstanceUpdateEvent], None]
    ) -> None:
        self._subscribers.append(fn)

    def update(
        self,
        updates: List[InstanceUpdateEvent],
        expected_version: Optional[int] = None,
    ) -> bool:
        """Apply a batch. Returns False (nothing applied) when
        expected_version no longer matches — the caller recomputes
        against fresh state, exactly like the reference's
        UpdateInstanceManagerState version check."""
        applied: List[tuple] = []
        with self._lock:
            if (
                expected_version is not None
                and expected_version != self._version
            ):
                return False
            for ev in updates:
                if ev.instance_id is None:
                    inst = Instance(instance_type=ev.instance_type)
                    self._instances[inst.instance_id] = inst
                    applied.append((inst, ev))
                    continue
                inst = self._instances.get(ev.instance_id)
                if inst is None:
                    continue
                if ev.cloud_instance_id is not None:
                    inst.cloud_instance_id = ev.cloud_instance_id
                if ev.node_ids is not None:
                    inst.node_ids = list(ev.node_ids)
                if ev.new_status is not None:
                    if not inst.transition(ev.new_status, ev.details):
                        continue  # invalid edge: drop, don't corrupt
                applied.append((inst, ev))
            if applied:
                self._version += 1
        # Side effects outside the lock: a subscriber may call back
        # into update() (e.g. instant-allocation providers).
        for inst, ev in applied:
            for fn in self._subscribers:
                fn(inst, ev)
        return True

    def summary(self) -> List[dict]:
        with self._lock:
            return [i.summary() for i in self._instances.values()]
