# Copied from ray_tpu/_private/scheduler.py (JAX-free): module names read ray_tpu_torch.
"""Resource accounting and local task scheduling.

Models the reference's two-level scheduler (reference:
src/ray/raylet/scheduling/cluster_task_manager.cc:44 picks a node;
local_task_manager.cc:122 dispatches to leased workers against
per-node resource instances; fixed-point resource arithmetic in
src/ray/common/scheduling/fixed_point.h).

`ResourceSet` uses integer milli-units (the reference's FixedPoint uses
1/10000 units) so fractional resources like `num_cpus=0.5` are exact.
`LocalScheduler` keeps a FIFO-with-skips queue: a task is dispatchable
when its resources fit and its argument objects are local (the
reference's DependencyManager gate, raylet/dependency_manager.h).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

MILLI = 1000


class ResourceSet:
    """Fixed-point (milli-unit) resource vector keyed by name."""

    __slots__ = ("_amounts",)

    def __init__(self, amounts: Optional[Dict[str, float]] = None):
        self._amounts: Dict[str, int] = {}
        for name, value in (amounts or {}).items():
            milli = int(round(value * MILLI))
            if milli != 0:
                self._amounts[name] = milli

    @classmethod
    def _from_milli(cls, amounts: Dict[str, int]) -> "ResourceSet":
        rs = cls()
        rs._amounts = {k: v for k, v in amounts.items() if v != 0}
        return rs

    def fits_in(self, other: "ResourceSet") -> bool:
        return all(
            other._amounts.get(name, 0) >= milli
            for name, milli in self._amounts.items()
        )

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for name, milli in other._amounts.items():
            out[name] = out.get(name, 0) - milli
        return ResourceSet._from_milli(out)

    def add(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for name, milli in other._amounts.items():
            out[name] = out.get(name, 0) + milli
        return ResourceSet._from_milli(out)

    def get(self, name: str) -> float:
        return self._amounts.get(name, 0) / MILLI

    def to_dict(self) -> Dict[str, float]:
        return {k: v / MILLI for k, v in self._amounts.items()}

    def is_empty(self) -> bool:
        return not self._amounts

    def __repr__(self) -> str:
        return f"ResourceSet({self.to_dict()})"


class LocalScheduler:
    """Single-node resource pool + pending-task queue.

    Dispatch is driven by `maybe_dispatch`, called whenever capacity or
    dependency state changes; the provided callbacks decide worker
    availability (reference: LocalTaskManager::
    DispatchScheduledTasksToWorkers).
    """

    def __init__(self, total: ResourceSet):
        self._total = total
        self._available = total
        self._lock = threading.RLock()
        # task_id -> (ResourceSet, spec); insertion-ordered for FIFO.
        self._queue: "OrderedDict" = OrderedDict()
        self._running: Dict[object, ResourceSet] = {}

    # ---- capacity ----
    def total(self) -> ResourceSet:
        return self._total

    def available(self) -> ResourceSet:
        with self._lock:
            return self._available

    def add_capacity(self, extra: ResourceSet) -> None:
        with self._lock:
            self._total = self._total.add(extra)
            self._available = self._available.add(extra)

    def remove_capacity(self, extra: ResourceSet) -> None:
        with self._lock:
            self._total = self._total.subtract(extra)
            self._available = self._available.subtract(extra)

    def try_reserve(self, request: ResourceSet) -> bool:
        """Atomically carve `request` out of this node's pool (both
        total and available) — the placement-group bundle prepare step
        (reference: raylet/placement_group_resource_manager.h 2PC).
        Fails if the resources are not currently free."""
        with self._lock:
            if not request.fits_in(self._available):
                return False
            self._total = self._total.subtract(request)
            self._available = self._available.subtract(request)
            return True

    # ---- queueing ----
    def enqueue(self, task_id, request: ResourceSet, spec) -> None:
        with self._lock:
            self._queue[task_id] = (request, spec)

    def cancel(self, task_id) -> bool:
        with self._lock:
            return self._queue.pop(task_id, None) is not None

    def drain_queued(self, predicate) -> list:
        """Remove and return the specs of queued tasks matching
        `predicate(spec)` (used to fail tasks stranded by a removed
        placement group's resources)."""
        drained = []
        with self._lock:
            for task_id in list(self._queue):
                _, spec = self._queue[task_id]
                if predicate(spec):
                    del self._queue[task_id]
                    drained.append(spec)
        return drained

    def queued_count(self) -> int:
        with self._lock:
            return len(self._queue)

    def count_queued(self, predicate) -> int:
        """Number of queued tasks whose spec matches `predicate`."""
        with self._lock:
            return sum(
                1
                for _req, spec in self._queue.values()
                if predicate(spec)
            )

    def maybe_dispatch(
        self,
        deps_ready: Callable[[object], bool],
        try_dispatch: Callable[[object, object], bool],
    ) -> int:
        """Dispatch every queued task that fits and whose deps are local.

        `try_dispatch(task_id, spec)` must return True if a worker
        accepted the task; resources stay acquired until
        `release(task_id)`. Returns number of tasks dispatched.
        """
        dispatched = 0
        while True:
            candidate = None
            with self._lock:
                for task_id, (request, spec) in self._queue.items():
                    if not request.fits_in(self._available):
                        continue
                    if not deps_ready(spec):
                        continue
                    candidate = (task_id, request, spec)
                    break
                if candidate is None:
                    return dispatched
                task_id, request, spec = candidate
                del self._queue[task_id]
                self._available = self._available.subtract(request)
                self._running[task_id] = request
            if not try_dispatch(task_id, spec):
                # No worker available: requeue at the front and stop.
                with self._lock:
                    self._available = self._available.add(request)
                    del self._running[task_id]
                    self._queue[task_id] = (request, spec)
                    self._queue.move_to_end(task_id, last=False)
                return dispatched
            dispatched += 1

    def release(self, task_id) -> None:
        with self._lock:
            request = self._running.pop(task_id, None)
            if request is not None:
                self._available = self._available.add(request)
