# Copied from ray_tpu/util/queue.py (JAX-free): module names read ray_tpu_torch.
"""Distributed queue (reference: python/ray/util/queue.py — a Queue
backed by an actor, usable from any worker)."""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items = deque()

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def get(self):
        if not self.items:
            return (False, None)
        return (True, self.items.popleft())

    def qsize(self) -> int:
        return len(self.items)


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: dict = None):
        import ray_tpu_torch as rt

        self._rt = rt
        actor_cls = rt.remote(**(actor_options or {"num_cpus": 0}))(
            _QueueActor
        )
        self._actor = actor_cls.remote(maxsize)

    def put(
        self,
        item: Any,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> None:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if self._rt.get(self._actor.put.remote(item), timeout=30):
                return
            if not block:
                raise Full()
            if deadline is not None and time.time() > deadline:
                raise Full()
            time.sleep(0.01)

    def get(
        self, block: bool = True, timeout: Optional[float] = None
    ) -> Any:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            ok, item = self._rt.get(
                self._actor.get.remote(), timeout=30
            )
            if ok:
                return item
            if not block:
                raise Empty()
            if deadline is not None and time.time() > deadline:
                raise Empty()
            time.sleep(0.01)

    def qsize(self) -> int:
        return self._rt.get(self._actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return self.qsize() == 0

    def shutdown(self) -> None:
        try:
            self._rt.kill(self._actor)
        except Exception:
            pass

    def __reduce__(self):
        clone = object.__new__(Queue)
        return (_rebuild_queue, (self._actor,))


def _rebuild_queue(actor):
    import ray_tpu_torch as rt

    queue = object.__new__(Queue)
    queue._rt = rt
    queue._actor = actor
    return queue
