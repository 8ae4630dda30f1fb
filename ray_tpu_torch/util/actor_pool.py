# Copied from ray_tpu/util/actor_pool.py (JAX-free): module names read ray_tpu_torch.
"""ActorPool (reference: python/ray/util/actor_pool.py — submit work
to a fixed pool of actors, collecting results in or out of order)."""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        import ray_tpu_torch as rt

        self._rt = rt
        self._idle = deque(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_submit = 0
        self._next_return = 0
        self._pending = deque()  # (fn, value) waiting for an actor

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef."""
        if self._idle:
            actor = self._idle.popleft()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_submit] = ref
            self._next_submit += 1
        else:
            self._pending.append((fn, value))

    def _drain_pending(self) -> None:
        while self._pending and self._idle:
            fn, value = self._pending.popleft()
            self.submit(fn, value)

    def has_next(self) -> bool:
        # Outstanding futures are the truth — index bookkeeping can't
        # be trusted after unordered consumption.
        return bool(self._future_to_actor) or bool(self._pending)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in submission order.

        The actor is returned to the idle pool *before* the result is
        fetched (reference: python/ray/util/actor_pool.py:304) so that a
        task exception does not shrink the pool; a timeout while waiting
        leaves the pool state intact so the call can be retried.
        """
        if not self.has_next():
            raise StopIteration("no pending results")
        if self._next_return not in self._index_to_future:
            raise ValueError(
                "next ordered result was already consumed unordered"
            )
        ref = self._index_to_future[self._next_return]
        ready, _ = self._rt.wait([ref], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("next ordered result not ready in time")
        del self._index_to_future[self._next_return]
        self._next_return += 1
        self._idle.append(self._future_to_actor.pop(ref))
        self._drain_pending()
        return self._rt.get(ref)

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Whichever pending result finishes first.

        Like get_next, the actor goes idle before the (possibly raising)
        get, so failed tasks don't permanently remove actors.
        """
        if not self.has_next():
            raise StopIteration("no pending results")
        refs = list(self._future_to_actor)
        ready, _ = self._rt.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result ready in time")
        ref = ready[0]
        for index, future in list(self._index_to_future.items()):
            if future is ref:
                del self._index_to_future[index]
                break
        self._idle.append(self._future_to_actor.pop(ref))
        self._drain_pending()
        return self._rt.get(ref)

    def map(self, fn: Callable, values: Iterable[Any]):
        for value in values:
            self.submit(fn, value)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for value in values:
            self.submit(fn, value)
        while self.has_next():
            yield self.get_next_unordered()
