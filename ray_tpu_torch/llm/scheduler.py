# Copied verbatim from ray_tpu/llm/scheduler.py: the port imports nothing
# of ray_tpu, so it keeps its own copy of this JAX-free module.
"""Slot scheduler for the continuous-batching engine.

Pure bookkeeping — no JAX, no threads — so its invariants are unit-
testable in microseconds (tests/test_llm_engine.py). One scheduler
manages ONE engine's slots (one model family; multiplexed families
each get their own engine and therefore their own scheduler — that is
the per-family slot accounting).

Policy:

* Admission is strict FIFO over the waiting queue. A request is
  admitted the moment a slot is free and it is at the head — a
  long-prompt request can never be starved by short ones arriving
  behind it (its prefill cost is bounded per engine iteration by
  chunking, not by skipping it).
* Slots are a free LIST (LIFO reuse): a freed slot is handed to the
  next admission immediately — eviction of a finished/cancelled
  sequence frees capacity in the SAME engine iteration.
* The waiting queue is bounded (`max_waiting`); past the bound,
  `submit` raises `EngineOverloaded` so the serve layer sheds load
  with an error instead of queueing unboundedly (the router/proxy
  admission story: the proxy 503s on connection floods, the engine
  rejects when its own queue is full).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple


class EngineOverloaded(RuntimeError):
    """The engine's waiting queue is full; retry later."""


class EngineDead(RuntimeError):
    """The engine's step loop died or was shut down; the original
    failure (if any) is the __cause__."""


class SlotScheduler:
    """Slot accounting + FIFO admission for one engine."""

    def __init__(self, n_slots: int, max_waiting: int = 256):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.max_waiting = int(max_waiting)
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self._waiting: Deque[Any] = deque()
        self._running: Dict[int, Any] = {}  # slot -> request

    # -- admission -----------------------------------------------------
    def submit(self, request: Any) -> None:
        if len(self._waiting) >= self.max_waiting:
            raise EngineOverloaded(
                f"engine waiting queue full ({self.max_waiting}); "
                "shed or retry"
            )
        self._waiting.append(request)

    def admit_next(self, gate=None) -> Optional[Tuple[Any, int]]:
        """Pop the FIFO head into a free slot; None when nothing can
        be admitted (no waiters or no free slot). `gate(request) ->
        bool` may veto the head — the paged engine gates on KV-block
        availability — and a vetoed head STAYS the head: admission
        remains strict FIFO (no skip-ahead), so a big request waits
        for blocks instead of being starved by smaller ones."""
        if not self._waiting or not self._free:
            return None
        request = self._waiting[0]
        if gate is not None and not gate(request):
            return None
        slot = self._free.pop()
        self._waiting.popleft()
        self._running[slot] = request
        return request, slot

    # -- release -------------------------------------------------------
    def release(self, slot: int) -> Any:
        """Free a running slot (finish/cancel/error); returns the
        request that held it."""
        request = self._running.pop(slot)
        self._free.append(slot)
        return request

    def remove_waiting(self, request: Any) -> bool:
        """Drop a not-yet-admitted request (cancellation while
        queued)."""
        try:
            self._waiting.remove(request)
            return True
        except ValueError:
            return False

    def drain(self) -> List[Any]:
        """Remove every request (shutdown/death); returns them all."""
        doomed = list(self._waiting) + list(self._running.values())
        self._waiting.clear()
        for slot in list(self._running):
            self.release(slot)
        return doomed

    # -- views ---------------------------------------------------------
    @property
    def running(self) -> Dict[int, Any]:
        return self._running

    @property
    def waiting(self) -> Deque[Any]:
        return self._waiting

    def stats(self) -> Dict[str, int]:
        return {
            "slots_total": self.n_slots,
            "slots_used": len(self._running),
            "waiting": len(self._waiting),
        }
