# Copied from ray_tpu/util/collective.py (JAX-free): module names read ray_tpu_torch.
"""Actor/task-level collective API.

Reference: python/ray/util/collective/collective.py:258-615 —
declared groups of actors run allreduce/allgather/reducescatter/
broadcast/send/recv/barrier over NCCL/GLOO backends.

TPU-native split (SURVEY.md §5.8): DENSE tensor collectives belong
inside the jitted program — ray_tpu_torch.parallel.collective compiles them
to XLA ICI ops (psum/all_gather/ppermute), which is the NCCL
replacement and the fast path. THIS module is the control-plane
equivalent of the reference API for coordinating *processes*:
rendezvous + numpy reductions through the object store (the GLOO
role). Use it for gang bootstrap, small-state sync, and barriers —
not for gradients.

Implementation: a named rendezvous actor per group; rank 0 reduces
and publishes, other ranks exchange via the store.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

_GROUP_NAMESPACE = "_rt_collective"


class _Rendezvous:
    """Actor body: barrier + gather/publish per (group, op, seq); each
    round completes when its declared participant set has put."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._lock = threading.Lock()
        self._rounds: Dict[tuple, dict] = {}

    def put(self, op: str, seq: int, rank: int, value, expected=None):
        key = (op, seq)
        with self._lock:
            entry = self._rounds.setdefault(
                key,
                {
                    "values": {},
                    "expected": expected
                    or list(range(self.world_size)),
                },
            )
            entry["values"][rank] = value
        return True

    def ready(self, op: str, seq: int) -> bool:
        return self.gather(op, seq) is not None

    def gather(self, op: str, seq: int):
        with self._lock:
            entry = self._rounds.get((op, seq))
            if entry is None:
                return None
            expected = entry["expected"]
            if any(r not in entry["values"] for r in expected):
                return None
            # Dense list indexed by rank; non-participants hold None.
            out = [None] * self.world_size
            for rank in expected:
                out[rank] = entry["values"][rank]
            return out

    def clear(self, op: str, seq: int):
        with self._lock:
            self._rounds.pop((op, seq), None)
        return True


class CollectiveGroup:
    """One rank's handle (picklable: name + rank + size)."""

    def __init__(self, name: str, rank: int, world_size: int):
        self.name = name
        self.rank = rank
        self.world_size = world_size
        # Per-op sequence counters: ops with different participant
        # sets (p2p vs group-wide) must not share one counter, or a
        # p2p pair desyncs everyone else's round numbering.
        self._seq: Dict[str, int] = {}

    def _actor(self):
        import ray_tpu_torch as rt

        return rt.get_actor(
            f"collective:{self.name}", namespace=_GROUP_NAMESPACE
        )

    def _exchange(
        self,
        op: str,
        value,
        timeout: float,
        participants: Optional[List[int]] = None,
    ):
        """One rendezvous round. `participants` defaults to the whole
        group; p2p rounds pass the two endpoints."""
        import ray_tpu_torch as rt

        actor = self._actor()
        seq = self._seq.get(op, 0)
        self._seq[op] = seq + 1
        expected = (
            sorted(participants)
            if participants is not None
            else list(range(self.world_size))
        )
        rt.get(
            actor.put.remote(op, seq, self.rank, value, expected),
            timeout=timeout,
        )
        deadline = time.time() + timeout
        while True:
            values = rt.get(
                actor.gather.remote(op, seq), timeout=timeout
            )
            if values is not None:
                if self.rank == expected[0]:
                    # Best-effort cleanup of the previous round once
                    # this one (which all participants reached) formed.
                    actor.clear.remote(op, seq - 1)
                return values
            if time.time() > deadline:
                raise TimeoutError(
                    f"collective {op} timed out in group "
                    f"{self.name!r} (rank {self.rank})"
                )
            time.sleep(0.005)

    # -- API (reference: collective.py allreduce:258 etc.) -----------
    def barrier(self, timeout: float = 60.0) -> None:
        self._exchange("barrier", None, timeout)

    def allreduce(
        self, tensor, op: str = "sum", timeout: float = 60.0
    ):
        values = self._exchange("allreduce", np.asarray(tensor), timeout)
        stack = np.stack(values)
        if op == "sum":
            return stack.sum(axis=0)
        if op == "mean":
            return stack.mean(axis=0)
        if op == "max":
            return stack.max(axis=0)
        if op == "min":
            return stack.min(axis=0)
        raise ValueError(f"unknown reduce op {op!r}")

    def allgather(self, tensor, timeout: float = 60.0) -> List:
        return self._exchange("allgather", np.asarray(tensor), timeout)

    def broadcast(
        self, tensor=None, src_rank: int = 0, timeout: float = 60.0
    ):
        values = self._exchange(
            "broadcast",
            np.asarray(tensor) if self.rank == src_rank else None,
            timeout,
        )
        return values[src_rank]

    def reducescatter(
        self, tensor, op: str = "sum", timeout: float = 60.0
    ):
        reduced = self.allreduce(tensor, op, timeout)
        shards = np.array_split(reduced, self.world_size)
        return shards[self.rank]

    def send(self, tensor, dst_rank: int, timeout: float = 60.0):
        self._exchange(
            f"p2p:{self.rank}->{dst_rank}",
            np.asarray(tensor),
            timeout,
            participants=[self.rank, dst_rank],
        )

    def recv(self, src_rank: int, timeout: float = 60.0):
        values = self._exchange(
            f"p2p:{src_rank}->{self.rank}",
            None,
            timeout,
            participants=[src_rank, self.rank],
        )
        return values[src_rank]


def init_collective_group(
    world_size: int,
    rank: int,
    group_name: str = "default",
) -> CollectiveGroup:
    """Join (rank 0 creates) a named collective group (reference:
    collective.init_collective_group)."""
    import ray_tpu_torch as rt

    actor_name = f"collective:{group_name}"
    if rank == 0:
        actor_cls = rt.remote(
            num_cpus=0, name=actor_name, namespace=_GROUP_NAMESPACE
        )(_Rendezvous)
        actor = actor_cls.remote(world_size)
        rt.get(actor.ready.remote("init", 0), timeout=60)
    else:
        deadline = time.time() + 60
        while True:
            try:
                rt.get_actor(actor_name, namespace=_GROUP_NAMESPACE)
                break
            except ValueError:
                if time.time() > deadline:
                    raise
                time.sleep(0.02)
    return CollectiveGroup(group_name, rank, world_size)


def destroy_collective_group(group_name: str = "default") -> None:
    import ray_tpu_torch as rt

    try:
        actor = rt.get_actor(
            f"collective:{group_name}", namespace=_GROUP_NAMESPACE
        )
        rt.kill(actor)
    except ValueError:
        pass
