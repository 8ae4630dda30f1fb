# Copied from ray_tpu/_private/ids.py (JAX-free): module names read ray_tpu_torch.
"""Typed binary identifiers for the runtime.

Design follows the reference's ID specification (reference:
src/ray/common/id.h, src/ray/design_docs/id_specification.md): every
entity in the system gets a fixed-width binary ID; ObjectIDs embed the
ID of the task that created them plus a return-index so ownership and
lineage can be derived without a directory lookup.

Unlike the reference (C++ templates + 28-byte ObjectIDs), we keep a
small pure-Python implementation: IDs are immutable bytes wrappers with
cheap hashing, hex round-tripping, and deterministic derivation.
"""

from __future__ import annotations

import hashlib
import os
import struct

__all__ = [
    "BaseID",
    "JobID",
    "TaskID",
    "ActorID",
    "ObjectID",
    "NodeID",
    "WorkerID",
    "PlacementGroupID",
    "ClusterID",
]


class BaseID:
    """Immutable fixed-size binary identifier."""

    SIZE = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, "
                f"got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash((type(self).__name__, self._bytes))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.hex()})"

    # Pickle support (slots-based).
    def __getstate__(self):
        return self._bytes

    def __setstate__(self, state):
        self._bytes = state
        self._hash = hash((type(self).__name__, self._bytes))


class ClusterID(BaseID):
    SIZE = 16


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class JobID(BaseID):
    """4-byte job id (reference: src/ray/common/id.h JobID::Size() == 4)."""

    SIZE = 4

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack(">I", value))

    def int_value(self) -> int:
        return struct.unpack(">I", self._bytes)[0]


class ActorID(BaseID):
    """12-byte actor id: 8 random bytes + 4-byte job id suffix."""

    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(8) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[8:])


class TaskID(BaseID):
    """16-byte task id derived from (parent task, submission index).

    The derivation is deterministic so retries of the same submission
    produce the same TaskID, which is what makes lineage-based object
    reconstruction possible (reference: src/ray/common/id.h
    TaskID::ForNormalTask).
    """

    SIZE = 16

    #: (job_bytes, parent_bytes) -> prefix-fed hasher. A submit loop
    #: derives every task id from the SAME (job, parent) pair, so the
    #: prefix hash is computed once and copy()d per task — about half
    #: the sha256 cost on the 20k/s submit path. Bounded: one entry
    #: per submitting (job, parent) pair, pruned at 256.
    _prefix_cache: dict = {}

    @classmethod
    def for_task(
        cls, job_id: JobID, parent: "TaskID", submit_index: int
    ) -> "TaskID":
        key = (job_id._bytes, parent._bytes)
        base = cls._prefix_cache.get(key)
        if base is None:
            if len(cls._prefix_cache) >= 256:
                cls._prefix_cache.clear()
            base = hashlib.sha256(key[0] + key[1])
            cls._prefix_cache[key] = base
        h = base.copy()
        h.update(struct.pack(">Q", submit_index))
        return cls(h.digest()[: cls.SIZE])

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        h = hashlib.sha256()
        h.update(b"actor_creation")
        h.update(actor_id.binary())
        return cls(h.digest()[: cls.SIZE])

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        h = hashlib.sha256()
        h.update(b"driver")
        h.update(job_id.binary())
        return cls(h.digest()[: cls.SIZE])


class ObjectID(BaseID):
    """20-byte object id = 16-byte creating TaskID + 4-byte index.

    Index 0 is reserved for `put` objects counter space; task returns
    use indices starting at 1 (reference: src/ray/common/id.h
    ObjectID::FromIndex).
    """

    SIZE = 20

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index to avoid colliding
        # with return-object indices.
        return cls(task_id.binary() + struct.pack(">I", 0x80000000 | put_index))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:16])

    def index(self) -> int:
        return struct.unpack(">I", self._bytes[16:])[0]


class PlacementGroupID(BaseID):
    SIZE = 16
