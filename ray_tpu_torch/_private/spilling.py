# Copied from ray_tpu/_private/spilling.py (JAX-free): module names read ray_tpu_torch.
"""Object spilling: overflow sealed objects from the shared-memory
store to session-local files and restore them on demand.

Reference behavior matched: the raylet's LocalObjectManager spills
under store pressure and restores on get (reference:
src/ray/raylet/local_object_manager.h:41,110 SpillObjectsOfSize /
AsyncRestoreSpilledObject) over a filesystem external storage
(reference: python/ray/_private/external_storage.py:72
FileSystemStorage — one directory of spill files keyed by object id).

TPU-first simplifications: one file per object (no multi-object
fusing — the kernel page cache already amortizes small reads, and the
store inlines sub-100KB objects anyway so spilled objects are large),
synchronous writes on the daemon's spill thread, and restore-by-read
into the same store the object left.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .ids import ObjectID


class FileSpillStorage:
    """Filesystem-backed external storage for spilled objects."""

    def __init__(self, spill_dir: str):
        self._dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._sizes: dict[ObjectID, int] = {}
        self._total = 0

    def _path(self, oid: ObjectID) -> str:
        return os.path.join(self._dir, oid.hex())

    def spill(self, oid: ObjectID, view) -> int:
        """Write one sealed object's bytes to its spill file.

        Idempotent: re-spilling an already-spilled object is a no-op
        (the immutable-object invariant means the bytes cannot have
        changed), which makes repeated pressure cycles cheap.
        """
        with self._lock:
            if oid in self._sizes:
                return self._sizes[oid]
        path = self._path(oid)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(view)
        os.replace(tmp, path)  # atomic: readers never see partial files
        size = len(view)
        with self._lock:
            if oid not in self._sizes:
                self._sizes[oid] = size
                self._total += size
        return size

    def contains(self, oid: ObjectID) -> bool:
        # The disk probe runs under the lock so a concurrent delete()
        # (pop + unlink, also under the lock) can't interleave between
        # the exists check and the size read and resurrect a stale
        # entry.
        with self._lock:
            if oid in self._sizes:
                return True
            # A restarted daemon over the same session dir can still
            # serve files spilled by its predecessor.
            try:
                size = os.path.getsize(self._path(oid))
            except OSError:
                return False
            self._sizes[oid] = size
            self._total += size
            return True

    def size(self, oid: ObjectID) -> Optional[int]:
        with self._lock:
            return self._sizes.get(oid)

    def read(
        self, oid: ObjectID, offset: int = 0, length: Optional[int] = None
    ) -> Optional[bytes]:
        try:
            with open(self._path(oid), "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read() if length is None else f.read(length)
        except FileNotFoundError:
            return None

    def delete(self, oid: ObjectID) -> None:
        with self._lock:
            size = self._sizes.pop(oid, None)
            if size is not None:
                self._total -= size
            try:
                os.unlink(self._path(oid))
            except FileNotFoundError:
                pass

    def stats(self) -> dict:
        with self._lock:
            return {
                "spilled_objects": len(self._sizes),
                "spilled_bytes": self._total,
            }

    def shutdown(self) -> None:
        with self._lock:
            oids = list(self._sizes)
        for oid in oids:
            self.delete(oid)
        try:
            os.rmdir(self._dir)
        except OSError:
            pass
