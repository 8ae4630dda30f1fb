# Copied from ray_tpu/_private/object_store.py (JAX-free): module names read ray_tpu_torch.
"""Node-local object stores.

Two tiers, mirroring the reference's split between the in-process
memory store for small objects and the plasma shared-memory store for
large ones (reference: src/ray/core_worker/store_provider/,
src/ray/object_manager/plasma/store.h):

* Small objects (≤ max_direct_call_object_size) are inlined into task
  specs/replies and live in the node daemon's object table (the
  in-process memory-store tier of the reference).

* `SharedMemoryStore` — immutable shared-memory objects, one POSIX SHM
  segment per object, readable zero-copy by every process on the node.
  Plasma's mmap-arena + dlmalloc design (plasma/dlmalloc.cc) is an
  allocation optimization we trade away for per-object segments, which
  the kernel already refcounts; create/seal/get/delete and LRU eviction
  semantics are preserved (plasma/object_lifecycle_manager.h,
  eviction_policy.h).

Both stores hand out `memoryview`s so deserialization is zero-copy all
the way into numpy / `jax.numpy.asarray`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from multiprocessing import shared_memory, resource_tracker
from typing import Dict, Optional

from .ids import ObjectID


class ObjectStoreFullError(Exception):
    pass


class ObjectNotSealedError(Exception):
    pass


def _close_shm(shm: shared_memory.SharedMemory) -> None:
    """Close a segment, tolerating live zero-copy views.

    numpy/jax arrays deserialized from the store keep memoryview
    exports into the mapping; releasing then raises BufferError. The
    segment is already unlinked by callers, so we drop our handles and
    let the pages die with the last view (avoids "Exception ignored in
    __del__" noise at interpreter exit).
    """
    try:
        shm.close()
    except BufferError:
        shm._buf = None  # noqa: SLF001 — disarm SharedMemory.__del__
        shm._mmap = None  # noqa: SLF001
        fd = getattr(shm, "_fd", -1)
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass
            shm._fd = -1  # noqa: SLF001


def _unregister(shm: shared_memory.SharedMemory) -> None:
    # Python's resource_tracker unlinks SHM segments when *any* process
    # that attached exits, which would tear objects out from under
    # other readers. The store owns lifetime explicitly, so opt out.
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:
        pass


@dataclass
class _Entry:
    shm: shared_memory.SharedMemory
    size: int
    sealed: bool
    created_at: float
    pinned: int = 0  # pin count: primary copies pinned by the node
                     # daemon are never evicted (reference:
                     # raylet/local_object_manager.h primary pinning)


class SharedMemoryStore:
    """Create/seal/get over per-object shared-memory segments.

    The process that calls `create` writes into the returned buffer and
    then calls `seal`; readers in any process call `get`/`open` and map
    the same pages. Objects are immutable after seal.
    """

    def __init__(
        self,
        node_id_hex: str,
        capacity: int,
        on_evict=None,
        evict_enabled: bool = True,
    ):
        self._prefix = f"rt_{node_id_hex[:8]}_"
        self._capacity = capacity
        self._used = 0
        self._entries: "OrderedDict[ObjectID, _Entry]" = OrderedDict()
        self._lock = threading.RLock()
        self._seal_events: Dict[ObjectID, threading.Event] = {}
        # Called with each evicted ObjectID so the owning daemon can fix
        # its object table / tell the control plane a copy is gone.
        self._on_evict = on_evict
        # Worker/driver instances must NOT evict: bookkeeping is
        # per-process, so a client-side LRU pass could destroy a
        # primary copy the daemon believes is pinned. Clients raise
        # ObjectStoreFullError instead; the daemon spills, and the
        # client reclaims accounting for the vanished segments via
        # _sweep_unlinked.
        self._evict_enabled = evict_enabled

    # -- producer side ---------------------------------------------------
    def create(self, object_id: ObjectID, size: int) -> memoryview:
        size = max(size, 1)
        with self._lock:
            if object_id in self._entries:
                raise ValueError(f"Object {object_id} already exists")
            if self._used + size > self._capacity:
                self._sweep_unlinked()
            if self._used + size > self._capacity and self._evict_enabled:
                self._evict(self._used + size - self._capacity)
            if self._used + size > self._capacity:
                raise ObjectStoreFullError(
                    f"need {size} bytes, store has "
                    f"{self._capacity - self._used} free of {self._capacity}"
                )
            shm = shared_memory.SharedMemory(
                name=self._name(object_id), create=True, size=size
            )
            _unregister(shm)
            self._entries[object_id] = _Entry(
                shm=shm, size=size, sealed=False, created_at=time.time()
            )
            self._used += size
            return shm.buf[:size]

    def seal(self, object_id: ObjectID) -> None:
        with self._lock:
            entry = self._entries[object_id]
            entry.sealed = True
            event = self._seal_events.pop(object_id, None)
        if event is not None:
            event.set()

    def put(self, object_id: ObjectID, data: bytes | memoryview) -> None:
        buf = self.create(object_id, len(data))
        buf[: len(data)] = data
        self.seal(object_id)

    # -- consumer side ---------------------------------------------------
    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(object_id)
            return e is not None and e.sealed

    def get(
        self, object_id: ObjectID, timeout: Optional[float] = None
    ) -> Optional[memoryview]:
        """Return a zero-copy view of a sealed object, waiting if needed."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and entry.sealed:
                self._entries.move_to_end(object_id)  # LRU touch
                return entry.shm.buf[: entry.size]
            event = self._seal_events.setdefault(object_id, threading.Event())
        while True:
            remaining = None if deadline is None else deadline - time.time()
            if remaining is not None and remaining <= 0:
                return None
            if event.wait(timeout=remaining if remaining else 0.05):
                break
            with self._lock:
                entry = self._entries.get(object_id)
                if entry is not None and entry.sealed:
                    break
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed:
                return None
            return entry.shm.buf[: entry.size]

    def open_remote(self, object_id: ObjectID, size: int) -> memoryview:
        """Attach to a segment created by another process on this node."""
        shm = shared_memory.SharedMemory(name=self._name(object_id))
        _unregister(shm)
        with self._lock:
            if object_id not in self._entries:
                self._entries[object_id] = _Entry(
                    shm=shm, size=size, sealed=True, created_at=time.time()
                )
                # Attached segments count against capacity the same as
                # created ones — delete()/evict subtract them later.
                self._used += size
        return shm.buf[:size]

    # -- lifetime --------------------------------------------------------
    def pin(self, object_id: ObjectID) -> None:
        with self._lock:
            if object_id in self._entries:
                self._entries[object_id].pinned += 1

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            if object_id in self._entries:
                self._entries[object_id].pinned = max(
                    0, self._entries[object_id].pinned - 1
                )

    def unlink_by_id(self, object_id: ObjectID) -> None:
        """Unlink a segment this process never attached (the daemon
        owns lifetime but clients create segments directly)."""
        with self._lock:
            if object_id in self._entries:
                pass  # fall through to normal delete below
            else:
                try:
                    shm = shared_memory.SharedMemory(
                        name=self._name(object_id)
                    )
                    _unregister(shm)
                    shm.unlink()
                    shm.close()
                except FileNotFoundError:
                    pass
                return
        self.delete(object_id, unlink=True)

    def delete(self, object_id: ObjectID, unlink: bool = True) -> None:
        with self._lock:
            entry = self._entries.pop(object_id, None)
            if entry is not None:
                self._used -= entry.size
        if entry is not None:
            if unlink:
                try:
                    entry.shm.unlink()
                except FileNotFoundError:
                    pass
            _close_shm(entry.shm)

    def size_info(self) -> dict:
        with self._lock:
            return {
                "capacity": self._capacity,
                "used": self._used,
                "num_objects": len(self._entries),
            }

    def _evict(self, bytes_needed: int) -> None:
        """LRU eviction of unpinned sealed objects (caller holds lock)."""
        freed = 0
        victims = [
            oid
            for oid, e in self._entries.items()
            if e.sealed and e.pinned == 0
        ]
        evicted = []
        for oid in victims:
            if freed >= bytes_needed:
                break
            entry = self._entries.pop(oid)
            freed += entry.size
            self._used -= entry.size
            try:
                entry.shm.unlink()
            except FileNotFoundError:
                pass
            _close_shm(entry.shm)
            evicted.append(oid)
        if self._on_evict is not None:
            for oid in evicted:
                try:
                    self._on_evict(oid)
                except Exception:
                    pass

    def _sweep_unlinked(self) -> None:
        """Reclaim accounting for segments whose backing /dev/shm file
        is gone — the daemon spilled or deleted them; this process's
        per-instance bookkeeping just hasn't heard (caller holds lock).
        Pages stay alive for any live zero-copy views; only the
        capacity charge is dropped."""
        for oid in list(self._entries):
            entry = self._entries[oid]
            name = entry.shm._name.lstrip("/")  # noqa: SLF001
            if not os.path.exists("/dev/shm/" + name):
                del self._entries[oid]
                self._used -= entry.size
                _close_shm(entry.shm)

    def _name(self, object_id: ObjectID) -> str:
        return self._prefix + object_id.hex()

    def shutdown(self, unlink: bool = True) -> None:
        with self._lock:
            for oid in list(self._entries):
                self.delete(oid, unlink=unlink)


class ArenaPin:
    """A reader lease on one arena object (plasma buffer analog).

    Holds the slot pinned — unevictable and undeletable — until
    release(), which is idempotent and safe after arena close. The
    worker ties release to the lifetime of the zero-copy buffers it
    hands out (see _TrackedBuffer), matching plasma's Release-on-
    buffer-destruction protocol."""

    __slots__ = ("_arena", "view", "_index", "_released")

    def __init__(self, arena, view: memoryview, index: int):
        self._arena = arena
        self.view = view
        self._index = index
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._arena.unpin_idx(self._index)


def transfer_pin_to_exporter(pin: ArenaPin) -> None:
    """Hand a pin's release to the lifetime of its zero-copy views.

    Every NativeArena view is exported from a PER-PIN ctypes array
    (`NativeArena._view`): memoryviews sliced from it — including
    numpy arrays reconstructed over out-of-band buffers — keep that
    exporter object alive, so a weakref.finalize on the exporter
    fires exactly when the last zero-copy view is garbage-collected
    (plasma's Release-on-buffer-destruction, without the PEP 688
    wrapper this replaced — works on every supported interpreter,
    where the old pure-Python __buffer__ path forced a full copy-out
    below 3.12).

    The finalizer must not close over the pin or its view: finalize
    holds its callback arguments strongly, and pin -> view -> exporter
    would pin the exporter (and the slot) forever. Only the arena
    handle and slot index ride along; arena close() makes a late
    unpin a guarded no-op."""
    import weakref

    exporter = pin.view.obj  # the ctypes array backing every slice
    arena, index = pin._arena, pin._index  # noqa: SLF001 — same module family
    pin.view = None
    pin._released = True  # the exporter owns the release now
    weakref.finalize(exporter, arena.unpin_idx, index)


class NativeArenaStore:
    """Same surface as SharedMemoryStore over the C++ arena
    (_native/store.cc): one mmap'd /dev/shm file per node, first-fit
    free-list allocator, process-shared index, LRU eviction in native
    code. Accounting is arena-global (every process sees one shared
    used/capacity), unlike the per-process bookkeeping above.

    Enabled via config `use_native_object_store` (RT_use_native_object_
    store=1). Readers are protected plasma-style: acquire() pins the
    slot (pins block LRU eviction and defer deletion in store.cc) and
    the returned ArenaPin releases when its zero-copy views die.
    Crashed readers' pins are reclaimed by the daemon's periodic
    reap_dead_pins() (plasma reclaims on client disconnect).
    """

    needs_release = True  # consumers must use acquire()/ArenaPin

    def __init__(self, node_id_hex: str, capacity: int, on_evict=None):
        from .._native import NativeArena

        self._path = f"/dev/shm/rt_arena_{node_id_hex[:8]}"
        self._arena = NativeArena(self._path, capacity, create=True)
        self._on_evict = on_evict
        self._capacity = capacity
        self._seal_events: Dict[ObjectID, threading.Event] = {}
        self._lock = threading.Lock()
        self._shutdown_done = False

    def _notify_evicted(self, raw_ids) -> None:
        if self._on_evict is None:
            return
        for raw in raw_ids:
            try:
                self._on_evict(ObjectID(raw[: ObjectID.SIZE]))
            except Exception:
                pass

    # -- producer side -------------------------------------------------
    def create(self, object_id: ObjectID, size: int) -> memoryview:
        try:
            view, evicted = self._arena.create(object_id.binary(), size)
        except MemoryError as e:
            raise ObjectStoreFullError(str(e)) from None
        self._notify_evicted(evicted)
        return view

    def seal(self, object_id: ObjectID) -> None:
        self._arena.seal(object_id.binary())
        with self._lock:
            event = self._seal_events.pop(object_id, None)
        if event is not None:
            event.set()

    def seal_pinned(self, object_id: ObjectID) -> Optional[ArenaPin]:
        """Seal + creator pin in one arena critical section: a fresh
        SEALED slot with zero pins is an LRU victim, so the creator
        holds this pin until the daemon's primary pin is registered
        (closes the seal->report eviction window). Seal failures raise
        exactly like seal() — a silent None here would let callers
        report an object that doesn't exist."""
        pinned = self._arena.seal_pinned(object_id.binary())
        if pinned is None:
            # Surface the real error (missing slot / bad state) with
            # seal()'s raising semantics; the seal event stays unset.
            self._arena.seal(object_id.binary())
            # seal() somehow succeeded after seal_pinned failed (can
            # only happen if the two raced a delete+recreate): sealed,
            # but no pin to hand out.
        with self._lock:
            event = self._seal_events.pop(object_id, None)
        if event is not None:
            event.set()
        if pinned is None:
            return None
        index, view = pinned
        return ArenaPin(self._arena, view, index)

    def put(self, object_id: ObjectID, data) -> None:
        buf = self.create(object_id, len(data))
        buf[: len(data)] = data
        self.seal(object_id)

    # -- consumer side -------------------------------------------------
    def contains(self, object_id: ObjectID) -> bool:
        return self._arena.contains(object_id.binary())

    def _try_acquire(self, object_id: ObjectID) -> Optional[ArenaPin]:
        """Atomic pin+view (store.cc rts_pin) so the returned view is
        guaranteed to map the pinned slot — immune both to concurrent
        eviction and to delete/re-create ABA on the same oid."""
        pinned = self._arena.try_pin(object_id.binary())
        if pinned is None:
            return None
        index, view = pinned
        return ArenaPin(self._arena, view, index)

    def acquire(
        self, object_id: ObjectID, timeout: Optional[float] = None
    ) -> Optional[ArenaPin]:
        """Pinned zero-copy read lease; None if not sealed in time."""
        pin = self._try_acquire(object_id)
        if pin is not None:
            return pin
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            event = self._seal_events.setdefault(
                object_id, threading.Event()
            )
        try:
            while True:
                remaining = (
                    None if deadline is None else deadline - time.time()
                )
                if remaining is not None and remaining <= 0:
                    return None
                # Same-process seals signal the event; cross-process
                # seals are observed by polling the shared index.
                event.wait(timeout=min(remaining or 0.005, 0.005))
                pin = self._try_acquire(object_id)
                if pin is not None:
                    return pin
        finally:
            # Cross-process seals never pop the event in seal(); drop
            # it here so long-lived consumers don't accumulate one
            # Event per object ever fetched.
            with self._lock:
                self._seal_events.pop(object_id, None)

    def reap_dead_pins(self) -> int:
        return self._arena.reap_dead_pins()

    def unlink_by_id(self, object_id: ObjectID) -> None:
        self._arena.delete(object_id.binary())

    def delete(self, object_id: ObjectID, unlink: bool = True) -> None:
        self._arena.delete(object_id.binary())

    def size_info(self) -> dict:
        return self._arena.stats()

    def shutdown(self, unlink: bool = True) -> None:
        if self._shutdown_done:
            return
        self._shutdown_done = True
        try:
            self._arena.close(unlink=unlink)
        except Exception:
            pass


def make_store(
    node_id_hex: str,
    capacity: int,
    on_evict=None,
    use_native: bool = False,
    client: bool = False,
):
    """Store factory: native arena when requested and buildable, else
    the per-segment Python store. `client=True` marks worker/driver
    instances, whose py-store bookkeeping is per-process and must never
    LRU-evict (the daemon owns eviction and spilling)."""
    if use_native:
        try:
            return NativeArenaStore(
                node_id_hex, capacity, on_evict=on_evict
            )
        except Exception:
            pass
    return SharedMemoryStore(
        node_id_hex, capacity, on_evict=on_evict,
        evict_enabled=not client,
    )
