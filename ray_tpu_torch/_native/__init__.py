# Copied from ray_tpu/_native/__init__.py, with the library built by g++
# from the copied store.cc into the gitignored build/ray_tpu_torch/ at
# first use (named by a hash of the source and flags), never shipped.
"""ctypes binding to the native arena store.

Builds the store library from `store.cc` on first use if the toolchain
is available (g++ is part of the supported image); callers fall back to
the pure-Python per-segment store when the library can't load
(reference split: plasma is C++, its client rides in every worker).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "store.cc")
_CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-lpthread")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "ray_tpu_torch")
#: RT_NATIVE_SO overrides the library path (a pre-built library, loaded
#: as it is; the build is skipped then). One import-time snapshot drives
#: BOTH the path and the skip-build decision so they can never disagree.
_SO_OVERRIDE = os.environ.get("RT_NATIVE_SO")
_build_lock = threading.Lock()  # rt: noqa[RT004] — held only inside load_library(), never across fork
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

OID_BYTES = 20

RTS_OK = 0
RTS_ERR_EXISTS = -2
RTS_ERR_FULL = -3
RTS_ERR_MISSING = -4
RTS_ERR_STATE = -5


def library_path() -> str:
    """Where the store library built from this store.cc lives."""
    if _SO_OVERRIDE:
        return _SO_OVERRIDE
    digest = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD_DIR, f"store-{digest.hexdigest()[:16]}.so")


def _build(target: str) -> None:
    """g++ store.cc into `target` (through a temporary file, so a
    concurrent loader never maps a half-written library)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    subprocess.run(
        [os.environ.get("CXX", "g++"), _SOURCE, "-o", tmp, *_CXXFLAGS],
        check=True,
        capture_output=True,
        timeout=120,
    )
    os.replace(tmp, target)


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native store; None on failure."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _build_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if _SO_OVERRIDE is None and not os.path.exists(so):
            try:
                _build(so)
            except Exception:
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _load_failed = True
            return None
        lib.rts_open.restype = ctypes.c_void_p
        lib.rts_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
            ctypes.c_int,
        ]
        lib.rts_base.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rts_base.argtypes = [ctypes.c_void_p]
        lib.rts_create.restype = ctypes.c_int64
        lib.rts_create.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.rts_seal.restype = ctypes.c_int
        lib.rts_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_lookup.restype = ctypes.c_int64
        lib.rts_lookup.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
        ]
        lib.rts_pin.restype = ctypes.c_int64
        lib.rts_pin.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rts_seal_pinned.restype = ctypes.c_int64
        lib.rts_seal_pinned.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rts_unpin_idx.restype = ctypes.c_int
        lib.rts_unpin_idx.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.rts_reap_dead_pins.restype = ctypes.c_int
        lib.rts_reap_dead_pins.argtypes = [ctypes.c_void_p]
        lib.rts_untracked_pins.restype = ctypes.c_uint64
        lib.rts_untracked_pins.argtypes = [ctypes.c_void_p]
        lib.rts_delete.restype = ctypes.c_int
        lib.rts_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_stats.restype = ctypes.c_int
        lib.rts_stats.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rts_close.restype = None
        lib.rts_close.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_char_p,
        ]
        try:  # added after v1 .so builds; staleness check rebuilds,
            # but never let a stale binary break the whole store.
            lib.rts_load_acq_u64.restype = ctypes.c_uint64
            lib.rts_load_acq_u64.argtypes = [ctypes.c_void_p]
            lib.rts_store_rel_u64.restype = None
            lib.rts_store_rel_u64.argtypes = [
                ctypes.c_void_p,
                ctypes.c_uint64,
            ]
        except AttributeError:
            pass
        try:  # futex doorbell (added with the DAG channel wakeups)
            lib.rts_futex_wait_u32.restype = ctypes.c_int
            lib.rts_futex_wait_u32.argtypes = [
                ctypes.c_void_p,
                ctypes.c_uint32,
                ctypes.c_int64,
            ]
            lib.rts_futex_wake.restype = ctypes.c_int
            lib.rts_futex_wake.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int,
            ]
        except AttributeError:
            pass
        try:  # whole-op ring put/get (dag/channels.py hot path)
            lib.rts_chan_put.restype = ctypes.c_int
            lib.rts_chan_put.argtypes = [
                ctypes.c_void_p,
                ctypes.c_uint64,
                ctypes.c_char_p,
                ctypes.c_uint64,
                ctypes.c_int64,
            ]
            lib.rts_chan_get.restype = ctypes.c_int64
            lib.rts_chan_get.argtypes = [
                ctypes.c_void_p,
                ctypes.c_uint64,
                ctypes.c_void_p,
                ctypes.c_uint64,
                ctypes.c_int64,
            ]
        except AttributeError:
            pass
        _lib = lib
        return _lib


class NativeArena:
    """Thin OO wrapper over the C surface (one arena per node)."""

    def __init__(
        self,
        path: str,
        capacity: int,
        num_slots: int = 65536,
        create: bool = True,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native store library unavailable")
        self._lib = lib
        self._path = path.encode()
        self._handle = lib.rts_open(
            self._path, capacity, num_slots, 1 if create else 0
        )
        if not self._handle:
            raise RuntimeError(f"rts_open failed for {path}")
        self._base = ctypes.cast(
            lib.rts_base(self._handle), ctypes.c_void_p
        ).value
        self._closed = False
        # Serializes native entry points against close(): a bare
        # `_closed` flag check is a TOCTOU — close() unmapping the
        # arena while another thread (daemon heartbeat reaper, RPC
        # handler) is inside an rts_* call is a segfault. RLock, not
        # Lock: unpin finalizers fire from GC at arbitrary points,
        # including while the same thread holds the lock.
        self._call_lock = threading.RLock()

    @classmethod
    def attach(cls, path: str) -> "NativeArena":
        """Attach to ANOTHER process's arena file (same host), sizing
        the mapping from the creator's on-disk header — the attacher
        need not know the creator's capacity/num_slots config. Used by
        the daemon's same-host object-transfer fast path (plasma
        analog: clients mmap the store and read under a pin)."""
        import struct

        with open(path, "rb") as f:
            header = f.read(40)  # magic,capacity,used,lru_clock,slots
        if len(header) < 40:
            raise RuntimeError(f"truncated arena header: {path}")
        magic, capacity, _used, _clock, num_slots = struct.unpack(
            "<QQQQI", header[:36]
        )
        if magic != 0x5254535052455632:  # store.cc kMagic
            raise RuntimeError(f"not an arena file: {path}")
        return cls(path, capacity, num_slots=num_slots, create=False)

    @staticmethod
    def _key(oid: bytes) -> bytes:
        if len(oid) > OID_BYTES:
            raise ValueError("oid too long")
        return oid.ljust(OID_BYTES, b"\0")

    def _view(self, offset: int, size: int) -> memoryview:
        address = self._base + offset
        buf = (ctypes.c_char * size).from_address(address)
        return memoryview(buf).cast("B")

    def create(self, oid: bytes, size: int):
        """Returns (writable memoryview, [evicted oids])."""
        evicted = ctypes.create_string_buffer(OID_BYTES * 64)
        n_evicted = ctypes.c_int(0)
        with self._call_lock:
            if self._closed:
                raise MemoryError("arena closed")
            offset = self._lib.rts_create(
                self._handle,
                self._key(oid),
                max(size, 1),
                evicted,
                64,
                ctypes.byref(n_evicted),
            )
        if offset == RTS_ERR_EXISTS:
            raise ValueError(f"object {oid.hex()} already exists")
        if offset < 0:
            raise MemoryError(f"arena full (err {offset})")
        ids = [
            evicted.raw[i * OID_BYTES : (i + 1) * OID_BYTES]
            for i in range(n_evicted.value)
        ]
        return self._view(offset, max(size, 1))[:size], ids

    def seal(self, oid: bytes) -> None:
        with self._call_lock:
            if self._closed:
                raise KeyError("arena closed")
            rc = self._lib.rts_seal(self._handle, self._key(oid))
        if rc != RTS_OK:
            raise KeyError(f"seal({oid.hex()}) -> {rc}")

    def get(self, oid: bytes, sealed_only: bool = True):
        size = ctypes.c_uint64(0)
        with self._call_lock:
            if self._closed:
                return None
            offset = self._lib.rts_lookup(
                self._handle,
                self._key(oid),
                ctypes.byref(size),
                1 if sealed_only else 0,
            )
            if offset < 0:
                return None
            # View built inside the critical section: offset is only
            # meaningful while nothing can close/delete in between
            # (same atomic lookup+view shape as try_pin).
            return self._view(offset, max(int(size.value), 1))[
                : int(size.value)
            ]

    def contains(self, oid: bytes) -> bool:
        return self.get(oid) is not None

    def try_pin(self, oid: bytes):
        """Atomically pin the sealed slot holding `oid` and return
        (slot_index, zero-copy view) — or None if absent/unsealed.
        Offset and size come back from the same critical section as
        the pin, so the view always maps the pinned slot (a separate
        lookup could race with delete + re-create of the oid)."""
        offset = ctypes.c_uint64(0)
        size = ctypes.c_uint64(0)
        with self._call_lock:
            if self._closed:
                return None
            index = self._lib.rts_pin(
                self._handle,
                self._key(oid),
                ctypes.byref(offset),
                ctypes.byref(size),
            )
            if index < 0:
                return None
            n = int(size.value)
            return (
                int(index),
                self._view(int(offset.value), max(n, 1))[:n],
            )

    def seal_pinned(self, oid: bytes):
        """Seal the CREATING slot and take a reader pin in one
        critical section (see rts_seal_pinned: closes the window where
        a freshly sealed, pin-less slot is an LRU victim before its
        owner can protect it). Returns (slot_index, view) or None."""
        offset = ctypes.c_uint64(0)
        size = ctypes.c_uint64(0)
        with self._call_lock:
            if self._closed:
                return None
            index = self._lib.rts_seal_pinned(
                self._handle,
                self._key(oid),
                ctypes.byref(offset),
                ctypes.byref(size),
            )
            if index < 0:
                return None
            n = int(size.value)
            return (
                int(index),
                self._view(int(offset.value), max(n, 1))[:n],
            )

    def unpin_idx(self, index: int) -> None:
        # Reader-pin finalizers can outlive close() (weakref.finalize on
        # fetched values fires at GC time); touching the unmapped arena
        # then would segfault.
        with self._call_lock:
            if self._closed:
                return
            self._lib.rts_unpin_idx(self._handle, index)

    def reap_dead_pins(self) -> int:
        """Release pins whose owning process has died (plasma's
        disconnect-reclaim analog); returns pins reclaimed."""
        with self._call_lock:
            if self._closed:
                return 0
            return int(self._lib.rts_reap_dead_pins(self._handle))

    def delete(self, oid: bytes) -> bool:
        with self._call_lock:
            if self._closed:
                return False
            return (
                self._lib.rts_delete(self._handle, self._key(oid))
                == RTS_OK
            )

    def stats(self) -> dict:
        capacity = ctypes.c_uint64(0)
        used = ctypes.c_uint64(0)
        num = ctypes.c_uint64(0)
        with self._call_lock:
            if self._closed:
                return {
                    "capacity": 0, "used": 0, "num_objects": 0,
                    "untracked_pins": 0,
                }
            self._lib.rts_stats(
                self._handle,
                ctypes.byref(capacity),
                ctypes.byref(used),
                ctypes.byref(num),
            )
            untracked = int(self._lib.rts_untracked_pins(self._handle))
        return {
            "capacity": capacity.value,
            "used": used.value,
            "num_objects": num.value,
            "untracked_pins": untracked,
        }

    def close(self, unlink: bool = False) -> None:
        with self._call_lock:
            if self._closed:
                return
            self._closed = True
            self._lib.rts_close(
                self._handle, 1 if unlink else 0, self._path
            )
