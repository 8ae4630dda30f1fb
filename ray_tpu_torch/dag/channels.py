# Copied from ray_tpu/dag/channels.py (JAX-free): module names read ray_tpu_torch.
"""Shared-memory SPSC channels for compiled DAGs.

Reference: python/ray/experimental/channel/shared_memory_channel.py:159
— compiled graphs move data over mutable plasma buffers with
acquire/release semantics (core_worker/experimental_mutable_object_
manager.h:48) instead of per-call RPC. Here a channel is a POSIX
shared-memory ring buffer: single writer, single reader, length-framed
pickled records, monotonic head/tail counters in the segment header.
Same-host only by design — cross-host stage boundaries in a TPU
pipeline ride ICI/DCN collectives inside the jitted program
(parallel/pipeline), not the control-plane channel.
"""

from __future__ import annotations

import ctypes
import pickle
import struct
import threading
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Optional

_HEADER = 24  # three u64s: head (written), tail (read), closed flag
_LEN = 8  # per-record length prefix

#: On TSO architectures CPython's sequential bytecode execution plus
#: the hardware ordering make plain counter loads/stores correct for
#: the release/acquire pattern below; elsewhere publication goes
#: through the native atomics. Gating on machine() keeps the hot path
#: at ~0.1us/counter-op (memoryview index) instead of ~1.5us (lock +
#: ctypes FFI round trip) — the difference is 2x on whole-hop latency
#: (MICROBENCH dag_hop_per_s).
import platform as _platform

_TSO = _platform.machine() in ("x86_64", "AMD64", "i686", "i386")


def _load_native(symbol: str):
    """The native library if it loads AND exposes `symbol` (older .so
    builds predate some entry points), else None."""
    try:
        from .._native import load_library

        lib = load_library()
        if lib is not None and hasattr(lib, symbol):
            return lib
    except Exception:
        pass
    return None


#: (load_acquire, store_release) on u64 addresses — real fences,
#: correct on any architecture. None falls back to plain struct
#: access, safe on x86-TSO where CPython's stores aren't reordered.
_lib = _load_native("rts_load_acq_u64")
_ATOMICS = (
    (_lib.rts_load_acq_u64, _lib.rts_store_rel_u64) if _lib else None
)
#: (wait, wake) on the low u32 word of a counter — the kernel-sleep
#: half of the doorbell; spin covers the hot path.
_lib = _load_native("rts_futex_wait_u32")
_FUTEX = (_lib.rts_futex_wait_u32, _lib.rts_futex_wake) if _lib else None
#: Whole-op native ring put/get (store.cc rts_chan_put/get). One FFI
#: call per operation instead of ~6 plus interpreter work: measured
#: 39us -> ~25us per two-process ping-pong hop on the 1-core CI box
#: (vs a 6.9us OS-pipe floor), and the compiled-DAG hop 8.3k -> 23k/s.
_CHAN_NATIVE = _load_native("rts_chan_put")
del _lib
import errno as _errno
#: Hot-spin budget before sleeping in the kernel: covers the common
#: compiled-pipeline turnaround (~tens of us) without a syscall. On a
#: single-CPU machine spinning is counterproductive — the waiter burns
#: the exact quantum its peer needs to produce the data — so go
#: straight to the futex there.
import os as _os

_SPIN_NS = 100_000 if (_os.cpu_count() or 1) > 1 else 0
#: Bounded kernel waits so a peer's close() (shared flag, no doorbell
#: reachable after unmap) is noticed promptly even with no traffic.
_WAIT_CHUNK_NS = 20_000_000

STOP = b"__RT_DAG_STOP__"


class ChannelClosedError(Exception):
    pass


class ChannelTimeoutError(Exception):
    pass


class ShmChannel:
    """Single-producer single-consumer shared-memory ring buffer."""

    def __init__(
        self,
        capacity: int = 4 * 1024 * 1024,
        *,
        name: Optional[str] = None,
        create: bool = True,
    ):
        # Round up to a u64 multiple: the counter view below casts the
        # whole segment to "Q", which requires 8-divisible length (and
        # the ring's length-prefixed records don't care).
        capacity = (capacity + 7) & ~7
        self.capacity = capacity
        if create:
            self._shm = shared_memory.SharedMemory(
                create=True, size=_HEADER + capacity
            )
            self._shm.buf[:_HEADER] = b"\x00" * _HEADER
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            # The creator owns the segment lifetime; stop the attaching
            # process's resource tracker from unlinking it at exit.
            try:
                resource_tracker.unregister(
                    self._shm._name, "shared_memory"  # noqa: SLF001
                )
            except Exception:
                pass
        self.name = self._shm.name
        self._closed = False
        # Base address of the header for the native atomic accessors.
        self._base_addr = ctypes.addressof(
            ctypes.c_char.from_buffer(self._shm.buf)
        )
        # u64 view over the whole segment; indices 0/1/2 are
        # head/tail/closed. The hot paths below index this directly —
        # a memoryview load is ~15x cheaper than a lock + FFI call.
        self._u64 = self._shm.buf.cast("Q")
        # Guards counter access against close() unmapping the segment:
        # a native atomic load on an unmapped address is a segfault,
        # not an exception.
        self._io_lock = threading.Lock()
        # Whole-op native path state: reusable receive buffer and the
        # count of threads currently inside a native call (close()
        # must not unmap the segment under them). The per-direction
        # locks serialize concurrent callers of the same operation —
        # the ring is SPSC, and the native path must keep the Python
        # path's per-op atomicity (two concurrent getters would race
        # the shared scratch buffer; two putters the head counter).
        self._scratch = None
        self._inflight = 0
        self._tx_lock = threading.Lock()
        self._rx_lock = threading.Lock()

    # -- counters ------------------------------------------------------
    # Counter reads/writes live inline in put_bytes/get_bytes/_await
    # (single lock round, _u64 view on TSO, FFI release/acquire
    # elsewhere). _store survives only for close()'s shared flag.
    def _store(self, offset: int, v: int) -> None:
        with self._io_lock:
            if self._closed:
                raise ChannelClosedError(self.name)
            if _ATOMICS is not None:
                _ATOMICS[1](self._base_addr + offset, v)
                return
            struct.pack_into("<Q", self._shm.buf, offset, v)

    # -- ring IO -------------------------------------------------------
    def _write_at(self, pos: int, payload: bytes) -> None:
        offset = pos % self.capacity
        first = min(len(payload), self.capacity - offset)
        base = _HEADER + offset
        self._shm.buf[base : base + first] = payload[:first]
        if first < len(payload):
            rest = len(payload) - first
            self._shm.buf[_HEADER : _HEADER + rest] = payload[first:]

    def _read_at(self, pos: int, size: int) -> bytes:
        offset = pos % self.capacity
        first = min(size, self.capacity - offset)
        base = _HEADER + offset
        out = bytes(self._shm.buf[base : base + first])
        if first < size:
            out += bytes(self._shm.buf[_HEADER : _HEADER + size - first])
        return out

    # -- blocking ------------------------------------------------------
    def _await(self, need, watch_offset: int, timeout, label: str):
        """Block until `need(head, tail)` holds. Adaptive: hot-spin
        for a short budget (covers the in-flight-producer case with
        zero syscalls), then sleep in the kernel on the counter at
        `watch_offset` via futex until the peer's doorbell — or
        sleep-poll when the native library is absent. The futex
        compares the counter's low u32 in-kernel, so a wake between
        snapshot and sleep can't be lost (reference semantics:
        mutable-object WaitForWritten/WaitForReadable,
        core_worker/experimental_mutable_object_manager.h:48,153 —
        which block on a shared condvar, same shape). One lock round
        per cycle: on a one-core box every hop sleeps here, so this
        path is as hot as put/get themselves."""
        deadline = None if timeout is None else time.monotonic() + timeout
        spin_until = time.monotonic_ns() + _SPIN_NS
        use_futex = _FUTEX is not None and _ATOMICS is not None
        while True:
            with self._io_lock:
                if self._closed:
                    raise ChannelClosedError(self.name)
                u = self._u64
                if _ATOMICS is not None and not _TSO:
                    head = int(_ATOMICS[0](self._base_addr))
                    tail = int(_ATOMICS[0](self._base_addr + 8))
                else:
                    head, tail = u[0], u[1]
                if need(head, tail):
                    return
                if u[2]:
                    raise ChannelClosedError(self.name)
                snap = (head if watch_offset == 0 else tail) & 0xFFFFFFFF
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(f"{label} on {self.name}")
            if not use_futex:
                time.sleep(0.0002)
                continue
            if time.monotonic_ns() < spin_until:
                continue
            # Bounded sleep; EAGAIN (counter already moved) and
            # spurious wakeups just re-run the loop. The segment can't
            # be unmapped out from under the kernel wait by our own
            # close() (io_lock above re-checked _closed), and a peer
            # unmap at worst faults the wait into an error return.
            _FUTEX[0](self._base_addr + watch_offset, snap, _WAIT_CHUNK_NS)

    def _ring_doorbell(self, watch_offset: int) -> None:
        if _FUTEX is None:
            return
        with self._io_lock:
            if self._closed:
                return
            _FUTEX[1](self._base_addr + watch_offset, 2**31 - 1)

    # -- public --------------------------------------------------------
    # The hot paths take _io_lock ONCE per operation and touch the
    # counters through the u64 view: the previous structure (a locked
    # FFI round trip per counter access, five per put/get) measured
    # ~23us per put+get pair against a 4.7us OS pipe ping-pong floor —
    # the channel layer, not scheduling, dominated compiled-DAG hop
    # latency. Publication ordering: payload bytes are stored before
    # the head/tail bump; TSO hardware (x86) preserves that order for
    # plain stores, other architectures publish through the native
    # store-release.
    # -- whole-op native path ------------------------------------------
    def _native_enter(self):
        with self._io_lock:
            if self._closed:
                raise ChannelClosedError(self.name)
            self._inflight += 1

    def _native_exit(self):
        with self._io_lock:
            self._inflight -= 1

    def _native_put(self, payload: bytes, timeout: Optional[float]):
        t_ns = -1 if timeout is None else max(0, int(timeout * 1e9))
        with self._tx_lock:
            self._native_enter()
            try:
                rc = _CHAN_NATIVE.rts_chan_put(
                    self._base_addr, self.capacity, payload,
                    len(payload), t_ns,
                )
            finally:
                self._native_exit()
        if rc == 0:
            return
        if rc == -_errno.EPIPE:
            raise ChannelClosedError(self.name)
        if rc == -_errno.ETIMEDOUT:
            raise ChannelTimeoutError(f"put on {self.name}")
        if rc == -_errno.EMSGSIZE:
            raise ValueError(
                f"message of {len(payload)} bytes exceeds channel "
                f"capacity {self.capacity}; recompile with a larger "
                "buffer_size_bytes"
            )
        raise RuntimeError(f"native channel put failed: rc={rc}")

    def _native_get(self, timeout: Optional[float]) -> bytes:
        t_ns = -1 if timeout is None else max(0, int(timeout * 1e9))
        with self._rx_lock:
            if self._scratch is None:
                self._scratch = ctypes.create_string_buffer(
                    self.capacity
                )
            self._native_enter()
            try:
                n = _CHAN_NATIVE.rts_chan_get(
                    self._base_addr, self.capacity, self._scratch,
                    self.capacity, t_ns,
                )
            finally:
                self._native_exit()
            if n >= 0:
                return self._scratch[:n]
        if n == -_errno.EPIPE:
            raise ChannelClosedError(self.name)
        if n == -_errno.ETIMEDOUT:
            raise ChannelTimeoutError(f"get on {self.name}")
        raise RuntimeError(f"native channel get failed: rc={n}")

    def put_bytes(self, payload: bytes, timeout: Optional[float] = None):
        if _CHAN_NATIVE is not None:
            return self._native_put(payload, timeout)
        record = len(payload) + _LEN
        if record > self.capacity:
            raise ValueError(
                f"message of {len(payload)} bytes exceeds channel "
                f"capacity {self.capacity}; recompile with a larger "
                "buffer_size_bytes"
            )
        # One deadline for the WHOLE call: _await may be re-entered
        # (another thread can consume freed space first), and a
        # restarted timeout would block past the caller's bound.
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._io_lock:
                if self._closed:
                    raise ChannelClosedError(self.name)
                u = self._u64
                if u[2]:
                    raise ChannelClosedError(self.name)
                head = u[0]
                if self.capacity - (head - u[1]) >= record:
                    self._write_at(head, struct.pack("<Q", len(payload)))
                    self._write_at(head + _LEN, payload)
                    if _ATOMICS is not None and not _TSO:
                        _ATOMICS[1](self._base_addr, head + record)
                    else:
                        u[0] = head + record
                    if _FUTEX is not None:  # wake a reader on head
                        _FUTEX[1](self._base_addr, 2**31 - 1)
                    return
            # Ring full: wait for the reader to advance tail (off 8).
            self._await(
                lambda head, tail: self.capacity - (head - tail)
                >= record,
                8,
                None if deadline is None
                else deadline - time.monotonic(),
                "put",
            )

    def get_bytes(self, timeout: Optional[float] = None) -> bytes:
        if _CHAN_NATIVE is not None:
            return self._native_get(timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._io_lock:
                if self._closed:
                    raise ChannelClosedError(self.name)
                u = self._u64
                tail = u[1]
                head = (
                    int(_ATOMICS[0](self._base_addr))
                    if _ATOMICS is not None and not _TSO
                    else u[0]
                )
                if head - tail >= _LEN:
                    (size,) = struct.unpack(
                        "<Q", self._read_at(tail, _LEN)
                    )
                    payload = self._read_at(tail + _LEN, size)
                    if _ATOMICS is not None and not _TSO:
                        _ATOMICS[1](
                            self._base_addr + 8, tail + _LEN + size
                        )
                    else:
                        u[1] = tail + _LEN + size
                    if _FUTEX is not None:  # wake a writer on tail
                        _FUTEX[1](self._base_addr + 8, 2**31 - 1)
                    return payload
                if u[2]:
                    raise ChannelClosedError(self.name)
            # Ring empty: wait for the writer to advance head (off 0).
            self._await(
                lambda head, tail: head - tail >= _LEN,
                0,
                None if deadline is None
                else deadline - time.monotonic(),
                "get",
            )

    def put(self, value: Any, timeout: Optional[float] = None) -> None:
        self.put_bytes(pickle.dumps(value), timeout=timeout)

    def get(self, timeout: Optional[float] = None) -> Any:
        return pickle.loads(self.get_bytes(timeout=timeout))

    def close(self) -> None:
        try:
            # Shared flag first (while still mapped): a peer blocked in
            # put/get on the other side of the ring sees it and raises
            # instead of spinning forever (`_closed` is process-local).
            self._store(16, 1)
            # Ring both doorbells so a peer sleeping in the kernel
            # notices immediately (it would otherwise wait out one
            # bounded chunk).
            self._ring_doorbell(0)
            self._ring_doorbell(8)
        except Exception:
            pass
        # A thread blocked inside a whole-op native call holds a raw
        # pointer into the mapping; it has just been woken (closed
        # flag + doorbells) and will exit with EPIPE — wait it out
        # before unmapping (unmapping under it would segfault, not
        # raise). Bounded: native waits re-check in <=200ms chunks.
        deadline = time.monotonic() + 2.0
        while True:
            with self._io_lock:
                if self._inflight == 0 or time.monotonic() > deadline:
                    self._closed = True
                    busy = self._inflight > 0
                    if not busy:
                        try:
                            self._u64.release()
                        except Exception:
                            pass
                        try:
                            self._shm.close()
                        except BufferError:
                            pass
                    # busy after the grace: leave the mapping in place
                    # (freed at GC) rather than segfault a straggler.
                    return
            try:
                self._ring_doorbell(0)
                self._ring_doorbell(8)
            except Exception:
                pass
            time.sleep(0.001)

    def unlink(self) -> None:
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __del__(self):
        # Release the cast view before SharedMemory.__del__ runs its
        # own close(), which otherwise reports un-catchable
        # "exported pointers exist" BufferErrors at GC time.
        try:
            self._u64.release()
        except Exception:
            pass

    def __reduce__(self):
        # Deserializing attaches to the same segment (reader side).
        return (_attach, (self.name, self.capacity))


def _attach(name: str, capacity: int) -> "ShmChannel":
    return ShmChannel(capacity, name=name, create=False)
