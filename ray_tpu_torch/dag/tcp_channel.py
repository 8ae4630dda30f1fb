# Copied from ray_tpu/dag/tcp_channel.py (JAX-free): module names read ray_tpu_torch.
"""Cross-node SPSC channels for compiled DAGs.

Reference: src/ray/protobuf/node_manager.proto:467-469 + core_worker/
experimental_mutable_object_manager.h — compiled-graph mutable objects
are *pushed* to the reader's node when writer and reader live on
different nodes, so a pipeline stage boundary can cross hosts without
falling back to per-call task RPC. Here the cross-node edge is a
direct TCP stream between the two workers with the same length-framed
record protocol as the same-host shm ring (`channels.py`):

- the READER binds an ephemeral port on its node and publishes
  ``host:port`` under the channel id in the GCS KV (namespace
  ``dagchan``) — the same rendezvous table function export uses;
- the WRITER polls the KV for the address and connects.

Roles are assigned lazily by the first operation (first ``get`` makes
this end the reader, first ``put`` the writer), so a channel descriptor
pickles to either side of the edge unchanged. TCP's bounded socket
buffers provide the backpressure the shm ring gets from its capacity:
a slow reader eventually blocks the writer's ``send``.

Timeout semantics match ShmChannel where physics allows: a timed-out
``get`` preserves partially-received bytes and resumes the SAME record
on retry (``CompiledDAGRef.get`` documents retry-after-timeout as
safe); a timed-out ``put`` preserves unsent bytes and flushes them
before the next record — so a record is never torn mid-frame, though
unlike shm a put that timed out mid-send will still complete delivery
on the next operation (TCP cannot un-send).

Record identity: every record is framed with a per-channel
monotonically increasing sequence number ([u64 len][u64 seq] header).
A put that times out raises ``ChannelTimeoutError`` carrying the
record's ``seq``; retrying the SAME record means calling
``put_bytes(payload, seq=err.seq)`` — the channel finishes delivering
that record exactly once. A put WITHOUT a retry token is always a new
record, even if its bytes equal a pending one: dedup is by sequence
number, never payload equality (two execute() calls with equal inputs
are two records — comparing bytes silently dropped one and desynced
the driver's result sequencing). The reader verifies the sequence is
gapless and drops any duplicate seq, so the no-dup/no-loss guarantee
is end-to-end.

Dense tensor traffic between TPU pipeline stages still rides ICI
collectives inside the jitted program (parallel/pipeline.py); these
channels carry the control-plane records (activations for CPU stages,
small tensors, errors, stop tokens).
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
import uuid
from typing import Any, Optional

from .channels import ChannelClosedError, ChannelTimeoutError

#: Record header: u64 payload length + u64 sequence number. (The
#: same-host shm ring keeps its bare length prefix — its records never
#: retry across a reconnectable transport, so it needs no identity.)
_HDR = 16
_KV_NS = "dagchan"
_POLL_S = 0.02


def _kv_call(method: str, **kw) -> dict:
    from .._private.worker import global_worker

    worker = global_worker()
    if worker is None:
        raise ChannelClosedError("no worker/driver runtime for KV rendezvous")
    return worker.call(method, **kw)


def _advertise_ip() -> str:
    """The IP other nodes can reach this process at. Single-box
    clusters (tests, FakeMultiNode) resolve to loopback."""
    import os

    ip = os.environ.get("RT_NODE_IP")
    if ip:
        return ip
    from .._private.rpc import _detect_host_ip

    return _detect_host_ip()


class TcpChannel:
    """SPSC stream channel across nodes; same put/get surface as
    ShmChannel so compiled-DAG loops are transport-agnostic."""

    def __init__(self, capacity: int = 4 * 1024 * 1024, *,
                 chan_id: Optional[str] = None):
        self.capacity = capacity
        self.chan_id = chan_id or uuid.uuid4().hex
        self.name = f"tcpchan-{self.chan_id[:12]}"
        self._sock: Optional[socket.socket] = None
        self._listener: Optional[socket.socket] = None
        self._role: Optional[str] = None
        self._closed = False
        #: Guards the small mutable state only — never held across a
        #: blocking accept/recv/send/KV poll, so close() can always
        #: acquire it and interrupt a blocked peer by closing the
        #: socket under it.
        self._lock = threading.Lock()
        #: Serializes first-use setup; close() does NOT take it.
        self._setup_lock = threading.Lock()
        # Resumable-IO state: bytes of the current inbound record
        # (header included) and the unsent tail of the current
        # outbound record — a timeout leaves these intact so a retry
        # continues the same record instead of desyncing the stream.
        self._rx = bytearray()
        self._tx = b""
        # Sequence framing (writer side): seq of the record currently
        # pending in _tx, the next seq to allocate, and the highest
        # seq fully handed to the kernel — a retry token is matched
        # against these, so dedup is by record identity, never by
        # payload bytes.
        self._tx_seq: Optional[int] = None
        self._next_tx_seq = 0
        self._last_sent_seq = -1
        # Reader side: next sequence number the stream owes us.
        self._rx_next_seq = 0

    # -- rendezvous ----------------------------------------------------
    def bind_reader(self) -> None:
        """Bind + publish this end as the reader WITHOUT accepting.
        The compiled-DAG driver calls this at compile time for its
        output channels so a stage's first put() can always resolve an
        address and complete into the TCP backlog/kernel buffers —
        even if the driver never reads (teardown-without-get must not
        wedge the stage's exec loop in rendezvous)."""
        with self._lock:
            if self._closed:
                raise ChannelClosedError(self.name)
            if self._role is None:
                self._role = "reader"
            elif self._role != "reader":
                raise RuntimeError(f"{self.name} already a {self._role}")
        with self._setup_lock:
            self._bind_and_publish()

    def _bind_and_publish(self) -> Optional[socket.socket]:
        """Create + publish the listener exactly once; returns it (or
        None if the channel closed underneath)."""
        with self._lock:
            if self._closed:
                raise ChannelClosedError(self.name)
            listener = self._listener
            if listener is not None:
                return listener
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(("0.0.0.0", 0))
            listener.listen(1)
            self._listener = listener
            port = listener.getsockname()[1]
        addr = f"{_advertise_ip()}:{port}"
        _kv_call("kv_put", ns=_KV_NS, key=self.chan_id,
                 value=addr.encode(), overwrite=True)
        return listener

    def _ensure(self, role: str, timeout: Optional[float]) -> socket.socket:
        with self._lock:
            if self._closed:
                raise ChannelClosedError(self.name)
            if self._role is None:
                self._role = role
            elif self._role != role:
                raise RuntimeError(
                    f"{self.name} already bound as {self._role}; SPSC "
                    f"channels serve one direction per endpoint"
                )
            if self._sock is not None:
                return self._sock
        with self._setup_lock:
            with self._lock:
                if self._closed:
                    raise ChannelClosedError(self.name)
                if self._sock is not None:
                    return self._sock
            if role == "reader":
                return self._setup_reader(timeout)
            return self._setup_writer(timeout)

    def _setup_reader(self, timeout: Optional[float]) -> socket.socket:
        # Bind + publish exactly once; an accept timeout keeps the
        # listener (and its published address) so a retried get()
        # accepts on the SAME port — rebinding would strand a writer
        # that already resolved the old address.
        listener = self._bind_and_publish()
        listener.settimeout(timeout)
        try:
            conn, _ = listener.accept()  # rt: noqa[RT203] — _setup_lock serializes connection setup; the accept IS the setup step
        except socket.timeout:
            raise ChannelTimeoutError(
                f"accept on {self.name} (writer not connected yet)"
            ) from None
        except OSError:
            # close() shut the listener under us.
            raise ChannelClosedError(self.name) from None
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Bound kernel-buffered bytes to the channel capacity so a
        # stalled reader applies backpressure at roughly the same
        # high-water mark as the shm ring.
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                        min(self.capacity, 4 * 1024 * 1024))
        with self._lock:
            if self._closed:
                conn.close()
                raise ChannelClosedError(self.name)
            self._sock = conn
            listener.close()
            self._listener = None
        return conn

    def _setup_writer(self, timeout: Optional[float]) -> socket.socket:
        # timeout=None blocks indefinitely, matching a ShmChannel put
        # against an absent reader (the reader binds on its first
        # get(), which for DAG output edges is the driver's first
        # ref.get() — arbitrarily later than the stage's first put).
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._closed:
                raise ChannelClosedError(self.name)
            reply = _kv_call("kv_get", ns=_KV_NS, key=self.chan_id)
            value = reply.get("value")
            if value:
                addr = value.decode()
                break
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"rendezvous on {self.name} (no reader address)"
                )
            time.sleep(_POLL_S)  # rt: noqa[RT203] — setup-time retry backoff under the setup lock: nothing else may connect meanwhile
        host, port = addr.rsplit(":", 1)
        while True:
            try:
                sock = socket.create_connection(
                    (host, int(port)), timeout=5.0
                )
                break
            except OSError:
                if self._closed:
                    raise ChannelClosedError(self.name) from None
                if deadline is not None and time.monotonic() > deadline:
                    raise ChannelTimeoutError(
                        f"connect to {addr} for {self.name}"
                    ) from None
                time.sleep(_POLL_S)  # rt: noqa[RT203] — setup-time retry backoff under the setup lock: nothing else may connect meanwhile
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                        min(self.capacity, 4 * 1024 * 1024))
        with self._lock:
            if self._closed:
                sock.close()
                raise ChannelClosedError(self.name)
            self._sock = sock
        return sock

    # -- IO ------------------------------------------------------------
    def put_bytes(self, payload: bytes,
                  timeout: Optional[float] = None, *,
                  seq: Optional[int] = None) -> int:
        """Send one record; returns its sequence number.

        `seq` is a RETRY TOKEN only: pass the `.seq` carried by a
        previous ChannelTimeoutError to finish delivering that exact
        record (already-delivered tokens are a no-op). Without a
        token every call is a new record — identical bytes do NOT
        make a retry (see module docstring: dedup is by sequence
        number, never payload equality).
        """
        if len(payload) + _HDR > self.capacity:
            # Same contract as the shm ring: placement must not decide
            # whether an oversized record is accepted.
            raise ValueError(
                f"message of {len(payload)} bytes exceeds channel "
                f"capacity {self.capacity}; recompile with a larger "
                "buffer_size_bytes"
            )
        if seq is not None and seq != self._tx_seq:
            if seq <= self._last_sent_seq:
                return seq  # retry of a fully delivered record: no-op
            raise ValueError(
                f"unknown retry token seq={seq} on {self.name} (pending="
                f"{self._tx_seq}, last sent={self._last_sent_seq})"
            )
        sock = self._ensure("writer", timeout)
        sock.settimeout(timeout)
        try:
            if self._tx:
                # Finish the partially-sent previous record first —
                # the stream must never interleave frames. If the
                # caller holds that record's retry token, flushing IS
                # the send; otherwise this is a new record behind it.
                pending_seq = self._tx_seq
                try:
                    self._flush_locked_state(sock)
                except socket.timeout:
                    err = ChannelTimeoutError(f"put on {self.name}")
                    # The token belongs to whoever queued the pending
                    # record. A caller submitting a NEW record gets no
                    # token — its record was never accepted, so its
                    # retry is a plain put_bytes() again.
                    err.seq = pending_seq if seq == pending_seq else None
                    raise err from None
                if seq is not None and seq == pending_seq:
                    return seq
            cur = self._next_tx_seq
            self._next_tx_seq += 1
            self._tx = memoryview(
                struct.pack("<QQ", len(payload), cur) + payload
            )
            self._tx_seq = cur
            try:
                self._flush_locked_state(sock)
            except socket.timeout:
                err = ChannelTimeoutError(f"put on {self.name}")
                # The retry token: put_bytes(payload, seq=err.seq)
                # resumes THIS record instead of queueing a duplicate.
                err.seq = cur
                raise err from None
            return cur
        except OSError:
            raise ChannelClosedError(self.name) from None

    def _flush_locked_state(self, sock: socket.socket) -> None:
        while self._tx:
            n = sock.send(self._tx)
            self._tx = self._tx[n:]
        if self._tx_seq is not None:
            self._last_sent_seq = max(self._last_sent_seq, self._tx_seq)
            self._tx_seq = None

    def get_bytes(self, timeout: Optional[float] = None) -> bytes:
        sock = self._ensure("reader", timeout)
        sock.settimeout(timeout)
        try:
            while True:
                while len(self._rx) < _HDR:
                    self._recv_into(sock, 65536)
                size, seq = struct.unpack_from("<QQ", self._rx)
                total = _HDR + size
                while len(self._rx) < total:
                    self._recv_into(
                        sock, min(total - len(self._rx), 1 << 20)
                    )
                payload = bytes(self._rx[_HDR:total])
                del self._rx[:total]
                if seq == self._rx_next_seq:
                    self._rx_next_seq = seq + 1
                    return payload
                if seq < self._rx_next_seq:
                    # Duplicate of a delivered record (writer-side
                    # dedup failed us): drop it — end-to-end exactly-
                    # once beats trusting the peer.
                    continue
                # A gap means records were lost or the peer desynced;
                # no read can ever succeed again — fail loudly rather
                # than hand the caller out-of-order results.
                raise RuntimeError(
                    f"{self.name}: sequence gap (expected "
                    f"{self._rx_next_seq}, got {seq})"
                )
        except socket.timeout:
            # _rx keeps the partial record; the retried get() resumes.
            raise ChannelTimeoutError(f"get on {self.name}") from None
        except OSError:
            raise ChannelClosedError(self.name) from None

    def _recv_into(self, sock: socket.socket, limit: int) -> None:
        chunk = sock.recv(limit)
        if not chunk:
            raise ChannelClosedError(self.name)
        self._rx += chunk

    def put(self, value: Any, timeout: Optional[float] = None, *,
            seq: Optional[int] = None) -> int:
        """Pickle + send; returns the record's seq. `seq` is the retry
        token from a previous put's ChannelTimeoutError (`err.seq`) —
        it makes the retry finish delivering THAT record instead of
        queueing a duplicate (see put_bytes)."""
        return self.put_bytes(pickle.dumps(value), timeout=timeout,
                              seq=seq)

    def get(self, timeout: Optional[float] = None) -> Any:
        return pickle.loads(self.get_bytes(timeout=timeout))

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            sock, listener = self._sock, self._listener
            self._sock = self._listener = None
        # Outside the state lock: a peer blocked in accept/recv/send
        # observes the shutdown as an OSError -> ChannelClosedError;
        # a writer polling the KV sees _closed within one poll tick.
        for s in (sock, listener):
            if s is None:
                continue
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def unlink(self) -> None:
        # Drop the rendezvous key; KV is session-scoped so a leak is
        # bounded, but compiled DAGs are created/torn down repeatedly.
        try:
            _kv_call("kv_del", ns=_KV_NS, key=self.chan_id)
        except Exception:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __reduce__(self):
        # The far side materializes a fresh endpoint of the same
        # channel; roles bind on first use.
        return (_attach, (self.chan_id, self.capacity))


def _attach(chan_id: str, capacity: int) -> "TcpChannel":
    return TcpChannel(capacity, chan_id=chan_id)
