# Copied from ray_tpu/_private/rpc.py (JAX-free): module names read ray_tpu_torch.
"""Minimal message-passing RPC over Unix-domain AND TCP sockets.

Plays the role of the reference's gRPC wrappers (reference:
src/ray/rpc/grpc_server.h, grpc_client.h, retryable_grpc_client.h):
length-prefixed authenticated pickled dict messages, a threaded server
dispatching to registered handlers, and a client with request/response
correlation, server-push subscriptions, retry with exponential backoff,
and the same fault-injection hook the reference exposes for chaos
testing (rpc_chaos.h:23-31 — `RT_testing_rpc_failure="method=count"`
drops the first `count` calls of `method`).

Addresses
---------
- Unix socket: a filesystem path (``/tmp/.../hostd.sock``) or
  ``unix:///tmp/.../hostd.sock`` — intra-host control plane.
- TCP: ``tcp://host:port`` — the cross-host (DCN) transport the
  reference runs on gRPC. A server may listen on both at once
  (``add_listener``): workers ride the Unix socket, remote daemons
  the TCP one, sharing one handler table and connection namespace.

Wire format & authentication
----------------------------
On accept, the server sends a hello
(``[8-byte length][16-byte nonce][1-byte protocol version]``); the
client verifies the version (mismatch -> clean RpcError) and both
sides derive the connection key
``HMAC(cluster_key, b"rt-conn" || nonce)``. Every subsequent frame is

    [8-byte length][32-byte HMAC-SHA256][payload]
    payload = [4-byte envelope len][protobuf Frame envelope][body]

(see wire.py / protocol.proto): the envelope carries version, method,
correlation id, and push channel in a typed protobuf schema; the body
is the pickled argument/reply dict, placed out of band so large object
chunks decode zero-copy. The HMAC is keyed by the connection key and
verified BEFORE any decoding — unauthenticated peers cannot reach the
deserializer (which is what makes a pickle body tolerable on TCP),
and a frame captured on one connection cannot be replayed on another
(different nonce). A frame that fails verification terminates the
connection. Server-side, every request is validated against its
per-method schema (wire.SCHEMAS) before dispatch. The cluster key
comes from ``auth_key`` / ``RT_AUTH_TOKEN``; daemons refuse to bind
TCP with the well-known local default (they auto-generate, see
NodeDaemon). Every message carries `_mid` (correlation id); server
replies echo it; unsolicited pushes use `_mid = -1` and a `_push`
channel name.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import pickle
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .event_stats import stats as _event_stats
from .flight_recorder import recorder as _flight
from ray_tpu_torch.devtools.lock_witness import note_blocking as _note_blocking
from .wire import (
    PROTOCOL_VERSION,
    ProtocolVersionError,
    decode_frame,
    encode_frame,  # noqa: F401 — contiguous-frame path for tests
    encode_frame_buffers,
)
from .wire import has_schema as _schema_known
from .wire import validate as _schema_validate

_LEN = struct.Struct(">Q")
_DIGEST_BYTES = 32
#: Hard per-frame cap, enforced BEFORE any payload is buffered: an
#: unauthenticated TCP peer can make the server allocate at most this
#: much per connection. Must exceed the largest legitimate frame
#: (object-transfer chunk, default 5 MiB, + KV function blobs).
_MAX_FRAME = int(os.environ.get("RT_RPC_MAX_FRAME", 1 << 28))  # 256 MiB


def default_auth_key() -> bytes:
    """Cluster auth token: RT_AUTH_TOKEN env, else a well-known local
    key — acceptable ONLY for single-host Unix-socket sessions
    (protected by session-dir file permissions). NodeDaemon refuses to
    run a TCP listener on this default: it generates a random token
    and exports it before binding (see daemon._ensure_tcp_auth)."""
    token = os.environ.get("RT_AUTH_TOKEN", "")
    return token.encode() if token else INSECURE_LOCAL_KEY


INSECURE_LOCAL_KEY = b"rt-insecure-local-session"


def _connection_key(cluster_key: bytes, nonce: bytes) -> bytes:
    return _hmac.new(
        cluster_key, b"rt-conn" + nonce, hashlib.sha256
    ).digest()


def parse_address(address: str) -> Union[Tuple[str, str], Tuple[str, str, int]]:
    """('unix', path) or ('tcp', host, port)."""
    if address.startswith("unix://"):
        return ("unix", address[len("unix://"):])
    if address.startswith("tcp://"):
        rest = address[len("tcp://"):]
        host, _, port = rest.rpartition(":")
        return ("tcp", host, int(port))
    if address.startswith("/") or os.sep in address:
        return ("unix", address)
    if ":" in address:
        host, _, port = address.rpartition(":")
        return ("tcp", host, int(port))
    raise ValueError(f"unparseable RPC address: {address!r}")


def _detect_host_ip() -> str:
    """Best-effort primary interface IP (the reference resolves node
    IPs the same way, services.py get_node_ip_address): route a UDP
    socket at a public address — no packets are sent — and read the
    chosen source address. Falls back to the hostname's address; a
    loopback result is advertised only with a loud warning since
    remote peers cannot dial it."""
    ip = None
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect(("8.8.8.8", 80))
            ip = probe.getsockname()[0]
        finally:
            probe.close()
    except OSError:
        pass
    if ip is None or ip.startswith("127."):
        try:
            ip = socket.gethostbyname(socket.gethostname())
        except OSError:
            ip = None
    if ip is None or ip.startswith("127."):
        import sys

        print(
            "[ray_tpu_torch] WARNING: could not determine a dialable host "
            "IP for a wildcard TCP bind; advertising 127.0.0.1 — "
            "remote nodes will NOT reach this daemon. Pass an "
            "explicit --listen-host / listen_host.",
            file=sys.stderr,
        )
        ip = "127.0.0.1"
    return ip


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


# ---------------------------------------------------------------------------
# chaos / fault injection
# ---------------------------------------------------------------------------

_chaos_lock = threading.Lock()  # rt: noqa[RT004] — guards test-only chaos budgets, held for a dict op
_chaos_budget: Dict[str, int] = {}


def configure_chaos(spec: str) -> None:
    """Parse "method=count,method2=count2" fault-injection spec."""
    with _chaos_lock:
        _chaos_budget.clear()
        for part in filter(None, spec.split(",")):
            method, _, count = part.partition("=")
            _chaos_budget[method.strip()] = int(count or 1)


def _chaos_should_fail(method: str) -> bool:
    with _chaos_lock:
        left = _chaos_budget.get(method, 0)
        if left > 0:
            _chaos_budget[method] = left - 1
            return True
    return False


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

_ZERO_DIGEST = b"\x00" * _DIGEST_BYTES


def _frame_mac(sock: socket.socket) -> bool:
    """Per-frame MAC policy: required on TCP (network peers), elided
    on AF_UNIX — same-host sockets are gated by session-dir file
    permissions and the connection handshake still proves key
    possession, so hashing every multi-megabyte object chunk twice
    per hop bought no security the kernel wasn't already providing
    (the reference's local gRPC plane runs plaintext for the same
    reason). The digest field stays in the layout (zero-filled) so
    framing is family-independent."""
    try:
        return sock.family != socket.AF_UNIX
    except Exception:
        return True


def send_msg(sock: socket.socket, msg: dict, key: bytes) -> None:
    buffers = encode_frame_buffers(msg)
    total = sum(len(b) for b in buffers)
    if _frame_mac(sock):
        mac = _hmac.new(key, None, hashlib.sha256)
        for buf in buffers:
            mac.update(buf)
        digest = mac.digest()
    else:
        digest = _ZERO_DIGEST
    try:
        # Scatter-gather: object-chunk payloads go from their source
        # buffer to the kernel with no user-space concatenation.
        _sendall_vectored(
            sock, [_LEN.pack(total) + digest, *buffers]
        )
    except (BrokenPipeError, ConnectionResetError, OSError) as e:
        raise ConnectionLost(str(e)) from e


def _wait_writable(sock: socket.socket, timeout: float) -> None:
    # NOT select.select: it raises ValueError for fds >= FD_SETSIZE
    # (1024) — exactly the many-connection regime the hub enables.
    import selectors as _selectors

    sel = _selectors.DefaultSelector()
    try:
        sel.register(sock, _selectors.EVENT_WRITE)
        sel.select(timeout)
    finally:
        sel.close()


def _sendall_vectored(sock: socket.socket, buffers: list) -> None:
    views = [memoryview(b).cast("B") for b in buffers if len(b)]
    while views:
        try:
            sent = sock.sendmsg(views)
        except (BlockingIOError, InterruptedError):
            # Hub-registered sockets are non-blocking; senders run on
            # ordinary threads and may wait for writability.
            _wait_writable(sock, 5.0)
            continue
        while sent > 0 and views:
            head = views[0]
            if sent >= len(head):
                sent -= len(head)
                views.pop(0)
            else:
                views[0] = head[sent:]
                sent = 0


def recv_msg(sock: socket.socket, key: bytes) -> Optional[dict]:
    header = _recv_exact(sock, _LEN.size + _DIGEST_BYTES)
    if header is None:
        return None
    (length,) = _LEN.unpack(header[: _LEN.size])
    digest = bytes(header[_LEN.size:])
    if length > _MAX_FRAME:  # enforced before buffering anything
        return None
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    if _frame_mac(sock):
        expect = _hmac.new(key, payload, hashlib.sha256).digest()
        if not _hmac.compare_digest(digest, expect):
            # Unauthenticated frame: never reaches the decoder.
            return None
    try:
        return decode_frame(payload)
    except Exception:
        # Malformed or wrong-version frame from an authenticated peer
        # (should have been caught at handshake): kill the connection.
        return None


def _recv_exact(sock: socket.socket, n: int):
    """Receive exactly n bytes into one preallocated buffer (the
    recv-append-join loop this replaces copied every chunk twice)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], min(n - got, 1 << 20))
        except (ConnectionResetError, OSError):
            return None
        if r == 0:
            return None
        got += r
    return buf


# ---------------------------------------------------------------------------
# selector hub: many sockets, one reader thread
# ---------------------------------------------------------------------------

class SelectorHub:
    """One epoll/kqueue thread multiplexing every registered RPC
    socket (reference: the asio event loop under every reference
    server, src/ray/common/asio/ — a thread per connection collapses
    at the 10k-actor scale: ~20k parked reader threads in the head +
    driver processes turn the scheduler into the bottleneck long
    before the protocol does).

    Frames are assembled incrementally per socket; complete frames go
    to the socket's `on_frame` callback ON THE HUB THREAD — callbacks
    must not block (both the server and client layers immediately
    hand off to executors / queues). EOF or socket error fires
    `on_close` once and unregisters."""

    def __init__(self, name: str = "rpc-hub"):
        import selectors

        self._selector = selectors.DefaultSelector()
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._selector.register(
            self._wake_r, selectors.EVENT_READ, None
        )
        self._lock = threading.Lock()
        self._pending_ops: List[tuple] = []
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    def register(self, sock, key, mac, on_frame, on_close) -> None:
        sock.setblocking(False)
        state = _SockState(sock, key, mac, on_frame, on_close)
        with self._lock:
            self._pending_ops.append(("add", sock, state))
        self._wake()

    def unregister(self, sock) -> None:
        with self._lock:
            self._pending_ops.append(("del", sock, None))
        self._wake()

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass

    def _apply_ops(self) -> None:
        import selectors

        with self._lock:
            ops, self._pending_ops = self._pending_ops, []
        for op, sock, state in ops:
            try:
                if op == "add":
                    try:
                        self._selector.register(
                            sock, selectors.EVENT_READ, state
                        )
                    except KeyError:
                        # fd reuse: a closed socket's entry still maps
                        # this fd (the owner closed without
                        # unregistering; epoll dropped it silently).
                        # Evict the stale entry or the NEW connection
                        # would be permanently deaf.
                        stale = self._selector.get_map().get(
                            sock.fileno()
                        )
                        if stale is not None:
                            self._selector.unregister(stale.fileobj)
                        self._selector.register(
                            sock, selectors.EVENT_READ, state
                        )
                else:
                    self._selector.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass

    def _loop(self) -> None:
        while not self._closed:
            self._apply_ops()
            try:
                events = self._selector.select(timeout=1.0)
            except OSError:
                # A registered socket was closed by its owner without
                # unregistering: the selector raises EBADF on every
                # select. Sweep out dead fds (and fire their on_close)
                # or this loop would spin forever serving nobody.
                self._sweep_dead()
                continue
            for sel_key, _ in events:
                if sel_key.fd == self._wake_r:
                    try:
                        while os.read(self._wake_r, 4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                state: _SockState = sel_key.data
                if state is not None:
                    self._service(state)

    def _sweep_dead(self) -> None:
        for sel_key in list(self._selector.get_map().values()):
            sock = sel_key.fileobj
            if sock == self._wake_r:
                continue
            dead = False
            try:
                dead = sock.fileno() < 0
            except Exception:
                dead = True
            if dead:
                try:
                    self._selector.unregister(sock)
                except (KeyError, ValueError, OSError):
                    pass
                state = sel_key.data
                if state is not None and not state.closed:
                    state.closed = True
                    try:
                        state.on_close()
                    except Exception:
                        pass

    def _service(self, state: "_SockState") -> None:
        closed = False
        try:
            while True:
                chunk = state.sock.recv(1 << 20)
                if not chunk:
                    closed = True
                    break
                state.buf += chunk
                # Over-greedy reads starve other sockets; parse what
                # we have and come back on the next readiness event.
                if len(state.buf) >= (16 << 20):
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            closed = True
        self._drain_frames(state)
        if closed:
            try:
                self._selector.unregister(state.sock)
            except (KeyError, ValueError, OSError):
                pass
            if not state.closed:
                state.closed = True
                try:
                    state.on_close()
                except Exception:
                    pass

    def _kill(self, state: "_SockState") -> None:
        state.buf = bytearray()
        try:
            self._selector.unregister(state.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            state.sock.close()
        except OSError:
            pass
        if not state.closed:
            state.closed = True
            try:
                state.on_close()
            except Exception:
                pass

    def _drain_frames(self, state: "_SockState") -> None:
        header_len = _LEN.size + _DIGEST_BYTES
        buf = state.buf
        offset = 0  # consume via offset; reslicing per frame is O(n^2)
        try:
            while True:
                if len(buf) - offset < header_len:
                    return
                (length,) = _LEN.unpack_from(buf, offset)
                if length > _MAX_FRAME:
                    offset = 0
                    self._kill(state)  # poisoned peer: drop it
                    return
                total = header_len + length
                if len(buf) - offset < total:
                    return
                digest = bytes(
                    buf[offset + _LEN.size:offset + header_len]
                )
                payload = bytes(
                    buf[offset + header_len:offset + total]
                )
                offset += total
                if state.mac:
                    expect = _hmac.new(
                        state.key, payload, hashlib.sha256
                    ).digest()
                    if not _hmac.compare_digest(digest, expect):
                        # Unauthenticated frame: terminate the
                        # connection (module-docstring invariant;
                        # matches recv_msg).
                        offset = 0
                        self._kill(state)
                        return
                try:
                    msg = decode_frame(payload)
                except Exception:
                    offset = 0
                    self._kill(state)
                    return
                if msg is None:
                    continue
                try:
                    state.on_frame(msg)
                except Exception:
                    pass
        finally:
            if offset and state.buf is buf:
                del buf[:offset]  # single compaction per drain

    def close(self) -> None:
        self._closed = True
        self._wake()


class _SockState:
    __slots__ = ("sock", "key", "mac", "on_frame", "on_close", "buf",
                 "closed")

    def __init__(self, sock, key, mac, on_frame, on_close):
        self.sock = sock
        self.key = key
        self.mac = mac
        self.on_frame = on_frame
        self.on_close = on_close
        self.buf = bytearray()
        self.closed = False


_hub_lock = threading.Lock()  # rt: noqa[RT004] — the hub it guards is created lazily per process, post-fork
_process_hub: Optional[SelectorHub] = None
_client_pool = None


def _reset_rpc_globals_after_fork() -> None:
    """Forked children inherit the hub/pool OBJECTS but not their
    threads; reset so the child lazily builds fresh ones."""
    global _process_hub, _client_pool
    _process_hub = None
    _client_pool = None


os.register_at_fork(after_in_child=_reset_rpc_globals_after_fork)


def _client_executor():
    """Shared pool draining client-side pushes/async callbacks (they
    may block; the hub thread must not)."""
    global _client_pool
    with _hub_lock:
        if _client_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _client_pool = ThreadPoolExecutor(
                max_workers=int(
                    os.environ.get("RT_RPC_CLIENT_POOL_THREADS", "8")
                ),
                thread_name_prefix="rpc-client-pool",
            )
        return _client_pool


def process_hub() -> SelectorHub:
    """Process-wide hub shared by every RpcClient and RpcServer in
    this process (daemons, drivers, and workers alike)."""
    global _process_hub
    with _hub_lock:
        if _process_hub is None or _process_hub._closed:
            _process_hub = SelectorHub()
        # Forked children inherit the parent's hub OBJECT but not its
        # thread: detect and rebuild (worker fork-server children).
        if not _process_hub._thread.is_alive():
            _process_hub = SelectorHub()
        return _process_hub


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class RpcServer:
    """Threaded socket server dispatching named methods over any mix
    of Unix-domain and TCP listeners (reference: one gRPC server
    serving NodeManagerService on a port, grpc_server.h).

    Handlers run on per-connection reader threads; a handler may reply
    synchronously (return a dict) or later via the provided
    `Connection.push` / deferred reply handle.
    """

    def __init__(self, address: str, auth_key: Optional[bytes] = None):
        self.auth_key = auth_key or default_auth_key()
        self._handlers: Dict[str, Callable] = {}
        #: Methods whose handlers run INLINE on the hub thread instead
        #: of hopping through the connection queue + executor pool.
        #: Only for handlers that never block (a queue.put): the task
        #: hot path pays one thread wakeup, not two. Inline frames
        #: preserve arrival order with each other; a connection mixing
        #: inline and pooled methods loses cross-kind ordering, so
        #: only register methods whose senders don't rely on it.
        self._inline_handlers: Dict[str, Callable] = {}
        self._connections: Dict[int, "Connection"] = {}
        self._conn_counter = 0
        self._lock = threading.Lock()
        self._closed = False
        self._started = False
        self._listeners: List[tuple] = []  # (sock, canonical_addr)
        self._unix_paths: List[str] = []
        self._accept_threads: List[threading.Thread] = []
        self.address = self.add_listener(address)

    def add_listener(
        self, address: str, advertise_host: Optional[str] = None
    ) -> str:
        """Bind an additional address; returns its canonical form
        (ephemeral port resolved, wildcard bind host replaced by an
        address other hosts can actually dial)."""
        parsed = parse_address(address)
        if parsed[0] == "unix":
            path = parsed[1]
            if os.path.exists(path):
                os.unlink(path)
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            # The kernel's file permissions ARE the auth layer on
            # unix sockets (per-frame MACs are TCP-only, see
            # _frame_mac): owner-only on both the socket and its
            # directory, independent of the process umask.
            old_umask = os.umask(0o077)
            try:
                sock.bind(path)
            finally:
                os.umask(old_umask)
            try:
                os.chmod(path, 0o600)
                os.chmod(os.path.dirname(path) or ".", 0o700)
            except OSError:
                pass
            canonical = path
            self._unix_paths.append(path)
        else:
            _, host, port = parsed
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host or "0.0.0.0", port))
            bound_port = sock.getsockname()[1]
            adv = advertise_host or host
            if not adv or adv in ("0.0.0.0", "::"):
                # Wildcard binds must advertise a dialable address.
                adv = _detect_host_ip()
            canonical = f"tcp://{adv}:{bound_port}"
        sock.listen(128)
        self._listeners.append((sock, canonical))
        thread = threading.Thread(
            target=self._accept_loop,
            args=(sock,),
            name=f"rpc-accept:{canonical}",
            daemon=True,
        )
        self._accept_threads.append(thread)
        if self._started:
            thread.start()  # server already running: serve immediately
        return canonical

    def register(
        self, method: str, handler: Callable, inline: bool = False
    ) -> None:
        self._handlers[method] = handler
        if inline:
            self._inline_handlers[method] = handler

    def start(self) -> None:
        self._started = True
        for thread in self._accept_threads:
            if not thread.is_alive():
                thread.start()

    def _accept_loop(self, listener: socket.socket) -> None:
        while not self._closed:
            try:
                sock, _ = listener.accept()
            except OSError:
                return
            with self._lock:
                self._conn_counter += 1
                conn = Connection(self, sock, self._conn_counter)
                self._connections[conn.conn_id] = conn
            # Handshake + hub registration; no thread per connection
            # (SelectorHub reads all of them, handlers run on the
            # server's bounded pool with per-connection ordering).
            conn.start()

    def _get_executor(self):
        with self._lock:
            if getattr(self, "_executor", None) is None:
                from concurrent.futures import ThreadPoolExecutor

                self._executor = ThreadPoolExecutor(
                    max_workers=int(
                        os.environ.get("RT_RPC_POOL_THREADS", "32")
                    ),
                    thread_name_prefix="rpc-pool",
                )
            return self._executor

    def _dispatch(
        self, conn: "Connection", msg: dict, t_enq: float = 0.0
    ) -> None:
        method = msg.get("_method", "")
        mid = msg.get("_mid")
        handler = self._handlers.get(method)
        if handler is None:
            if mid:
                conn.reply(mid, {"_error": f"no such method: {method}"})
            return
        t_start = time.monotonic()
        queue_s = (t_start - t_enq) if t_enq else 0.0
        if not _schema_known(method) and method not in _schemaless_warned:
            # Once per process per method: a served-but-unschema'd
            # method skips typed validation entirely — always a
            # framework bug (wire.SCHEMAS describes our own plane),
            # caught statically by `ray_tpu_torch check` RT104 but made
            # loud here too for out-of-tree handlers.
            _schemaless_warned.add(method)
            import sys as _sys

            print(
                f"[rpc] method {method!r} is served without a "
                "wire.SCHEMAS entry; arguments are not validated "
                "(add a schema — see ray_tpu_torch check RT104)",
                file=_sys.stderr,
            )
        # Typed argument validation (wire.SCHEMAS): malformed frames
        # get a clean schema error instead of a KeyError mid-handler.
        schema_err = _schema_validate(method, msg)
        if schema_err is not None:
            if mid:
                conn.reply(
                    mid, {"_error": f"schema violation: {schema_err}"}
                )
            else:
                # A dropped NOTIFY is invisible to the sender — always
                # a framework bug (schemas describe our own senders),
                # so make it loud instead of wedging silently.
                import sys as _sys

                print(
                    f"[rpc] dropping notify with schema violation: "
                    f"{schema_err}",
                    file=_sys.stderr,
                )
            return
        try:
            result = handler(conn, msg)
        except Exception as e:  # noqa: BLE001 — errors propagate to caller
            import traceback

            exec_s = time.monotonic() - t_start
            _event_stats().record(method, queue_s, exec_s, error=True)
            _flight().record(
                "rpc.server",
                method,
                exec_s * 1e3,
                {"queue_ms": round(queue_s * 1e3, 3), "error": True},
            )
            if mid:
                conn.reply(
                    mid, {"_error": f"{e}\n{traceback.format_exc()}"}
                )
            return
        exec_s = time.monotonic() - t_start
        _event_stats().record(method, queue_s, exec_s)
        _flight().record(
            "rpc.server",
            method,
            exec_s * 1e3,
            {"queue_ms": round(queue_s * 1e3, 3)} if queue_s else None,
        )
        if result is not DEFERRED and mid:
            conn.reply(mid, result or {})

    def _on_disconnect(self, conn: "Connection") -> None:
        with self._lock:
            self._connections.pop(conn.conn_id, None)
        handler = self._handlers.get("_disconnect")
        if handler is not None:
            try:
                handler(conn, {})
            except Exception:
                pass

    def connections(self) -> list:
        with self._lock:
            return list(self._connections.values())

    def close(self) -> None:
        self._closed = True
        for sock, _ in self._listeners:
            # shutdown() first: close() alone does not release a
            # listening port while an accept thread is blocked on it
            # (the in-flight accept pins the open file description, so
            # the port stays in LISTEN and a restarted server cannot
            # rebind it).
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for thread in self._accept_threads:
            if thread.is_alive() and thread is not threading.current_thread():
                thread.join(timeout=1.0)
        for conn in self.connections():
            conn.close()
        for path in self._unix_paths:
            if os.path.exists(path):
                try:
                    os.unlink(path)
                except OSError:
                    pass


#: Sentinel a handler returns to indicate it will reply later via
#: `Connection.reply(mid, ...)` (used for blocking ops like object gets).
DEFERRED = object()

#: Methods already warned about for missing wire schemas (once per
#: process; set.add is GIL-atomic, a duplicate warning on a race is
#: harmless).
_schemaless_warned: set = set()


class Connection:
    """Server-side view of one client connection.

    Frames arrive via the process SelectorHub; handlers run on the
    server's bounded pool with PER-CONNECTION ordering (one drain task
    at a time walks this connection's queue) — the property the
    protocol relies on (e.g. a create_actor notify is processed before
    the same driver's first method submit)."""

    _DISCONNECT = object()

    def __init__(self, server: RpcServer, sock: socket.socket, conn_id: int):
        self._server = server
        self._sock = sock
        self.conn_id = conn_id
        self._send_lock = threading.Lock()
        self._key = server.auth_key  # replaced by the conn key in start
        self.metadata: Dict[str, Any] = {}  # e.g. worker id after register
        self._queue: deque = deque()
        self._queue_lock = threading.Lock()
        self._draining = False

    def start(self) -> None:
        # Nonce handshake: frames on this connection are keyed by
        # HMAC(cluster_key, nonce), so a frame recorded on another
        # connection can't be replayed here. The trailing byte carries
        # the protocol version (reference: versioned proto schemas) —
        # mismatched peers fail at connect with a clear error.
        nonce = os.urandom(16)
        hello = nonce + bytes([PROTOCOL_VERSION])
        try:
            with self._send_lock:
                self._sock.sendall(_LEN.pack(len(hello)) + hello)
        except OSError:
            self._server._on_disconnect(self)
            return
        self._key = _connection_key(self._server.auth_key, nonce)
        process_hub().register(
            self._sock,
            self._key,
            _frame_mac(self._sock),
            self._on_frame,
            self._on_close,
        )

    # -- hub callbacks (hub thread: enqueue only, never block) --------
    def _on_frame(self, msg: dict) -> None:
        method = msg.get("_method", "")
        inline = self._server._inline_handlers.get(method)
        if inline is not None:
            # Hot path (e.g. execute_tasks -> task_queue.put): the
            # handler is non-blocking by contract, so it runs right
            # here and the frame skips the queue + pool wakeup. Runs
            # AHEAD of any still-queued pooled frames — inline methods
            # are registered only where that reordering is harmless.
            # Telemetry parity with _dispatch: the hottest RPC in the
            # system must not vanish from event stats / the flight
            # recorder just because it dispatches inline.
            err = _schema_validate(method, msg)
            mid = msg.get("_mid")
            if err is not None:
                if mid:
                    self.reply(mid, {"_error": f"schema violation: {err}"})
                return
            t0 = time.monotonic()
            try:
                result = inline(self, msg)
            except Exception as e:  # noqa: BLE001 — to caller
                import traceback

                exec_s = time.monotonic() - t0
                _event_stats().record(method, 0.0, exec_s, error=True)
                _flight().record(
                    "rpc.server", method, exec_s * 1e3, {"error": True}
                )
                if mid:
                    self.reply(
                        mid,
                        {"_error": f"{e}\n{traceback.format_exc()}"},
                    )
                return
            exec_s = time.monotonic() - t0
            _event_stats().record(method, 0.0, exec_s)
            _flight().record("rpc.server", method, exec_s * 1e3)
            if result is not DEFERRED and mid:
                self.reply(mid, result or {})
            return
        self._enqueue(msg)

    def _on_close(self) -> None:
        # Rides the same ordered queue so the disconnect handler runs
        # AFTER every frame that arrived before EOF.
        self._enqueue(self._DISCONNECT)

    def _enqueue(self, item) -> None:
        # The enqueue timestamp feeds per-handler queueing-delay stats
        # (event_stats.py — the asio loop-lag analog).
        with self._queue_lock:
            self._queue.append((item, time.monotonic()))
            if self._draining:
                return
            self._draining = True
        self._server._get_executor().submit(self._drain)

    def _drain(self) -> None:
        while True:
            with self._queue_lock:
                if not self._queue:
                    self._draining = False
                    return
                item, t_enq = self._queue.popleft()
            if item is self._DISCONNECT:
                self._server._on_disconnect(self)
                continue
            try:
                self._server._dispatch(self, item, t_enq)
            except Exception:
                pass

    def reply(self, mid, payload: dict) -> None:
        payload = dict(payload)
        payload["_mid"] = mid
        with self._send_lock:
            try:
                send_msg(self._sock, payload, self._key)
            except ConnectionLost:
                pass

    def push(self, channel: str, payload: dict) -> None:
        payload = dict(payload)
        payload["_mid"] = -1
        payload["_push"] = channel
        with self._send_lock:
            try:
                send_msg(self._sock, payload, self._key)
            except ConnectionLost:
                pass

    def close(self) -> None:
        try:
            process_hub().unregister(self._sock)
        except Exception:
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class RpcClient:
    """Thread-safe client with correlation ids, pushes, and retries."""

    def __init__(
        self,
        path: str,
        push_handler: Optional[Callable[[str, dict], None]] = None,
        connect_timeout: float = 10.0,
        auth_key: Optional[bytes] = None,
        on_reconnect: Optional[Callable[[], None]] = None,
    ):
        self._path = path
        self._parsed = parse_address(path)
        self.auth_key = auth_key or default_auth_key()
        self._push_handler = push_handler
        #: Called (on the reconnecting thread, outside locks) after a
        #: successful reconnect — the server saw a brand-new connection,
        #: so per-connection server state (e.g. log subscriptions) must
        #: be re-established by the client.
        self._on_reconnect = on_reconnect
        self._mid = 0
        self._lock = threading.Lock()
        # Serializes whole frames: call()/notify() run on arbitrary
        # threads (ObjectRef.__del__ fires on GC threads) and an
        # interleaved sendall would corrupt the length-prefixed wire.
        # Also guards the (sock, conn_key) pair so a sender never mixes
        # one connection's socket with another's key.
        self._send_lock = threading.Lock()
        self._reconnect_lock = threading.Lock()
        self._pending: Dict[int, threading.Event] = {}
        #: mid -> callback for async calls (call_async); invoked on the
        #: reader thread with the reply dict, or with
        #: {"_error": "__connection_lost__"} if the connection dies.
        self._pending_cb: Dict[int, Callable[[dict], None]] = {}
        #: mid -> connection generation the request was SENT on (absent
        #: until the send completes). Reconnect only fails mids sent on
        #: an older generation; a request that slipped onto the new
        #: socket (or hasn't been sent yet) must not be flushed.
        self._pending_gen: Dict[int, int] = {}
        self._replies: Dict[int, dict] = {}
        self._closed = False
        #: Bumped on every (re)connect; stale reader threads check it
        #: before flushing waiters so a dead connection's teardown can't
        #: fail calls issued on its replacement.
        self._conn_gen = 0
        sock, key = self._connect(connect_timeout)
        #: Per-connection frame key, derived from the server's nonce in
        #: _connect (mirrors Connection.serve). Replaced on _reconnect.
        self._sock, self._conn_key = sock, key
        self._start_reader(sock, key, self._conn_gen)

    def set_on_reconnect(self, cb: Optional[Callable[[], None]]) -> None:
        self._on_reconnect = cb

    def _start_reader(self, sock, key, gen) -> None:
        """Register with the process SelectorHub (one epoll thread for
        every client in the process — a thread per client collapses at
        the 10k-direct-connection scale). Sync replies resolve inline
        on the hub thread (event.set, non-blocking); pushes and async
        callbacks drain through a per-client ORDERED queue on the
        shared client pool, preserving the old single-reader-thread
        ordering for a connection's pushes."""
        process_hub().register(
            sock,
            key,
            _frame_mac(sock),
            lambda msg: self._hub_frame(msg, gen),
            lambda: self._hub_closed(gen),
        )

    def _hub_frame(self, msg: dict, gen: int) -> None:
        mid = msg.get("_mid")
        if mid == -1:
            if self._push_handler is not None:
                self._enqueue_work(("push", msg))
            return
        partial = msg.get("_part")
        with self._lock:
            event = self._pending.pop(mid, None)
            if event is not None:
                self._replies[mid] = msg
            if partial:
                # Streamed partial reply (execute_tasks outcome
                # parts): the callback stays registered until the
                # final frame so it fires once per part.
                entry = self._pending_cb.get(mid)
            else:
                entry = self._pending_cb.pop(mid, None)
                if entry is not None:
                    self._pending_gen.pop(mid, None)
        if event is not None:
            event.set()
        if entry is not None:
            callback, inline = entry
            if inline:
                # Caller opted into hub-thread delivery (call_async
                # inline=True): the reply is handled with zero thread
                # hops. The callback must be near-non-blocking — the
                # batch submit path's window bounds any send it makes
                # to buffers the peer is actively draining.
                try:
                    callback(msg)
                except Exception:
                    pass
            else:
                self._enqueue_work(("cb", callback, msg))

    def _hub_closed(self, gen: int) -> None:
        # Connection lost: wake all waiters with an error — but only
        # if this registration still owns the live connection; a stale
        # socket's teardown must not fail calls issued on its
        # replacement.
        with self._lock:
            if gen != self._conn_gen:
                return
            for mid, event in self._pending.items():
                self._replies[mid] = {"_error": "__connection_lost__"}
                event.set()
            self._pending.clear()
            self._pending_gen.clear()
            callbacks = [cb for cb, _inline in self._pending_cb.values()]
            self._pending_cb.clear()
        for callback in callbacks:
            self._enqueue_work(
                ("cb", callback, {"_error": "__connection_lost__"})
            )

    def _enqueue_work(self, item) -> None:
        with self._lock:
            queue = getattr(self, "_work_queue", None)
            if queue is None:
                queue = self._work_queue = deque()
                self._work_draining = False
            queue.append(item)
            if self._work_draining:
                return
            self._work_draining = True
        _client_executor().submit(self._drain_work)

    def _drain_work(self) -> None:
        while True:
            with self._lock:
                if not self._work_queue:
                    self._work_draining = False
                    return
                item = self._work_queue.popleft()
            try:
                if item[0] == "push":
                    self._push_handler(item[1].get("_push", ""), item[1])
                else:
                    item[1](item[2])
            except Exception:
                pass

    def _connect(self, timeout: float) -> Tuple[socket.socket, bytes]:
        deadline = time.time() + timeout
        last_err: Exception | None = None
        while time.time() < deadline:
            if self._parsed[0] == "unix":
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                target: Any = self._parsed[1]
            else:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
                target = (self._parsed[1], self._parsed[2])
            try:
                sock.connect(target)
                # Client half of the nonce handshake (see module
                # docstring / Connection.serve): read [8-byte len]
                # [16-byte nonce][1-byte protocol version], verify the
                # version, and key every subsequent frame on this
                # socket with HMAC(cluster_key, "rt-conn"||nonce).
                prev_timeout = sock.gettimeout()
                sock.settimeout(max(deadline - time.time(), 1.0))
                header = _recv_exact(sock, _LEN.size)
                if header is None:
                    raise ConnectionResetError("no nonce from server")
                (nlen,) = _LEN.unpack(header)
                if nlen < 17 or nlen > 64:
                    raise ConnectionResetError(
                        f"bad hello length {nlen} from server "
                        "(pre-versioning peer?)"
                    )
                hello = _recv_exact(sock, nlen)
                if hello is None:
                    raise ConnectionResetError("truncated hello")
                nonce, version = hello[:16], hello[16]
                if version != PROTOCOL_VERSION:
                    sock.close()
                    # RpcError (not the wire-level ProtocolVersionError)
                    # so every existing `except RpcError` boundary in
                    # the daemons handles the mismatch cleanly instead
                    # of dying on an unexpected exception type; the
                    # non-OSError type also breaks out of the connect
                    # retry loop immediately.
                    raise RpcError(
                        f"protocol version mismatch: server speaks "
                        f"v{version}, this client speaks "
                        f"v{PROTOCOL_VERSION}"
                    )
                sock.settimeout(prev_timeout)
                return sock, _connection_key(self.auth_key, nonce)
            except (
                FileNotFoundError,
                ConnectionRefusedError,
                ConnectionResetError,
                TimeoutError,
                OSError,
            ) as e:
                last_err = e
                sock.close()
                time.sleep(0.05)
        raise ConnectionLost(f"cannot connect to {self._path}: {last_err}")

    def call(
        self,
        method: str,
        timeout: Optional[float] = None,
        retries: int = 0,
        **kwargs,
    ) -> dict:
        """Synchronous call; raises RpcError on handler error."""
        attempt = 0
        backoff = 0.1
        while True:
            with self._lock:
                seen_gen = self._conn_gen
            if _chaos_should_fail(method):
                reply = {"_error": "__chaos_injected_failure__"}
            else:
                reply = self._call_once(method, timeout, kwargs)
            err = reply.get("_error")
            if err is None:
                return reply
            if attempt < retries and err in (
                "__chaos_injected_failure__",
                "__connection_lost__",
                "__timeout__",
            ):
                attempt += 1
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
                if err == "__connection_lost__":
                    self._reconnect(seen_gen)
                continue
            raise RpcError(f"{method}: {err}")

    def _call_once(self, method, timeout, kwargs) -> dict:
        # Dynamic RT203: convict any caller that reaches a synchronous
        # RPC while holding a witness-instrumented lock (one module-
        # global read when the witness is off).
        _note_blocking(f"rpc.call:{method}")
        rec = _flight()
        if rec.enabled:
            t0 = time.monotonic()
            reply = self._call_once_inner(method, timeout, kwargs)
            err = reply.get("_error")
            rec.record(
                "rpc.client",
                method,
                (time.monotonic() - t0) * 1e3,
                {"error": True} if err is not None else None,
            )
            return reply
        return self._call_once_inner(method, timeout, kwargs)

    def _call_once_inner(self, method, timeout, kwargs) -> dict:
        with self._lock:
            if self._closed:
                return {"_error": "__connection_lost__"}
            self._mid += 1
            mid = self._mid
            event = threading.Event()
            self._pending[mid] = event
        msg = dict(kwargs)
        msg["_method"] = method
        msg["_mid"] = mid
        try:
            with self._send_lock:
                send_msg(self._sock, msg, self._conn_key)
                with self._lock:  # lock order: _send_lock then _lock
                    if mid in self._pending:
                        self._pending_gen[mid] = self._conn_gen
        except ConnectionLost:
            with self._lock:
                self._pending.pop(mid, None)
                self._pending_gen.pop(mid, None)
            return {"_error": "__connection_lost__"}
        if not event.wait(timeout=timeout):
            with self._lock:
                self._pending.pop(mid, None)
                self._pending_gen.pop(mid, None)
                # The reader may have raced the timeout and already
                # moved the reply into _replies; drop it or it leaks.
                self._replies.pop(mid, None)
            return {"_error": "__timeout__"}
        with self._lock:
            self._pending_gen.pop(mid, None)
            return self._replies.pop(mid)

    def call_async(
        self,
        method: str,
        callback: Callable[[dict], None],
        inline: bool = False,
        **kwargs,
    ) -> None:
        """Fire a request and invoke `callback(reply)` on the reader
        thread when the response arrives (or with
        ``{"_error": "__connection_lost__"}`` on connection loss). The
        hot path of the direct task transport: no per-call thread
        handoff on the send side. ``inline=True`` additionally invokes
        the callback straight on the hub thread (zero handoffs on the
        reply side) — only for near-non-blocking callbacks."""
        if _chaos_should_fail(method):
            # Same contract as a send failure: the callback fires
            # synchronously on the caller's thread (callers already
            # handle that for the closed-client path).
            callback({"_error": "__chaos_injected_failure__"})
            return
        rec = _flight()
        if rec.enabled:
            t0 = time.monotonic()
            inner = callback

            def callback(reply, _inner=inner, _t0=t0):  # noqa: F811
                rec.record(
                    "rpc.client",
                    method,
                    (time.monotonic() - _t0) * 1e3,
                    {"error": True}
                    if reply.get("_error") is not None
                    else None,
                )
                _inner(reply)
        with self._lock:
            if self._closed:
                callback({"_error": "__connection_lost__"})
                return
            self._mid += 1
            mid = self._mid
            self._pending_cb[mid] = (callback, inline)
        msg = dict(kwargs)
        msg["_method"] = method
        msg["_mid"] = mid
        try:
            with self._send_lock:
                send_msg(self._sock, msg, self._conn_key)
                with self._lock:
                    if mid in self._pending_cb:
                        self._pending_gen[mid] = self._conn_gen
        except ConnectionLost:
            with self._lock:
                dead = self._pending_cb.pop(mid, None)
                self._pending_gen.pop(mid, None)
            if dead is not None:
                dead[0]({"_error": "__connection_lost__"})

    def notify(self, method: str, **kwargs) -> None:
        """Fire-and-forget message (no reply expected)."""
        msg = dict(kwargs)
        msg["_method"] = method
        msg["_mid"] = 0
        try:
            with self._send_lock:
                send_msg(self._sock, msg, self._conn_key)
        except ConnectionLost:
            pass

    def _reconnect(self, seen_gen: Optional[int] = None) -> None:
        """Replace the connection. `seen_gen` is the generation the
        caller observed failing; if another thread already reconnected
        past it, this is a no-op (two racing retries produce one new
        connection, not two)."""
        reconnected = False
        with self._reconnect_lock:
            with self._lock:
                if self._closed:
                    return
                if seen_gen is not None and self._conn_gen != seen_gen:
                    return  # somebody else already reconnected
            # Unregister BEFORE close: epoll forgets a closed fd
            # silently, but the selectors bookkeeping would keep the
            # stale entry and make the replacement socket (which
            # typically reuses the same fd) fail to register.
            try:
                process_hub().unregister(self._sock)
            except Exception:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            sock, key = self._connect(10.0)  # rt: noqa[RT203] — _reconnect_lock intentionally serializes reconnect attempts, backoff included
            # Swap + generation bump + flush as one atomic step under
            # _send_lock: senders record their send generation while
            # holding it, so nothing can send during the swap and every
            # pending mid has an accurate generation tag.
            with self._send_lock:
                with self._lock:
                    if self._closed:  # close() raced the reconnect
                        try:
                            sock.close()
                        except OSError:
                            pass
                        return
                    self._sock, self._conn_key = sock, key
                    self._conn_gen += 1
                    gen = self._conn_gen
                    # Fail calls sent on a dead connection — they can
                    # never be answered here. Unsent/new-gen mids stay.
                    stale = [
                        mid for mid, g in self._pending_gen.items()
                        if g < gen and mid in self._pending
                    ]
                    for mid in stale:
                        event = self._pending.pop(mid)
                        self._pending_gen.pop(mid, None)
                        self._replies[mid] = {
                            "_error": "__connection_lost__"
                        }
                        event.set()
                    # Same for async-callback requests: their promised
                    # connection_lost error must fire or the caller's
                    # in-flight accounting wedges.
                    stale_cbs = []
                    for mid, g in list(self._pending_gen.items()):
                        if g < gen and mid in self._pending_cb:
                            stale_cbs.append(self._pending_cb.pop(mid)[0])
                            self._pending_gen.pop(mid, None)
            for cb in stale_cbs:
                try:
                    cb({"_error": "__connection_lost__"})
                except Exception:
                    pass
            self._start_reader(sock, key, gen)
            reconnected = True
        # Outside _reconnect_lock: a callback that triggers another
        # reconnect (its call() hits a dying fresh connection) must not
        # self-deadlock on the non-reentrant lock.
        if reconnected and self._on_reconnect is not None:
            try:
                self._on_reconnect()
            except Exception:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            process_hub().unregister(self._sock)
        except Exception:
            pass
        # Unregistering suppresses the hub's on_close, so flush
        # blocked call(timeout=None) waiters here — the removed
        # per-client reader thread used to do this when its recv
        # failed.
        try:
            self._hub_closed(self._conn_gen)
        except Exception:
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
