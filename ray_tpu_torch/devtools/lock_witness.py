# Copied from ray_tpu/devtools/lock_witness.py (JAX-free): module names read ray_tpu_torch.
"""Runtime lock-order witness: dynamic evidence for RT202/RT203.

The static pass (`devtools/concurrency.py`) reasons about lock order
from source; this module records what a live process ACTUALLY does.
Hot-path locks are created through :func:`make_lock` — when the
witness is enabled (``RT_lock_witness_enabled=1`` in the environment,
or config ``lock_witness_enabled`` via :func:`configure`), the factory
returns an instrumented wrapper that feeds a per-process
:class:`LockWitness`:

* every *first* sighting of "B acquired while A held" records the
  directed edge A→B with the acquiring stack (bounded by
  ``lock_witness_max_edges``; later sightings just count);
* :func:`note_blocking` (hooked in the RPC client) records
  held-while-blocking events — the dynamic RT203;
* the edge graph is cycle-checked on demand (:meth:`LockWitness.
  cycles`), at process exit (stderr warning), and by ``rt.diagnose()``
  — each daemon/worker answers the ``lock_witness`` RPC with its
  snapshot and the doctor folds inversions into ``verdict.locks``.

When the witness is DISABLED, :func:`make_lock` returns a **raw**
``threading.Lock``/``RLock`` — the wrapper is not installed at all, so
the off cost is exactly zero (no runtime branch on the acquire path).
Consequently the switch must be set before the process creates its
locks: flipping the env var on a live process only affects locks
created afterwards.

Lock *names* identify lock roles, not instances: every ``_KeyState``
lock shares one name, so order edges between instances of the same
role merge. Name locks per-instance only when nesting two instances
of the same role is legal (it is not, anywhere in this tree).

Events also land in the flight recorder (kinds ``lock.order``,
``lock.block``, and the pre-existing ``lock.wait``) so ring pulls see
them alongside RPC/task telemetry. The recorder's own ring append is
lock-free, so recording cannot re-enter the witness.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "make_lock",
    "note_blocking",
    "enabled",
    "install",
    "uninstall",
    "configure",
    "snapshot",
    "witness",
    "LockWitness",
]

_ENV_FLAG = "RT_lock_witness_enabled"
_ENV_MAX_EDGES = "RT_lock_witness_max_edges"

#: The installed witness, or None when disabled. `make_lock` consults
#: this ONCE at lock creation — the off path hands out raw locks.
_WITNESS: Optional["LockWitness"] = None
_env_checked = False
_fork_hook_registered = False


def _truthy(raw: str) -> bool:
    return raw.lower() in ("1", "true", "yes")


class LockWitness:
    """Per-process lock-order graph + held-while-blocking ledger."""

    def __init__(self, max_edges: int = 4096):
        self.max_edges = int(max_edges)
        self._tl = threading.local()
        # Guards the tables below. Deliberately a RAW lock: wrapping
        # it would recurse into on_acquired forever.
        self._mu = threading.Lock()
        #: (held, acquired) -> {"count", "stack"} — stack captured at
        #: first sighting only (format_stack is far too hot otherwise).
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.dropped_edges = 0
        #: (innermost held lock, op) -> {"count", "stack"}.
        self.blocked: Dict[Tuple[str, str], dict] = {}

    # -- hot path --------------------------------------------------------

    def _held(self) -> List[str]:
        held = getattr(self._tl, "held", None)
        if held is None:
            held = self._tl.held = []
        return held

    def _stack(self) -> str:
        # Drop the two witness-internal frames; keep the caller chain.
        return "".join(traceback.format_stack(limit=16)[:-2])

    def on_acquired(self, name: str, wait_s: float) -> None:
        held = self._held()
        new_edges = []
        for other in held:
            if other != name and (other, name) not in self.edges:
                new_edges.append((other, name))
        if new_edges or held:
            with self._mu:
                for key in new_edges:
                    if key in self.edges:
                        continue
                    if len(self.edges) >= self.max_edges:
                        self.dropped_edges += 1
                        continue
                    self.edges[key] = {"count": 0, "stack": self._stack()}
                for other in held:
                    edge = self.edges.get((other, name))
                    if edge is not None:
                        edge["count"] += 1
        held.append(name)
        if new_edges:
            from ray_tpu_torch._private.flight_recorder import record

            for a, b in new_edges:
                record("lock.order", f"{a}->{b}", wait_s * 1e3)
        if wait_s >= 0.001:
            from ray_tpu_torch._private.flight_recorder import record

            record("lock.wait", name, wait_s * 1e3)

    def on_released(self, name: str) -> None:
        held = self._held()
        # Innermost matching entry: RLock re-entry pops symmetrically.
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def note_blocking(self, op: str) -> None:
        held = self._held()
        if not held:
            return
        key = (held[-1], op)
        with self._mu:
            entry = self.blocked.get(key)
            if entry is None:
                self.blocked[key] = {"count": 1, "stack": self._stack()}
            else:
                entry["count"] += 1
                return
        from ray_tpu_torch._private.flight_recorder import record

        record("lock.block", f"{key[0]}|{op}", 0.0)

    # -- cold path -------------------------------------------------------

    def cycles(self) -> List[List[dict]]:
        """Cycles in the recorded order graph, each as a list of edge
        dicts ``{"from", "to", "count", "stack"}`` — both sides of an
        inversion arrive with the stack that created the edge."""
        with self._mu:
            edges = {k: dict(v) for k, v in self.edges.items()}
        adj: Dict[str, List[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)
        found: List[List[dict]] = []
        seen: set = set()
        for a, b in sorted(edges):
            stack = [(b, [b])]
            while stack:
                node, path = stack.pop()
                if len(path) > 6:
                    continue
                for nxt in sorted(adj.get(node, ())):
                    if nxt == a:
                        order = [a] + path
                        key = frozenset(order)
                        if key in seen:
                            continue
                        seen.add(key)
                        legs = []
                        for i, lock in enumerate(order):
                            nxt_lock = order[(i + 1) % len(order)]
                            edge = edges.get((lock, nxt_lock))
                            if edge is not None:
                                legs.append(
                                    {
                                        "from": lock,
                                        "to": nxt_lock,
                                        "count": edge["count"],
                                        "stack": edge["stack"],
                                    }
                                )
                        found.append(legs)
                    elif nxt not in path:
                        stack.append((nxt, path + [nxt]))
        return found

    def snapshot(self) -> dict:
        """JSON-safe state for the ``lock_witness`` RPC / doctor."""
        with self._mu:
            edges = [
                {"from": a, "to": b, "count": e["count"], "stack": e["stack"]}
                for (a, b), e in self.edges.items()
            ]
            blocked = [
                {"lock": l, "op": op, "count": e["count"], "stack": e["stack"]}
                for (l, op), e in self.blocked.items()
            ]
            dropped = self.dropped_edges
        return {
            "enabled": True,
            "pid": os.getpid(),
            "edges": edges,
            "held_blocking": blocked,
            "dropped_edges": dropped,
            "cycles": self.cycles(),
        }


class _WitnessLock:
    """Instrumented Lock/RLock. Exists only while the witness is
    installed — `make_lock` hands out raw locks otherwise."""

    __slots__ = ("_name", "_inner")

    def __init__(self, name: str, kind: str = "lock"):
        self._name = name
        self._inner = (
            threading.RLock() if kind == "rlock" else threading.Lock()
        )

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.monotonic()
        ok = self._inner.acquire(blocking, timeout)
        witness_ = _WITNESS
        if ok and witness_ is not None:
            witness_.on_acquired(self._name, time.monotonic() - t0)
        return ok

    def release(self) -> None:
        witness_ = _WITNESS
        if witness_ is not None:
            witness_.on_released(self._name)
        self._inner.release()

    def locked(self) -> bool:
        locked_fn = getattr(self._inner, "locked", None)
        return locked_fn() if locked_fn is not None else False

    def __enter__(self) -> "_WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _reset_after_fork() -> None:
    # The child inherits the parent's tables and OTHER threads' held
    # stacks — both are garbage post-fork. Start a fresh witness with
    # the same bound (the wrapped locks keep working: they read the
    # module global on every acquire).
    global _WITNESS
    if _WITNESS is not None:
        _WITNESS = LockWitness(max_edges=_WITNESS.max_edges)


def _exit_report() -> None:
    witness_ = _WITNESS
    if witness_ is None:
        return
    cycles = witness_.cycles()
    if not cycles:
        return
    import sys

    print(
        f"[lock-witness] pid {os.getpid()}: "
        f"{len(cycles)} lock-order inversion(s) observed at exit:",
        file=sys.stderr,
    )
    for legs in cycles:
        for leg in legs:
            print(
                f"  {leg['from']} -> {leg['to']} "
                f"(seen {leg['count']}x)\n{leg['stack']}",
                file=sys.stderr,
            )


def install(max_edges: Optional[int] = None) -> LockWitness:
    """Install the process witness (idempotent). Called automatically
    when the env flag is set; call directly in tests/benches."""
    global _WITNESS, _fork_hook_registered
    if _WITNESS is None:
        if max_edges is None:
            max_edges = int(os.environ.get(_ENV_MAX_EDGES, "4096"))
        _WITNESS = LockWitness(max_edges=max_edges)
        if not _fork_hook_registered:
            _fork_hook_registered = True
            os.register_at_fork(after_in_child=_reset_after_fork)
            import atexit

            atexit.register(_exit_report)
    return _WITNESS


def uninstall() -> None:
    """Drop the witness (tests/benches). Already-wrapped locks keep
    working but stop recording."""
    global _WITNESS
    _WITNESS = None


def _maybe_install_from_env() -> None:
    global _env_checked
    if _env_checked:
        return
    _env_checked = True
    if _truthy(os.environ.get(_ENV_FLAG, "")):
        install()


def configure(config) -> None:
    """Apply cluster config (same contract as flight_recorder: the
    env var wins over the cluster flag, so one process can opt out)."""
    env = os.environ.get(_ENV_FLAG)
    if env is not None:
        if _truthy(env):
            install(max_edges=getattr(config, "lock_witness_max_edges", None))
        return
    if getattr(config, "lock_witness_enabled", False):
        install(max_edges=getattr(config, "lock_witness_max_edges", None))


def enabled() -> bool:
    _maybe_install_from_env()
    return _WITNESS is not None


def witness() -> Optional[LockWitness]:
    return _WITNESS


def make_lock(name: str, kind: str = "lock"):
    """The hot-path lock factory. Witness off → a RAW threading lock
    (zero overhead, no wrapper); witness on → an instrumented one."""
    if not enabled():
        return threading.RLock() if kind == "rlock" else threading.Lock()
    return _WitnessLock(name, kind)


def note_blocking(op: str) -> None:
    """Record 'about to block while holding a witness lock' (hooked on
    the RPC client call path). One global read when disabled."""
    witness_ = _WITNESS
    if witness_ is not None:
        witness_.note_blocking(op)


def snapshot() -> dict:
    """This process's witness state ({"enabled": False} when off)."""
    witness_ = _WITNESS
    if witness_ is None:
        return {"enabled": False, "pid": os.getpid()}
    return witness_.snapshot()
