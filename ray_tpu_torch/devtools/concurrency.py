# Copied from ray_tpu/devtools/concurrency.py.
"""Whole-program concurrency analyzer (`python -m
ray_tpu_torch.devtools.concurrency`,
rules RT201-RT206).

Third devtools layer (after lint's per-file idioms and check's
cross-process contracts): build a thread/lock model of the tree and
judge it for races, deadlocks, and blocking-while-holding — the gate
ROADMAP item 5 (head sharding) and item 2 (multi-tenant scheduler)
are required to pass before touching the contended state tables.

The model, per class:

* **Execution contexts** — which entry points run on which threads.
  A method is a context *root* when it is passed to
  ``threading.Thread(target=...)`` (context ``thread:<name>``), an
  executor ``.submit`` (``executor``), an RPC-server ``.register``
  or named ``_h_*`` (``rpc`` — the server dispatches on a bounded
  pool, so this context is *self-concurrent*), a ``call_async``/
  ``add_done_callback`` callback (``callback`` — runs on the reader
  thread/pool), or ``atexit.register``/``weakref.finalize``/
  ``os.register_at_fork`` (``finalizer``).  ``@rt.remote`` actor
  methods share one ``actor-mailbox`` context (the mailbox is
  single-threaded).  Public methods of a class that owns at least
  one thread root get the ``caller`` context (application threads
  call them while the background machinery runs).  Contexts
  propagate caller→callee over the per-class call graph.
* **Lock attrs** — ``self._x = threading.Lock()/RLock()/Condition()``
  (or the devtools ``make_lock`` witness factory), class-level lock
  attrs, and module-level lock globals; plus *opaque* lock tokens
  for ``with <expr>:`` where the dotted expr looks lock-ish.
* **Guards** — the lock set lexically held at each attribute write,
  widened by the *inherited* lock set: the intersection of locks
  held at every call site of a helper (the ``_foo_locked`` idiom
  stays quiet).  ``with self._hot_lock(...)``-style contextmanager
  methods count as acquiring whatever they lexically acquire.

| id    | judgment                                                     |
|-------|--------------------------------------------------------------|
| RT201 | attribute written from ≥2 execution contexts (or one        |
|       | self-concurrent context) with no common lock.  Attrs whose  |
|       | every write is a plain constant store (``self._stop=True``) |
|       | are exempt — single STORE_ATTR ops are GIL-atomic flags.    |
| RT202 | lock-order-inversion cycle in the static acquisition graph  |
|       | (A held while taking B somewhere, B held while taking A     |
|       | elsewhere); also a plain ``Lock`` re-acquired while held    |
|       | (self-deadlock — RLocks are exempt).                        |
| RT203 | blocking call (``time.sleep``, ``rt.get``, ``.result()``,   |
|       | ``.recv()``, ``.accept()``, ``client.call(...)`` RPCs,      |
|       | queue ``.get/.put(timeout=)``, thread ``.join()``) while    |
|       | holding a lock — the daemon ``_hot_lock`` discipline,       |
|       | generalized.                                                 |
| RT204 | ``Condition.wait()`` outside a predicate loop (wakeups are  |
|       | spurious and racy by spec).                                 |
| RT205 | lock created per-call in a function body and only used      |
|       | there — a fresh lock per invocation guards nothing.         |
| RT206 | finalizer/atexit/fork callback (or ``__del__``) that        |
|       | acquires a lock — runs on an arbitrary thread that may      |
|       | already hold it (the post-fork reset idiom must stay        |
|       | lock-free).                                                  |

Shares the lint/check contract: ``# rt: noqa[RT2xx]`` suppressions,
``--json``, exit 0 clean / 1 findings / 2 usage errors.  Precision
over recall throughout: cross-class context flow, aliased locks, and
dynamically-chosen attributes stay silent rather than guessing — the
runtime counterpart (`devtools/lock_witness.py`) supplies the dynamic
evidence this pass cannot see.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .contracts import build_symbol_table
from .lint import (
    Finding,
    _dotted,
    _is_remote_decorator,
    _iter_py_files,
    noqa_hygiene,
)

__all__ = ["race_sources", "race_paths", "main", "RULES"]

#: id -> one-line title (the --list-rules table).
RULES: Dict[str, str] = {
    "RT201": "attribute written from ≥2 contexts with no common lock",
    "RT202": "lock-order inversion cycle in the acquisition graph",
    "RT203": "blocking call while holding a lock",
    "RT204": "Condition.wait() outside a predicate loop",
    "RT205": "per-call lock guards nothing",
    "RT206": "finalizer/__del__ acquires a lock on an arbitrary thread",
    "RT290": "stale or unknown '# rt: noqa' suppression (race family)",
}

#: Constructors that create a mutex-like object -> kind.
_LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
}

#: The witness factory (devtools/lock_witness.py): make_lock(name,
#: kind=...) returns a Lock/RLock — analyzed like the raw ctor.
_LOCK_FACTORIES = {"make_lock", "lock_witness.make_lock"}

_THREAD_CTORS = {"threading.Thread", "Thread"}

#: Context labels where two invocations of the SAME root can run
#: concurrently (dispatch pools, reader threads, GC/atexit threads) —
#: one such context already counts as two for RT201.
_SELF_CONCURRENT = {"rpc", "callback", "executor", "finalizer"}

#: Dotted names that block the calling thread.
_BLOCKING_DOTTED = {"time.sleep", "rt.get", "ray_tpu_torch.get", "select.select",
                    "subprocess.run", "subprocess.check_output"}

#: Attribute calls that block regardless of kwargs.
_BLOCKING_ATTRS = {"result", "recv", "recv_into", "accept", "communicate"}

#: Methods that mutate their receiver in place.
_MUTATORS = {
    "append", "extend", "add", "discard", "remove", "pop", "popleft",
    "appendleft", "clear", "update", "setdefault", "insert",
}

#: Substrings marking a dotted with-target as "probably a mutex" when
#: we cannot resolve its constructor (opaque tokens).
_LOCKISH = ("lock", "mutex", "cond", "gate")


def _name_of(expr: ast.expr) -> Optional[str]:
    return _dotted(expr)


def _is_lock_ctor(call: ast.Call) -> Optional[str]:
    """Kind string when `call` constructs a mutex, else None."""
    dotted = _dotted(call.func)
    if dotted is None:
        return None
    if dotted in _LOCK_CTORS:
        return _LOCK_CTORS[dotted]
    if dotted in _LOCK_FACTORIES or dotted.endswith(".make_lock"):
        for kw in call.keywords:
            if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                return str(kw.value.value)
        if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
            return str(call.args[1].value)
        return "lock"
    return None


@dataclass
class _Write:
    attr: str
    line: int
    col: int
    held: frozenset
    atomic: bool  # plain constant store (GIL-atomic flag)


@dataclass
class _Acquire:
    token: str
    kind: Optional[str]
    line: int
    col: int
    held: frozenset  # tokens already held when this one is taken


@dataclass
class _Blocking:
    line: int
    col: int
    what: str
    held: frozenset


@dataclass
class _SelfCall:
    callee: str  # method name within the same class (or mangled local)
    line: int
    col: int
    held: frozenset


@dataclass
class _FuncInfo:
    name: str  # method name; nested defs/lambdas are "outer.<name>"
    qualname: str
    path: str
    line: int
    roots: Set[str] = field(default_factory=set)
    writes: List[_Write] = field(default_factory=list)
    acquires: List[_Acquire] = field(default_factory=list)
    blocking: List[_Blocking] = field(default_factory=list)
    calls: List[_SelfCall] = field(default_factory=list)
    cond_waits: List[Tuple[str, int, int, bool]] = field(
        default_factory=list
    )  # (token, line, col, in_loop)
    findings: List[Finding] = field(default_factory=list)  # RT205/206


@dataclass
class _ClassModel:
    name: str
    path: str
    line: int
    is_actor: bool = False
    #: attr -> kind for self._x = Lock()/RLock()/Condition() (instance
    #: or class level).
    lock_attrs: Dict[str, str] = field(default_factory=dict)
    #: attrs assigned threading.Thread(...) — lets RT203 flag
    #: `self._t.join()` without flagging `", ".join(...)`.
    thread_attrs: Set[str] = field(default_factory=set)
    #: contextmanager methods -> lock tokens they lexically acquire
    #: (the daemon `_hot_lock` idiom).
    cm_locks: Dict[str, Set[Tuple[str, Optional[str]]]] = field(
        default_factory=dict
    )
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    funcs: Dict[str, _FuncInfo] = field(default_factory=dict)


class _Model:
    """Phase-1 output: every class + module-level function scanned."""

    def __init__(self) -> None:
        self.classes: List[_ClassModel] = []
        #: path -> {name: kind} module-level lock globals.
        self.module_locks: Dict[str, Dict[str, str]] = {}
        #: module-level (and pseudo-class-less) funcs, per path.
        self.module_funcs: Dict[str, List[_FuncInfo]] = {}


# ---------------------------------------------------------------------------
# phase 1: build the thread/lock model
# ---------------------------------------------------------------------------


def _is_contextmanager(node: ast.AST) -> bool:
    for dec in getattr(node, "decorator_list", []):
        dotted = _dotted(dec) or ""
        if dotted.endswith("contextmanager"):
            return True
    return False


def _scan_class(path: str, node: ast.ClassDef, model: _Model) -> None:
    cm = _ClassModel(name=node.name, path=path, line=node.lineno)
    cm.is_actor = any(
        _is_remote_decorator(d) for d in node.decorator_list
    )
    # Pass A: collect methods, lock/thread attrs (class body + any
    # `self._x = <lock ctor>` in any method — usually __init__).
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cm.methods[item.name] = item
        elif isinstance(item, ast.Assign) and isinstance(
            item.value, ast.Call
        ):
            kind = _is_lock_ctor(item.value)
            if kind:
                for tgt in item.targets:
                    if isinstance(tgt, ast.Name):
                        cm.lock_attrs[tgt.id] = kind
    for method in cm.methods.values():
        for sub in ast.walk(method):
            if not (
                isinstance(sub, ast.Assign)
                and isinstance(sub.value, ast.Call)
            ):
                continue
            for tgt in sub.targets:
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id in ("self", "cls")
                ):
                    continue
                kind = _is_lock_ctor(sub.value)
                if kind:
                    cm.lock_attrs.setdefault(tgt.attr, kind)
                elif _dotted(sub.value.func) in _THREAD_CTORS:
                    cm.thread_attrs.add(tgt.attr)
    # Pass B: contextmanager methods' lexical lock sets, so
    # `with self._hot_lock(...)` counts as holding self._lock.
    for name, method in cm.methods.items():
        if not _is_contextmanager(method):
            continue
        tokens: Set[Tuple[str, Optional[str]]] = set()
        for sub in ast.walk(method):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    tok = _lock_token(
                        item.context_expr, cm, model.module_locks.get(path, {})
                    )
                    if tok:
                        tokens.add(tok)
        if tokens:
            cm.cm_locks[name] = tokens
    # Pass C: scan every method body.
    for name, method in cm.methods.items():
        _scan_function(path, name, method, cm, model)
    model.classes.append(cm)


def _lock_token(
    expr: ast.expr,
    cm: Optional[_ClassModel],
    module_locks: Dict[str, str],
) -> Optional[Tuple[str, Optional[str]]]:
    """(token, kind) when `expr` names a mutex, else None.

    Known tokens are class- or module-qualified; opaque lock-ish
    dotted expressions get a textual token (stable within one class,
    excluded from the global RT202 graph).
    """
    if isinstance(expr, ast.Call):
        # `with self._hot_lock("dispatch"):` — a contextmanager
        # method that acquires locks; resolved by the caller via
        # cm.cm_locks (cannot return multiple tokens here).
        return None
    dotted = _dotted(expr)
    if dotted is None:
        return None
    if cm is not None and "." in dotted:
        recv, _, attr = dotted.rpartition(".")
        if recv in ("self", "cls", cm.name) and attr in cm.lock_attrs:
            return (f"{cm.name}.{attr}", cm.lock_attrs[attr])
    if dotted in module_locks:
        return (dotted, module_locks[dotted])
    low = dotted.lower()
    if any(s in low for s in _LOCKISH):
        scope = cm.name if cm is not None else "<module>"
        if dotted.startswith(("self.", "cls.")):
            return (f"{scope}.{dotted.split('.', 1)[1]}", None)
        return (f"{scope}:{dotted}", None)
    return None


class _FuncScanner(ast.NodeVisitor):
    """One function body: held-lock-aware event collection.

    Does not descend into nested defs/lambdas — those are scanned as
    their own (mangled) _FuncInfo, and a local name map lets
    `Thread(target=loop)` mark the nested def as a root.
    """

    def __init__(
        self,
        path: str,
        info: _FuncInfo,
        cm: Optional[_ClassModel],
        model: _Model,
        local_conds: Set[str],
    ) -> None:
        self.path = path
        self.info = info
        self.cm = cm
        self.model = model
        self.module_locks = model.module_locks.get(path, {})
        self.held: List[Tuple[str, Optional[str]]] = []
        self.loop_depth = 0
        #: local var -> (kind, line, col) for `x = threading.Lock()`.
        self.local_locks: Dict[str, Tuple[str, int, int]] = {}
        self.local_lock_with: Dict[str, int] = {}
        self.local_lock_escaped: Set[str] = set()
        self.local_conds = local_conds
        #: local def name -> mangled _FuncInfo name.
        self.local_defs: Dict[str, str] = {}
        self._nested = 0

    # -- held-set helpers ------------------------------------------------

    def _held(self) -> frozenset:
        return frozenset(tok for tok, _ in self.held)

    def _tokens_for(self, expr: ast.expr) -> List[Tuple[str, Optional[str]]]:
        if isinstance(expr, ast.Call):
            dotted = _dotted(expr.func) or ""
            if (
                self.cm is not None
                and dotted.startswith("self.")
                and dotted[5:] in self.cm.cm_locks
            ):
                return sorted(
                    self.cm.cm_locks[dotted[5:]], key=lambda t: t[0]
                )
            return []
        if isinstance(expr, ast.Name) and expr.id in self.local_locks:
            kind, _, _ = self.local_locks[expr.id]
            self.local_lock_with[expr.id] = expr.lineno
            return [(f"<local>.{expr.id}", kind)]
        tok = _lock_token(expr, self.cm, self.module_locks)
        return [tok] if tok else []

    # -- visitors --------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired: List[Tuple[str, Optional[str]]] = []
        for item in node.items:
            for tok in self._tokens_for(item.context_expr):
                self.info.acquires.append(
                    _Acquire(
                        token=tok[0],
                        kind=tok[1],
                        line=node.lineno,
                        col=node.col_offset + 1,
                        held=self._held(),
                    )
                )
                self.held.append(tok)
                acquired.append(tok)
            if isinstance(item.context_expr, ast.Call):
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def visit_For(self, node: ast.For) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_AsyncFor = visit_For

    def visit_While(self, node: ast.While) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        mangled = f"{self.info.name}.{node.name}"
        self.local_defs[node.name] = mangled
        # Locals captured by a closure escape the call (the closure
        # may be handed to another thread — the lock then DOES guard).
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in self.local_locks:
                self.local_lock_escaped.add(sub.id)
        _scan_function(self.path, mangled, node, self.cm, self.model)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in self.local_locks:
                self.local_lock_escaped.add(sub.id)
        # Lambda bodies are scanned only when registered as callbacks
        # (handled in visit_Call); a bare lambda is inert here.

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            kind = _is_lock_ctor(node.value)
            if kind and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name
            ):
                self.local_locks[node.targets[0].id] = (
                    kind,
                    node.lineno,
                    node.col_offset + 1,
                )
        atomic = isinstance(node.value, ast.Constant)
        for tgt in node.targets:
            self._record_store(tgt, atomic)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_store(node.target, atomic=False)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_store(
                node.target, atomic=isinstance(node.value, ast.Constant)
            )
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._record_store(tgt, atomic=False)

    def _record_store(self, tgt: ast.expr, atomic: bool) -> None:
        # self.X = v (atomic store), self.X[k] = v / del self.X[k]
        # (container mutation — never atomic for judgment purposes).
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._record_store(el, atomic=False)
            return
        if isinstance(tgt, ast.Subscript):
            tgt, atomic = tgt.value, False
        if (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id in ("self", "cls")
        ):
            self.info.writes.append(
                _Write(
                    attr=tgt.attr,
                    line=tgt.lineno,
                    col=tgt.col_offset + 1,
                    held=self._held(),
                    atomic=atomic,
                )
            )

    def visit_Call(self, node: ast.Call) -> None:  # noqa: C901
        dotted = _dotted(node.func) or ""
        # `pool().submit(fn)` has no dotted name — the method name
        # alone still identifies the callback-handoff / blocking verb.
        tail = (
            node.func.attr
            if isinstance(node.func, ast.Attribute)
            else dotted
        )
        self._maybe_register_root(node, dotted, tail)
        self._maybe_blocking(node, dotted, tail)
        self._maybe_acquire_release(node, dotted)
        self._maybe_self_call(node, dotted)
        self._maybe_mutator(node, dotted)
        self._maybe_cond_wait(node, dotted)
        self._maybe_escape(node)
        self.generic_visit(node)

    def _callback_label(
        self, dotted: str, tail: str
    ) -> Optional[Tuple[str, int]]:
        """(context label, arg index of the callable) for calls that
        hand a callable to another execution context."""
        if dotted in _THREAD_CTORS:
            return ("thread", -1)  # target= kwarg
        if tail == "submit":
            return ("executor", 0)
        if tail == "register" and dotted.startswith("atexit"):
            return ("finalizer", 0)
        if tail == "register_at_fork":
            return ("finalizer", -2)  # kwargs only
        if tail == "finalize" and "weakref" in dotted:
            return ("finalizer", 1)
        if tail == "register":
            return ("rpc", 1)
        if tail == "call_async":
            return ("callback", 1)
        if tail == "add_done_callback":
            return ("callback", 0)
        return None

    def _maybe_register_root(
        self, node: ast.Call, dotted: str, tail: str
    ) -> None:
        spec = self._callback_label(dotted, tail)
        if spec is None:
            return
        label, idx = spec
        candidates: List[ast.expr] = []
        if idx == -1:  # Thread(target=...)
            for kw in node.keywords:
                if kw.arg == "target":
                    candidates.append(kw.value)
        elif idx == -2:  # register_at_fork(**kwargs)
            candidates.extend(kw.value for kw in node.keywords if kw.arg)
        else:
            if len(node.args) > idx:
                candidates.append(node.args[idx])
            for kw in node.keywords:
                if kw.arg in ("callback", "fn", "func", "target"):
                    candidates.append(kw.value)
        for cand in candidates:
            self._mark_root(cand, label, node.lineno)

    def _mark_root(self, expr: ast.expr, label: str, line: int) -> None:
        cd = _dotted(expr) or ""
        if cd.startswith(("functools.partial", "partial")) and isinstance(
            expr, ast.Call
        ):
            if expr.args:
                self._mark_root(expr.args[0], label, line)
            return
        if isinstance(expr, ast.Lambda):
            mangled = f"{self.info.name}.<lambda>L{expr.lineno}"
            wrapper = ast.FunctionDef(
                name=mangled,
                args=expr.args,
                body=[ast.Expr(value=expr.body)],
                decorator_list=[],
                returns=None,
            )
            ast.copy_location(wrapper, expr)
            ast.fix_missing_locations(wrapper)
            _scan_function(self.path, mangled, wrapper, self.cm, self.model)
            self._root_for(mangled, label)
            return
        if cd.startswith("self.") and self.cm is not None:
            name = cd[5:]
            if name in self.cm.methods:
                self._root_for(name, label)
            return
        if cd in self.local_defs:
            self._root_for(self.local_defs[cd], label)

    def _root_for(self, func_name: str, label: str) -> None:
        if label == "thread":
            label = f"thread:{func_name.rpartition('.')[2]}"
        bucket = (
            self.cm.funcs
            if self.cm is not None
            else {f.name: f for f in self.model.module_funcs.get(self.path, [])}
        )
        info = bucket.get(func_name)
        if info is not None:
            info.roots.add(label)
        else:
            # Scanned later (forward reference to a sibling method):
            # park the root on a pending map via the class model.
            if self.cm is not None:
                self.cm.funcs.setdefault(
                    func_name,
                    _FuncInfo(
                        name=func_name,
                        qualname=func_name,
                        path=self.path,
                        line=0,
                    ),
                ).roots.add(label)

    def _maybe_blocking(
        self, node: ast.Call, dotted: str, tail: str
    ) -> None:
        what = None
        is_attr = isinstance(node.func, ast.Attribute)
        if dotted in _BLOCKING_DOTTED:
            what = dotted
        elif tail in _BLOCKING_ATTRS and is_attr:
            what = f".{tail}()"
        elif tail == "call" and is_attr and node.args and isinstance(
            node.args[0], ast.Constant
        ):
            what = f'.call("{node.args[0].value}") RPC'
        elif tail in ("get", "put") and is_attr and any(
            kw.arg in ("timeout", "block")
            # timeout=0 / block=False are explicit NON-blocking forms.
            and not (
                isinstance(kw.value, ast.Constant) and not kw.value.value
            )
            for kw in node.keywords
        ):
            what = f".{tail}(timeout=...)"
        elif tail == "join" and self.cm is not None and "." in dotted:
            recv = dotted.rpartition(".")[0]
            if (
                recv.startswith(("self.", "cls."))
                and recv.split(".", 1)[1] in self.cm.thread_attrs
            ):
                what = ".join() on a thread"
        elif tail == "wait":
            recv = dotted.rpartition(".")[0]
            tok = (
                _lock_token(
                    ast.parse(recv, mode="eval").body
                    if recv
                    else ast.Name(id=""),
                    self.cm,
                    self.module_locks,
                )
                if recv
                else None
            )
            # Waiting on the condition you hold RELEASES it; waiting
            # on anything else (Event, other cond) while holding a
            # DIFFERENT lock blocks with it held.
            if tok is not None and tok[0] not in self._held():
                what = f"{recv}.wait()"
        if what is not None:
            self.info.blocking.append(
                _Blocking(
                    line=node.lineno,
                    col=node.col_offset + 1,
                    what=what,
                    held=self._held(),
                )
            )

    def _maybe_acquire_release(self, node: ast.Call, dotted: str) -> None:
        tail = dotted.rpartition(".")[2]
        if tail != "acquire" or "." not in dotted:
            return
        recv = dotted.rpartition(".")[0]
        try:
            expr = ast.parse(recv, mode="eval").body
        except SyntaxError:
            return
        for tok in self._tokens_for(expr) or (
            [(f"<local>.{recv}", self.local_locks[recv][0])]
            if recv in self.local_locks
            else []
        ):
            self.info.acquires.append(
                _Acquire(
                    token=tok[0],
                    kind=tok[1],
                    line=node.lineno,
                    col=node.col_offset + 1,
                    held=self._held(),
                )
            )

    def _maybe_self_call(self, node: ast.Call, dotted: str) -> None:
        if self.cm is not None and dotted.startswith("self."):
            name = dotted[5:]
            if name in self.cm.methods:
                self.info.calls.append(
                    _SelfCall(
                        callee=name,
                        line=node.lineno,
                        col=node.col_offset + 1,
                        held=self._held(),
                    )
                )
                return
        if dotted in self.local_defs:
            self.info.calls.append(
                _SelfCall(
                    callee=self.local_defs[dotted],
                    line=node.lineno,
                    col=node.col_offset + 1,
                    held=self._held(),
                )
            )

    def _maybe_mutator(self, node: ast.Call, dotted: str) -> None:
        if not isinstance(node.func, ast.Attribute):
            return
        if node.func.attr not in _MUTATORS:
            return
        recv = node.func.value
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id in ("self", "cls")
        ):
            self.info.writes.append(
                _Write(
                    attr=recv.attr,
                    line=node.lineno,
                    col=node.col_offset + 1,
                    held=self._held(),
                    atomic=False,
                )
            )

    def _maybe_cond_wait(self, node: ast.Call, dotted: str) -> None:
        tail = dotted.rpartition(".")[2]
        if tail not in ("wait", "wait_for"):
            return
        recv = dotted.rpartition(".")[0]
        is_cond = False
        if recv.startswith(("self.", "cls.")) and self.cm is not None:
            is_cond = (
                self.cm.lock_attrs.get(recv.split(".", 1)[1]) == "condition"
            )
        elif recv in self.local_conds:
            is_cond = True
        if is_cond and tail == "wait":
            self.info.cond_waits.append(
                (
                    recv,
                    node.lineno,
                    node.col_offset + 1,
                    self.loop_depth > 0,
                )
            )

    def _maybe_escape(self, node: ast.Call) -> None:
        # A local lock passed anywhere / returned / stored escapes
        # per-call scope and is NOT an RT205 case.
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name) and arg.id in self.local_locks:
                self.local_lock_escaped.add(arg.id)

    def visit_Return(self, node: ast.Return) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id in self.local_locks:
                self.local_lock_escaped.add(sub.id)
        self.generic_visit(node)


def _scan_function(
    path: str,
    name: str,
    node: ast.AST,
    cm: Optional[_ClassModel],
    model: _Model,
) -> None:
    qual = f"{cm.name}.{name}" if cm is not None else name
    existing = cm.funcs.get(name) if cm is not None else None
    info = existing or _FuncInfo(
        name=name, qualname=qual, path=path, line=node.lineno
    )
    info.qualname, info.line = qual, node.lineno
    local_conds = {
        tgt.id
        for sub in ast.walk(node)
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call)
        for tgt in sub.targets
        if isinstance(tgt, ast.Name)
        and _is_lock_ctor(sub.value) == "condition"
    }
    scanner = _FuncScanner(path, info, cm, model, local_conds)
    for stmt in node.body:
        scanner.visit(stmt)
    # RT205: a per-call lock with-used here that never escaped.
    for var, (kind, line, col) in scanner.local_locks.items():
        if (
            var in scanner.local_lock_with
            and var not in scanner.local_lock_escaped
            and name not in ("__init__",)
        ):
            info.findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=col,
                    rule="RT205",
                    message=(
                        f"{qual} creates {kind} '{var}' per call and only "
                        f"uses it locally — a fresh lock each invocation "
                        f"guards nothing (make it an instance/module "
                        f"attribute)"
                    ),
                )
            )
    # RT206: __del__ acquiring a lock.
    if name == "__del__" and info.acquires:
        acq = info.acquires[0]
        info.findings.append(
            Finding(
                path=path,
                line=acq.line,
                col=acq.col,
                rule="RT206",
                message=(
                    f"{qual} acquires {acq.token} — __del__ runs on "
                    f"whatever thread drops the last reference, which may "
                    f"already hold it (deadlock); use weakref.finalize "
                    f"with lock-free cleanup"
                ),
            )
        )
    if cm is not None:
        cm.funcs[name] = info
    else:
        bucket = model.module_funcs.setdefault(path, [])
        if info not in bucket:
            bucket.append(info)


def _build_model(
    sources: Sequence[Tuple[str, str]],
    parsed: Sequence,
) -> _Model:
    model = _Model()
    # Module-level locks first (so class scans can resolve them).
    for pf in parsed:
        locks: Dict[str, str] = {}
        for node in pf.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                kind = _is_lock_ctor(node.value)
                if kind:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            locks[tgt.id] = kind
        model.module_locks[pf.path] = locks
    for pf in parsed:
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.ClassDef):
                _scan_class(pf.path, node, model)
        for node in pf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _scan_function(pf.path, node.name, node, None, model)
    return model


# ---------------------------------------------------------------------------
# phase 2: judgments
# ---------------------------------------------------------------------------


def _propagate(cm: _ClassModel) -> Tuple[Dict[str, Set[str]], Dict[str, frozenset]]:
    """(contexts per func, inherited-lock set per func).

    Contexts flow caller→callee (union, increasing fixpoint);
    inherited locks are the intersection over all call sites of
    (lexically held there ∪ caller's own inherited set) — the
    `_foo_locked` helper idiom.  Root functions inherit nothing.
    """
    # RPC handlers by naming convention (`getattr(self, "_h_"+name)`
    # registration loops make the explicit .register edge invisible).
    for name, info in cm.funcs.items():
        base = name.rpartition(".")[2]
        if base.startswith("_h_"):
            info.roots.add("rpc")
    if cm.is_actor:
        for name, info in cm.funcs.items():
            if not name.startswith("_") and "." not in name:
                info.roots.add("actor-mailbox")
    concurrent_roots = any(
        lbl for f in cm.funcs.values() for lbl in f.roots
        if lbl != "actor-mailbox"
    )
    if concurrent_roots and not cm.is_actor:
        for name, info in cm.funcs.items():
            if (
                "." not in name
                and not name.startswith("_")
            ):
                info.roots.add("caller")
    contexts: Dict[str, Set[str]] = {
        n: set(f.roots) for n, f in cm.funcs.items()
    }
    callers: Dict[str, List[Tuple[str, frozenset]]] = {}
    for name, info in cm.funcs.items():
        for call in info.calls:
            callers.setdefault(call.callee, []).append((name, call.held))
    for _ in range(len(cm.funcs) + 2):
        changed = False
        for name, info in cm.funcs.items():
            for call in info.calls:
                tgt = contexts.get(call.callee)
                if tgt is not None and not contexts[name] <= tgt:
                    tgt |= contexts[name]
                    changed = True
        if not changed:
            break
    TOP = frozenset({"<top>"})
    inherited: Dict[str, frozenset] = {
        n: (frozenset() if f.roots else TOP) for n, f in cm.funcs.items()
    }
    for _ in range(len(cm.funcs) + 2):
        changed = False
        for name, info in cm.funcs.items():
            if info.roots:
                continue
            sites = callers.get(name, [])
            if not sites:
                continue
            meet: Optional[frozenset] = None
            for caller, held in sites:
                inh = inherited.get(caller, frozenset())
                eff = held | (frozenset() if inh == TOP else inh)
                meet = eff if meet is None else (meet & eff)
            meet = meet if meet is not None else frozenset()
            if meet != inherited[name]:
                inherited[name] = meet
                changed = True
        if not changed:
            break
    inherited = {
        n: (frozenset() if v == TOP else v) for n, v in inherited.items()
    }
    return contexts, inherited


def _ctx_weight(ctx: Set[str]) -> int:
    return len(ctx) + sum(1 for c in ctx if c in _SELF_CONCURRENT)


def _judge_class(cm: _ClassModel, findings: List[Finding]) -> None:
    contexts, inherited = _propagate(cm)
    for info in cm.funcs.values():
        findings.extend(info.findings)
        for token, line, col, in_loop in info.cond_waits:
            if not in_loop:
                findings.append(
                    Finding(
                        path=info.path,
                        line=line,
                        col=col,
                        rule="RT204",
                        message=(
                            f"{info.qualname} calls {token}.wait() outside "
                            f"a predicate loop — condition wakeups are "
                            f"spurious by spec; use `while not <pred>: "
                            f"{token}.wait(...)`"
                        ),
                    )
                )
    # RT203: blocking while holding (lexical ∪ inherited locks).
    blocked_lines: Set[Tuple[str, int]] = set()
    for name, info in cm.funcs.items():
        inh = inherited.get(name, frozenset())
        for blk in info.blocking:
            held = blk.held | inh
            if held:
                blocked_lines.add((info.path, blk.line))
                findings.append(
                    Finding(
                        path=info.path,
                        line=blk.line,
                        col=blk.col,
                        rule="RT203",
                        message=(
                            f"{info.qualname} calls {blk.what} while "
                            f"holding {', '.join(sorted(held))} — move the "
                            f"blocking call outside the lock (the "
                            f"_hot_lock discipline)"
                        ),
                    )
                )
    # One-level transitive RT203: `self.m()` under a lock where m
    # lexically blocks (reported at the call site, naming both sides).
    direct_block: Dict[str, Optional[_Blocking]] = {
        n: next((b for b in f.blocking if not b.held), None)
        for n, f in cm.funcs.items()
    }
    for name, info in cm.funcs.items():
        for call in info.calls:
            blk = direct_block.get(call.callee)
            if blk is None or not call.held:
                continue
            if (info.path, call.line) in blocked_lines:
                continue
            callee = cm.funcs[call.callee]
            if inherited.get(call.callee):
                continue  # already reported at the callee
            findings.append(
                Finding(
                    path=info.path,
                    line=call.line,
                    col=call.col,
                    rule="RT203",
                    message=(
                        f"{info.qualname} holds "
                        f"{', '.join(sorted(call.held))} while calling "
                        f"self.{call.callee.rpartition('.')[2]}(), which "
                        f"blocks on {blk.what} at "
                        f"{callee.path}:{blk.line}"
                    ),
                )
            )
    # RT201: shared-attr writes across contexts with no common lock.
    if not any(
        lbl
        for f in cm.funcs.values()
        for lbl in f.roots
        if lbl not in ("caller",)
    ):
        return
    by_attr: Dict[str, List[Tuple[_FuncInfo, _Write, Set[str], frozenset]]] = {}
    for name, info in cm.funcs.items():
        ctx = contexts.get(name, set())
        if not ctx:
            continue  # unreachable from any entry point
        base = name.rpartition(".")[2]
        if base in ("__init__", "__new__", "__del__"):
            continue
        inh = inherited.get(name, frozenset())
        for wr in info.writes:
            by_attr.setdefault(wr.attr, []).append(
                (info, wr, ctx, wr.held | inh)
            )
    for attr, sites in sorted(by_attr.items()):
        if attr in cm.lock_attrs:
            continue
        if all(wr.atomic for _, wr, _, _ in sites):
            continue  # constant flag stores are GIL-atomic
        all_ctx: Set[str] = set()
        for _, _, ctx, _ in sites:
            all_ctx |= ctx
        if all_ctx == {"actor-mailbox"}:
            continue  # mailbox is single-threaded
        if _ctx_weight(all_ctx) < 2:
            continue
        common = None
        for _, _, _, held in sites:
            common = held if common is None else (common & held)
        if common:
            continue
        info, wr, _, _ = sites[0]
        others = "; ".join(
            f"{i.path}:{w.line} in {i.qualname} "
            f"[{'/'.join(sorted(c))}]"
            + (f" holding {'/'.join(sorted(h))}" if h else " unlocked")
            for i, w, c, h in sites[:4]
        )
        findings.append(
            Finding(
                path=info.path,
                line=wr.line,
                col=wr.col,
                rule="RT201",
                message=(
                    f"{cm.name}.{attr} is written from contexts "
                    f"{{{', '.join(sorted(all_ctx))}}} with no common "
                    f"lock — sites: {others}"
                ),
            )
        )


def _lock_graph(model: _Model) -> List[Finding]:
    """RT202: cycles in the global acquisition-order graph."""
    findings: List[Finding] = []
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    kinds: Dict[str, Optional[str]] = {}

    def _known(token: str) -> bool:
        # Opaque tokens ("Class.self._x?"-style or heuristic) stay out
        # of the global graph: identity across files is a guess.
        return "<local>" not in token and ":" not in token

    all_funcs: List[Tuple[Optional[_ClassModel], _FuncInfo]] = []
    for cm in model.classes:
        for info in cm.funcs.values():
            all_funcs.append((cm, info))
    for infos in model.module_funcs.values():
        for info in infos:
            all_funcs.append((None, info))
    direct_acq: Dict[str, Set[str]] = {}
    for cm, info in all_funcs:
        key = info.qualname if cm is None else f"{cm.name}.{info.name}"
        direct_acq[key] = {a.token for a in info.acquires if _known(a.token)}
    for cm, info in all_funcs:
        for acq in info.acquires:
            kinds.setdefault(acq.token, acq.kind)
            if not _known(acq.token):
                continue
            # RLock re-entry is legal; a plain Lock taken while held
            # is an instant self-deadlock.
            if acq.token in acq.held:
                if kinds.get(acq.token) == "lock":
                    findings.append(
                        Finding(
                            path=info.path,
                            line=acq.line,
                            col=acq.col,
                            rule="RT202",
                            message=(
                                f"{info.qualname} re-acquires "
                                f"non-reentrant Lock {acq.token} while "
                                f"already holding it — self-deadlock"
                            ),
                        )
                    )
                continue
            for held in acq.held:
                if _known(held) and held != acq.token:
                    edges.setdefault(
                        (held, acq.token),
                        (info.path, acq.line, info.qualname),
                    )
        # One-level call edges: holding A while calling m() which
        # lexically acquires B.
        for call in info.calls:
            if not call.held:
                continue
            callee_key = (
                f"{cm.name}.{call.callee}" if cm is not None else call.callee
            )
            for tgt in direct_acq.get(callee_key, ()):
                for held in call.held:
                    if _known(held) and held != tgt:
                        edges.setdefault(
                            (held, tgt),
                            (info.path, call.line, info.qualname),
                        )
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    seen_cycles: Set[frozenset] = set()
    for a, b in sorted(edges):
        # Short inversion cycles (length 2..4) via bounded DFS b→a.
        stack = [(b, [b])]
        while stack:
            node, path_ = stack.pop()
            if len(path_) > 4:
                continue
            for nxt in sorted(adj.get(node, ())):
                if nxt == a:
                    cyc = frozenset(path_ + [a])
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    order = [a] + path_
                    legs = []
                    for i, lock in enumerate(order):
                        nxt_lock = order[(i + 1) % len(order)]
                        site = edges.get((lock, nxt_lock))
                        if site:
                            legs.append(
                                f"{lock}->{nxt_lock} at "
                                f"{site[0]}:{site[1]} ({site[2]})"
                            )
                    path0, line0, _ = edges[(a, b)]
                    findings.append(
                        Finding(
                            path=path0,
                            line=line0,
                            col=1,
                            rule="RT202",
                            message=(
                                "lock-order inversion: "
                                + "; ".join(legs)
                                + " — a thread on each side deadlocks"
                            ),
                        )
                    )
                elif nxt not in path_:
                    stack.append((nxt, path_ + [nxt]))
    return findings


# ---------------------------------------------------------------------------
# RT206 (registration-side): callbacks handed to finalizer contexts
# that acquire locks — judged after propagation so the callback's own
# acquisitions are known.
# ---------------------------------------------------------------------------


def _finalizer_findings(model: _Model) -> List[Finding]:
    findings: List[Finding] = []
    for cm in model.classes:
        for info in cm.funcs.values():
            if "finalizer" not in info.roots:
                continue
            for acq in info.acquires:
                findings.append(
                    Finding(
                        path=info.path,
                        line=acq.line,
                        col=acq.col,
                        rule="RT206",
                        message=(
                            f"{info.qualname} runs as a finalizer/atexit/"
                            f"fork callback but acquires {acq.token} — "
                            f"the callback fires on an arbitrary thread "
                            f"that may already hold it (the post-fork "
                            f"reset idiom must stay lock-free)"
                        ),
                    )
                )
                break  # one finding per callback is enough
    for infos in model.module_funcs.values():
        for info in infos:
            if "finalizer" not in info.roots:
                continue
            for acq in info.acquires:
                findings.append(
                    Finding(
                        path=info.path,
                        line=acq.line,
                        col=acq.col,
                        rule="RT206",
                        message=(
                            f"{info.qualname} runs as a finalizer/atexit/"
                            f"fork callback but acquires {acq.token} — "
                            f"the callback fires on an arbitrary thread "
                            f"that may already hold it"
                        ),
                    )
                )
                break
    return findings


# ---------------------------------------------------------------------------
# drivers (same contract as lint/check)
# ---------------------------------------------------------------------------


def race_sources(
    sources: Sequence[Tuple[str, str]],
    rules: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Analyze a set of (path, source) blobs as one program."""
    only = _rule_filter(rules)
    table = build_symbol_table(sources)
    findings: List[Finding] = []
    parsed_paths = {pf.path for pf in table.files}
    for path, source in sources:
        if path not in parsed_paths:
            try:
                ast.parse(source, filename=path)
            except SyntaxError as e:
                findings.append(
                    Finding(
                        path=path,
                        line=e.lineno or 1,
                        col=(e.offset or 0) + 1,
                        rule="RT000",
                        message=f"file does not parse: {e.msg}",
                    )
                )
    model = _build_model(sources, table.files)
    for cm in model.classes:
        _judge_class(cm, findings)
    for infos in model.module_funcs.values():
        for info in infos:
            findings.extend(info.findings)
            for token, line, col, in_loop in info.cond_waits:
                if not in_loop:
                    findings.append(
                        Finding(
                            path=info.path,
                            line=line,
                            col=col,
                            rule="RT204",
                            message=(
                                f"{info.qualname} calls {token}.wait() "
                                f"outside a predicate loop — wakeups are "
                                f"spurious by spec"
                            ),
                        )
                    )
            for blk in info.blocking:
                if blk.held:
                    findings.append(
                        Finding(
                            path=info.path,
                            line=blk.line,
                            col=blk.col,
                            rule="RT203",
                            message=(
                                f"{info.qualname} calls {blk.what} while "
                                f"holding {', '.join(sorted(blk.held))} — "
                                f"move the blocking call outside the lock"
                            ),
                        )
                    )
    findings.extend(_lock_graph(model))
    findings.extend(_finalizer_findings(model))
    noqa_by_path = {pf.path: pf.noqa for pf in table.files}
    kept: List[Finding] = []
    for finding in findings:
        if only is not None and finding.rule in RULES and finding.rule not in only:
            continue
        noqa = noqa_by_path.get(finding.path, {})
        suppressed = noqa.get(finding.line)
        if finding.line in noqa and (
            suppressed is None or finding.rule in suppressed
        ):
            continue
        kept.append(finding)
    # Noqa hygiene (RT290) audits the RAW findings and bypasses
    # suppression — a stale noqa cannot suppress its own report.
    if only is None or "RT290" in only:
        for path, source in sources:
            kept.extend(
                noqa_hygiene(
                    path,
                    source,
                    findings,
                    family_digit="2",
                    known_ids=set(RULES),
                    hygiene_id="RT290",
                )
            )
    # A judgment can be reached via more than one path (lexical +
    # inherited); report each (path, line, rule) once.
    uniq: Dict[Tuple[str, int, str], Finding] = {}
    for f in kept:
        uniq.setdefault((f.path, f.line, f.rule), f)
    out = list(uniq.values())
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def _rule_filter(rules: Optional[Iterable[str]]) -> Optional[Set[str]]:
    if rules is None:
        return None
    wanted = {r.upper() for r in rules}
    unknown = wanted - set(RULES)
    if unknown:
        raise ValueError(f"unknown rule id(s): {', '.join(sorted(unknown))}")
    return wanted


def race_paths(
    paths: Sequence[str], rules: Optional[Iterable[str]] = None
) -> List[Finding]:
    sources: List[Tuple[str, str]] = []
    findings: List[Finding] = []
    for file_path in _iter_py_files(paths):
        try:
            with open(file_path, "r", encoding="utf-8") as f:
                sources.append((file_path, f.read()))
        except (OSError, UnicodeDecodeError) as e:
            findings.append(
                Finding(
                    path=file_path,
                    line=1,
                    col=1,
                    rule="RT000",
                    message=f"unreadable: {e}",
                )
            )
    findings.extend(race_sources(sources, rules))
    return findings


def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    """CLI body shared by `ray_tpu_torch devtools race` and `python -m
    ray_tpu_torch.devtools.concurrency`. Exit codes mirror lint/check: 0
    clean, 1 findings, 2 usage/IO errors."""
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.concurrency",
        description=(
            "whole-program concurrency analyzer (rules RT201-RT206 + "
            "RT290 noqa hygiene; suppress with '# rt: noqa[RT2xx]')"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help=(
            "files or directories to analyze as ONE program (default: "
            "the installed ray_tpu_torch package)"
        ),
    )
    parser.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="emit findings as a JSON list (CI mode)",
    )
    parser.add_argument(
        "--rules",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule table and exit",
    )
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    if args.list_rules:
        for rule_id, title in RULES.items():
            print(f"{rule_id}  {title}", file=out)
        return 0
    if not args.paths:
        args.paths = [
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        ]
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(
            f"race: no such path(s): {', '.join(missing)}",
            file=sys.stderr,
        )
        return 2
    only = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    try:
        findings = race_paths(args.paths, only)
    except ValueError as e:
        print(f"race: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps([asdict(f) for f in findings], indent=2), file=out)
    else:
        for finding in findings:
            print(finding.render(), file=out)
        if findings:
            print(f"{len(findings)} finding(s)", file=out)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
