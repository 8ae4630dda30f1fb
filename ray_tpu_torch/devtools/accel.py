"""Accelerator hot-path analyzer for the port's PyTorch code
(`python -m ray_tpu_torch.devtools.accel`, rules RT301-RT306) — the
static twin of `_private/compile_watch.py`.

Written for the port, not copied: the JAX package's pass
(`ray_tpu/devtools/accel.py`) judges `jax.jit` wrap sites, static
argnums and `donate_argnums`, none of which eager PyTorch has. What the
port's hot paths can get wrong is its own: programs the compile watch
cannot name, shapes that drift per batch through a registered program,
host syncs in a dispatch loop, state read after an in-place step, and
timings that measure a CUDA launch rather than its work. The contract
is the JAX pass's: ``# rt: noqa[RT3xx]`` suppressions, ``--json``,
exit 0 clean / 1 findings / 2 usage errors, `accel_paths`,
`build_inventory`, `main`.

**Phase 1 — inventory.** Every ``compile_watch.instrument(name, fn)``
site with its program name (f-string names become ``fnmatch``
patterns: ``mpmd.s{i}.{k}`` -> ``mpmd.s*.*``) and how its result is
bound (module global, ``self`` attribute, local); every
``torch.compile`` site (call or decorator) and every CUDA-graph capture
(``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
``torch.cuda.make_graphed_callables``); module-level forwarders (a
function returning a call of a registered global: the ``prefill`` ->
``_prefill_prog`` idiom of models/generate.py), so call sites in other
modules are judged too; the steps that ``make_*train_step`` factories
hand out, which update their state in place unless built with
``donate=False``; and the *hot contexts*: functions billed by
``step_telemetry.phase_timer``, ``@rt.remote`` actor methods, and any
function whose loop dispatches a registered program.

**Phase 2 — judgment.**

| id    | judgment                                                     |
|-------|--------------------------------------------------------------|
| RT301 | ``instrument``, ``torch.compile`` or a CUDA-graph capture    |
|       | built inside a loop or in a per-call function body: a fresh |
|       | program (and, for the watch, a fresh seen-set) every call.  |
|       | One-time contexts (init/build/make/setup/warm/test/main     |
|       | names, factories that return the wrapper, module scope) are |
|       | exempt.                                                     |
| RT302 | a ``len()``-bounded slice reaching a registered program in  |
|       | a loop: the operand's shape drifts per batch, a new          |
|       | signature every call — the static cause behind the          |
|       | `verdict.compile` storms `static_hint` resolves.            |
| RT303 | host sync in a hot loop: ``.item()``/``.tolist()``/         |
|       | ``.cpu()``/``.numpy()``, ``float``/``int``/``bool`` of a    |
|       | device value, a branch on one, or                           |
|       | ``torch.cuda.synchronize()``: each blocks the host until    |
|       | the card drains.                                            |
| RT304 | a state passed to a step that updates it in place (a        |
|       | ``make_*train_step`` product without ``donate=False``) and  |
|       | read again before rebinding: it already holds the new step. |
| RT305 | clock read, registered-program call, clock subtraction with |
|       | no ``torch.cuda.synchronize()``, event sync or host         |
|       | materialization between: the number is the launch, not the  |
|       | work.                                                       |
| RT306 | a program the compile watch cannot name: a ``torch.compile``|
|       | result, or a step a ``make_*`` factory returns, that never  |
|       | flows through ``compile_watch.instrument``.                 |
| RT390 | stale or unknown ``# rt: noqa[RT3xx]`` suppression (the     |
|       | shared hygiene contract; see lint.noqa_hygiene).            |

Scoping, as in the JAX pass: RT303/RT305/RT306 stay out of test files
(``test_*.py``, ``tests/``, ``conftest.py``); RT301/RT302/RT304 apply
everywhere. Precision over recall: aliased programs, programs held in
containers and dynamically chosen callees stay silent rather than
guessed at — the runtime twin supplies the dynamic evidence, and
`build_inventory()` is the bridge back (`compile_watch.static_hint`).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .lint import (
    Finding,
    _dotted,
    _is_remote_decorator,
    _iter_py_files,
    _parse_noqa,
    noqa_hygiene,
)

__all__ = [
    "accel_sources",
    "accel_paths",
    "build_inventory",
    "build_inventory_sources",
    "main",
    "RULES",
]

#: id -> one-line title (the --list-rules table).
RULES: Dict[str, str] = {
    "RT301": "instrument/torch.compile/CUDA-graph capture built per call "
             "or in a loop",
    "RT302": "len()-bounded slice reaches a registered program in a loop",
    "RT303": "host sync on a device value in a hot loop",
    "RT304": "state read after an in-place (donating) step took it",
    "RT305": "timing measures an unsynchronized CUDA launch",
    "RT306": "program not registered with compile_watch.instrument",
    "RT390": "stale or unknown '# rt: noqa' suppression (accel family)",
}

_COMPILE_NAMES = {"torch.compile"}
_GRAPH_NAMES = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
                "torch.cuda.make_graphed_callables", "CUDAGraph",
                "make_graphed_callables"}
_TIME_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter",
    "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns",
    "monotonic", "perf_counter",
}
#: Methods that copy a device value to the host (blocking on it).
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: Host materializers taking the value as an argument.
_SYNC_CALLS = {"float", "int", "bool", "np.asarray", "numpy.asarray",
               "np.array", "numpy.array"}
#: Calls that wait for the card without reading a value: they end a
#: pending launch for RT305.
_WAIT_TERMINALS = {"synchronize", "elapsed_time", "_sync", "sync",
                   "cuda_sync"}
_ONETIME_PREFIXES = ("init", "build", "make", "setup", "warm", "test",
                     "main", "create", "bench")


def _is_test_path(path: str) -> bool:
    norm = path.replace(os.sep, "/")
    base = os.path.basename(norm)
    return (
        base.startswith("test_")
        or base == "conftest.py"
        or "/tests/" in norm
        or norm.startswith("tests/")
    )


def _contains_len(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _dotted(sub.func) == "len":
            return True
    return False


def _program_name(node: ast.AST) -> Tuple[Optional[str], Optional[str]]:
    """instrument() first arg -> (name, "literal"|"pattern")."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, "literal"
    if isinstance(node, ast.JoinedStr):
        parts = []
        for piece in node.values:
            if isinstance(piece, ast.Constant):
                parts.append(str(piece.value))
            else:
                parts.append("*")
        return "".join(parts), "pattern"
    return None, None


def _is_instrument(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    dotted = _dotted(call.func)
    return dotted == "instrument" or dotted.endswith(".instrument")


def _is_step_factory(call: ast.AST) -> bool:
    """A `make_*train_step(...)` call: returns (init_fn, step_fn)."""
    if not isinstance(call, ast.Call):
        return False
    terminal = _dotted(call.func).rsplit(".", 1)[-1]
    return terminal.startswith("make_") and terminal.endswith("train_step")


def _donates(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "donate":
            return not (
                isinstance(kw.value, ast.Constant) and kw.value.value is False
            )
    return True


@dataclass
class _Wrap:
    """One program site (phase-1 inventory row)."""

    path: str
    line: int
    col: int
    kind: str  # "instrument" | "torch.compile" | "cuda_graph"
    target: str  # dotted name of the wrapped callable ("" if opaque)
    binding: Optional[Tuple[str, str]]  # ("global"|"self"|"local"|"def", name)
    enclosing: Optional[str] = None  # qualname of the enclosing function
    in_loop: bool = False
    returned: bool = False  # factory idiom: `return instrument(...)`
    registered: bool = False
    program: Optional[str] = None
    program_kind: Optional[str] = None  # "literal" | "pattern"
    hazards: List[dict] = field(default_factory=list)  # RT302, for doctor


@dataclass
class _FnRec:
    """One function body to judge in phase 2."""

    path: str
    qualname: str
    node: ast.AST
    is_remote_method: bool = False
    uses_phase_timer: bool = False


@dataclass
class _ModuleScan:
    path: str
    source: str
    tree: ast.Module
    wraps: List[_Wrap] = field(default_factory=list)
    #: bindings passed to instrument(name, <binding>) -> (program, kind).
    regs: Dict[Tuple[str, str], Tuple[Optional[str], Optional[str]]] = field(
        default_factory=dict
    )
    #: in-place steps handed out by make_*train_step: binding -> donates.
    steps: Dict[Tuple[str, str], bool] = field(default_factory=dict)
    funcs: List[_FnRec] = field(default_factory=list)
    #: (path, line, col, name) of factory-returned steps never registered.
    bare_products: List[Tuple[int, int, str, str]] = field(
        default_factory=list
    )


@dataclass
class _Callee:
    """A registered program as a call site sees it."""

    donate: Tuple[int, ...]
    wrap: Optional[_Wrap]  # None once terminal-name resolution is ambiguous


def _merge_callee(into: Dict[str, _Callee], name: str, cal: _Callee) -> None:
    """Terminal-name registry: collisions keep registeredness but drop
    the wrap and the donation — wrong information is worse than none."""
    prev = into.get(name)
    if prev is None:
        into[name] = cal
    elif prev.wrap is not cal.wrap or prev.donate != cal.donate:
        into[name] = _Callee((), None)


class _Scanner(ast.NodeVisitor):
    """Phase 1: one walk per module collecting program sites, factory
    products and judgeable function bodies."""

    def __init__(self, mod: _ModuleScan):
        self.mod = mod
        self.func_stack: List[Tuple[str, ast.AST, Set[str]]] = []
        self.class_stack: List[Tuple[str, bool]] = []
        self.loop_depth = 0
        self._consumed: Set[int] = set()

    def _make_wrap(self, node: ast.AST, kind: str, target: str,
                   binding=None, returned: bool = False) -> _Wrap:
        wrap = _Wrap(
            path=self.mod.path,
            line=node.lineno,
            col=node.col_offset + 1,
            kind=kind,
            target=target,
            binding=binding,
            enclosing=self.func_stack[-1][0] if self.func_stack else None,
            in_loop=self.loop_depth > 0,
            returned=returned,
        )
        self.mod.wraps.append(wrap)
        self._consumed.add(id(node))
        return wrap

    def _binding_for(self, tgt: ast.expr) -> Optional[Tuple[str, str]]:
        if isinstance(tgt, ast.Name):
            if not self.func_stack:
                return ("global", tgt.id)
            if tgt.id in self.func_stack[-1][2]:  # `global X` declared
                return ("global", tgt.id)
            return ("local", tgt.id)
        if (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
        ):
            return ("self", tgt.attr)
        return None

    def _site(self, value: ast.AST, binding=None, returned: bool = False):
        """Record `value` if it is a program site; returns the wrap."""
        if not isinstance(value, ast.Call) or id(value) in self._consumed:
            return None
        dotted = _dotted(value.func)
        if _is_instrument(value) and len(value.args) >= 2:
            prog, kind = _program_name(value.args[0])
            inner = value.args[1]
            wrap = self._make_wrap(
                value, "instrument",
                _dotted(inner) if not isinstance(inner, ast.Lambda)
                else "<lambda>",
                binding, returned,
            )
            wrap.registered, wrap.program, wrap.program_kind = True, prog, kind
            # instrument(name, torch.compile(f)): the compile is registered.
            if isinstance(inner, ast.Call) and _dotted(inner.func) in _COMPILE_NAMES:
                comp = self._make_wrap(
                    inner, "torch.compile",
                    _dotted(inner.args[0]) if inner.args else "",
                )
                comp.registered, comp.program, comp.program_kind = (
                    True, prog, kind)
            key = self._binding_for(inner)
            if key is not None:
                self.mod.regs[key] = (prog, kind)
                if key[0] == "local":
                    self.mod.regs[("global", key[1])] = (prog, kind)
            return wrap
        if dotted in _COMPILE_NAMES:
            return self._make_wrap(
                value, "torch.compile",
                _dotted(value.args[0]) if value.args else "",
                binding, returned,
            )
        if dotted in _GRAPH_NAMES:
            return self._make_wrap(value, "cuda_graph", dotted, binding,
                                   returned)
        return None

    # -- visits --------------------------------------------------------
    def visit_Global(self, node: ast.Global) -> None:
        if self.func_stack:
            self.func_stack[-1][2].update(node.names)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        is_actor = any(_is_remote_decorator(d) for d in node.decorator_list)
        self.class_stack.append((node.name, is_actor))
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node) -> None:
        qual = ".".join(
            [c for c, _ in self.class_stack]
            + [f[0].rsplit(".", 1)[-1] for f in self.func_stack]
            + [node.name]
        )
        uses_timer = any(
            isinstance(sub, ast.Call)
            and _dotted(sub.func).endswith("phase_timer")
            for sub in ast.walk(node)
        )
        in_actor = bool(self.class_stack) and self.class_stack[-1][1]
        decorated_remote = any(
            _is_remote_decorator(d) for d in node.decorator_list
        )
        self.mod.funcs.append(
            _FnRec(
                path=self.mod.path,
                qualname=qual,
                node=node,
                is_remote_method=in_actor or decorated_remote,
                uses_phase_timer=uses_timer,
            )
        )
        for dec in node.decorator_list:
            head = dec.func if isinstance(dec, ast.Call) else dec
            if _dotted(head) in _COMPILE_NAMES:
                wrap = self._make_wrap(dec, "torch.compile", qual,
                                       binding=("def", node.name))
                wrap.line = node.lineno
        if node.name.startswith("make_"):
            self._factory_products(node)
        outer_loop, self.loop_depth = self.loop_depth, 0
        self.func_stack.append((qual, node, set()))
        self.generic_visit(node)
        self.func_stack.pop()
        self.loop_depth = outer_loop

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _factory_products(self, node) -> None:
        """The steps a make_* factory returns must be registered: a
        nested def whose name holds "step", returned by name, must be
        rebound from instrument(...) in the factory first."""
        nested = {
            stmt.name for stmt in node.body
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        registered: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and _is_instrument(sub.value):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        registered.add(tgt.id)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Return) or sub.value is None:
                continue
            elts = (sub.value.elts if isinstance(sub.value, ast.Tuple)
                    else [sub.value])
            for elt in elts:
                if (
                    isinstance(elt, ast.Name)
                    and elt.id in nested
                    and "step" in elt.id
                    and elt.id not in registered
                ):
                    self.mod.bare_products.append(
                        (elt.lineno, elt.col_offset + 1, elt.id, node.name)
                    )

    def _visit_loop(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def visit_Assign(self, node: ast.Assign) -> None:
        binding = (
            self._binding_for(node.targets[0])
            if len(node.targets) == 1
            else None
        )
        self._site(node.value, binding)
        if _is_step_factory(node.value) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, (ast.Tuple, ast.List)) and len(tgt.elts) == 2:
                key = self._binding_for(tgt.elts[1])
                if key is not None:
                    self.mod.steps[key] = _donates(node.value)
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return) -> None:
        if node.value is not None:
            self._site(node.value, returned=True)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            self._site(item.context_expr)
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        self._site(node)
        self.generic_visit(node)


def _scan_module(path: str, source: str, tree: ast.Module) -> _ModuleScan:
    mod = _ModuleScan(path=path, source=source, tree=tree)
    _Scanner(mod).visit(tree)
    # Name-flow registrations: c = torch.compile(f); instrument("n", c).
    for wrap in mod.wraps:
        if wrap.registered or wrap.binding is None:
            continue
        reg = mod.regs.get(wrap.binding)
        if reg is None and wrap.binding[0] == "def":
            reg = mod.regs.get(("global", wrap.binding[1]))
        if reg is not None:
            wrap.registered = True
            wrap.program, wrap.program_kind = reg
    return mod


def _forwarders(mod: _ModuleScan) -> Dict[str, _Wrap]:
    """Module-level `def f(...): return <registered global>(...)`."""
    by_global: Dict[str, _Wrap] = {}
    for wrap in mod.wraps:
        if (wrap.kind == "instrument" and wrap.binding
                and wrap.binding[0] == "global"):
            by_global[wrap.binding[1]] = wrap
    out: Dict[str, _Wrap] = {}
    if not by_global:
        return out
    for node in mod.tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for stmt in ast.walk(node):
            if (
                isinstance(stmt, ast.Return)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Name)
                and stmt.value.func.id in by_global
            ):
                out[node.name] = by_global[stmt.value.func.id]
                break
    return out


# ---------------------------------------------------------------------------
# phase 2: per-function judgment
# ---------------------------------------------------------------------------


class _FuncJudge:
    """Linear, source-order walk of one function body tracking device
    values, the pending launch, live donations and clock reads."""

    def __init__(
        self,
        rec: _FnRec,
        callees: Dict[str, _Callee],
        self_callees: Dict[str, _Callee],
        local_callees: Dict[str, _Callee],
        findings: List[Finding],
        in_test_file: bool,
    ):
        self.rec = rec
        self.callees = callees
        self.self_callees = self_callees
        self.local_callees = local_callees
        self.findings = findings
        self.in_test_file = in_test_file
        self.tainted: Set[str] = set()
        self.time_vars: Set[str] = set()
        self.pending_dispatch = False
        self.pending_line = 0
        self.donated: Dict[str, Tuple[int, str]] = {}  # name -> (line, callee)
        self.loop_depth = 0
        self.hot_reason: Optional[str] = None
        if rec.uses_phase_timer:
            self.hot_reason = "billed by step_telemetry.phase_timer"
        elif rec.is_remote_method:
            self.hot_reason = "@rt.remote dispatch path"

    # -- entry ---------------------------------------------------------
    def run(self) -> None:
        body = getattr(self.rec.node, "body", [])
        if self.hot_reason is None and self._has_program_loop(body):
            self.hot_reason = "loop dispatches a registered program"
        for stmt in body:
            self._stmt(stmt)

    def _has_program_loop(self, body) -> bool:
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.For, ast.AsyncFor, ast.While)):
                    for inner in ast.walk(sub):
                        if (isinstance(inner, ast.Call)
                                and self._callee(inner) is not None):
                            return True
        return False

    def _callee(self, call: ast.Call) -> Optional[_Callee]:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in self.local_callees:
                return self.local_callees[func.id]
            return self.callees.get(func.id)
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                return self.self_callees.get(func.attr)
            return self.callees.get(func.attr)
        return None

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(
                path=self.rec.path,
                line=getattr(node, "lineno", 1),
                col=getattr(node, "col_offset", 0) + 1,
                rule=rule,
                message=message,
            )
        )

    def _hot_now(self) -> bool:
        return (
            self.loop_depth > 0
            and self.hot_reason is not None
            and not self.in_test_file
        )

    def _sync(self, node: ast.AST, what: str) -> None:
        """A host sync on a device value: RT303 in a hot loop; it also
        ends a pending launch."""
        if self._hot_now():
            self._emit(
                "RT303",
                node,
                f"{self.rec.qualname} {what} inside a hot loop "
                f"({self.hot_reason}) — each one blocks the host until "
                f"the card drains; keep the value on the device or move "
                f"the copy out of the loop",
            )
        self.pending_dispatch = False

    # -- statements ----------------------------------------------------
    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # judged as their own records
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            if stmt.value is None:
                return
            taint = self._expr(stmt.value)
            is_time = (
                isinstance(stmt.value, ast.Call)
                and _dotted(stmt.value.func) in _TIME_CALLS
            )
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for tgt in targets:
                self._store(tgt, taint, is_time)
        elif isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value)
            if isinstance(stmt.target, ast.Name):
                self._load_name(stmt.target)
        elif isinstance(stmt, ast.Expr):
            self._expr(stmt.value)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._expr(stmt.value)
        elif isinstance(stmt, ast.If):
            self._branch_test(stmt.test)
            for s in stmt.body + stmt.orelse:
                self._stmt(s)
        elif isinstance(stmt, ast.While):
            self.loop_depth += 1
            self._branch_test(stmt.test)
            for s in stmt.body:
                self._stmt(s)
            self.loop_depth -= 1
            for s in stmt.orelse:
                self._stmt(s)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter)
            self.loop_depth += 1
            for s in stmt.body:
                self._stmt(s)
            self.loop_depth -= 1
            for s in stmt.orelse:
                self._stmt(s)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr)
            for s in stmt.body:
                self._stmt(s)
        elif isinstance(stmt, ast.Try):
            for s in stmt.body:
                self._stmt(s)
            for handler in stmt.handlers:
                for s in handler.body:
                    self._stmt(s)
            for s in stmt.orelse + stmt.finalbody:
                self._stmt(s)
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child)

    def _store(self, tgt: ast.expr, taint: bool, is_time: bool) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._store(elt, taint, False)
            return
        if isinstance(tgt, ast.Starred):
            self._store(tgt.value, taint, False)
            return
        if isinstance(tgt, ast.Name):
            self.donated.pop(tgt.id, None)  # rebound — the donation is over
            self.time_vars.discard(tgt.id)
            if is_time:
                self.time_vars.add(tgt.id)
            if taint:
                self.tainted.add(tgt.id)
            else:
                self.tainted.discard(tgt.id)
        elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
            self._expr(tgt.value)

    def _branch_test(self, test: ast.expr) -> None:
        if self._expr(test):
            self._sync(test, "branches on a device value (an implicit "
                             "bool())")

    # -- expressions ---------------------------------------------------
    def _load_name(self, node: ast.Name) -> bool:
        if node.id in self.donated:
            line, callee = self.donated.pop(node.id)
            self._emit(
                "RT304",
                node,
                f"{self.rec.qualname} reads '{node.id}' after passing it "
                f"to {callee} (line {line}), which updates it in place — "
                f"it already holds the new step; use the returned state, "
                f"or build the step with donate=False",
            )
        return node.id in self.tainted

    def _expr(self, node: Optional[ast.expr]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return self._load_name(node)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.BinOp):
            return self._binop(node)
        if isinstance(node, ast.BoolOp):
            return any([self._expr(v) for v in node.values])
        if isinstance(node, ast.UnaryOp):
            return self._expr(node.operand)
        if isinstance(node, ast.Compare):
            got = self._expr(node.left)
            for cmp in node.comparators:
                got = self._expr(cmp) or got
            return got
        if isinstance(node, ast.Subscript):
            got = self._expr(node.value)
            self._expr(node.slice)
            return got
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                self._expr(part)
            return False
        if isinstance(node, ast.Attribute):
            return self._expr(node.value)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self._expr(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            got = False
            for k, v in zip(node.keys, node.values):
                got = (self._expr(k) if k is not None else False) or got
                got = self._expr(v) or got
            return got
        if isinstance(node, ast.IfExp):
            self._expr(node.test)
            return self._expr(node.body) or self._expr(node.orelse)
        if isinstance(node, (ast.Starred, ast.Await, ast.Yield,
                             ast.YieldFrom)):
            return self._expr(node.value)
        if isinstance(node, ast.JoinedStr):
            return any(
                self._expr(v.value)
                for v in node.values
                if isinstance(v, ast.FormattedValue)
            )
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            # A separate scope: no judgments inside, but a sync in the
            # element expression still ends a pending launch.
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and (
                    _dotted(sub.func) in _SYNC_CALLS
                    or _dotted(sub.func).rsplit(".", 1)[-1]
                    in _SYNC_METHODS | _WAIT_TERMINALS
                ):
                    self.pending_dispatch = False
                    break
            return False
        if isinstance(node, ast.Lambda):
            return False
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)
        return False

    def _binop(self, node: ast.BinOp) -> bool:
        left_is_clock = (
            isinstance(node.left, ast.Call)
            and _dotted(node.left.func) in _TIME_CALLS
        ) or (
            isinstance(node.left, ast.Name) and node.left.id in self.time_vars
        )
        right_is_timevar = (
            isinstance(node.right, ast.Name) and node.right.id in self.time_vars
        )
        if isinstance(node.op, ast.Sub) and right_is_timevar and left_is_clock:
            if self.pending_dispatch and not self.in_test_file:
                self._emit(
                    "RT305",
                    node,
                    f"{self.rec.qualname} reads the clock after launching a "
                    f"registered program (line {self.pending_line}) with no "
                    f"torch.cuda.synchronize(), event sync or host copy in "
                    f"between — the elapsed time measures the launch, not "
                    f"the work",
                )
            self.pending_dispatch = False
            return False
        got = self._expr(node.left)
        return self._expr(node.right) or got

    def _call(self, node: ast.Call) -> bool:
        dotted = _dotted(node.func)
        terminal = dotted.rsplit(".", 1)[-1] if dotted else ""
        if dotted == "torch.cuda.synchronize":
            for arg in node.args:
                self._expr(arg)
            self._sync(node, "calls torch.cuda.synchronize()")
            return False
        if terminal in _WAIT_TERMINALS:
            got = False
            for arg in node.args:
                got = self._expr(arg) or got
            if isinstance(node.func, ast.Attribute):
                self._expr(node.func.value)
            self.pending_dispatch = False
            return got
        callee = self._callee(node)
        if callee is not None:
            self._program_call(node, callee)
            return True
        if dotted in _SYNC_CALLS and len(node.args) >= 1:
            taint = any([self._expr(a) for a in node.args])
            if taint:
                self._sync(node, f"calls {dotted}() on a device value")
            return False
        if (terminal in _SYNC_METHODS
                and isinstance(node.func, ast.Attribute)):
            taint = self._expr(node.func.value)
            for arg in node.args:
                self._expr(arg)
            if taint:
                self._sync(node, f"calls .{terminal}() on a device value")
            return False
        got = False
        for arg in node.args:
            got = self._expr(arg) or got
        for kw in node.keywords:
            got = self._expr(kw.value) or got
        if isinstance(node.func, ast.Attribute):
            got = self._expr(node.func.value) or got
        return got

    def _program_call(self, node: ast.Call, callee: _Callee) -> None:
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if self.loop_depth > 0:
                self._shape_hazard(node, callee, arg)
            self._expr(arg)
        for idx in callee.donate:
            if idx < len(node.args) and isinstance(node.args[idx], ast.Name):
                name = node.args[idx].id
                self.donated[name] = (node.lineno, _dotted(node.func))
        self.pending_dispatch = True
        self.pending_line = node.lineno

    def _shape_hazard(self, node: ast.Call, callee: _Callee,
                      arg: ast.expr) -> None:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Subscript):
                slices = (sub.slice.elts if isinstance(sub.slice, ast.Tuple)
                          else [sub.slice])
                for piece in slices:
                    if not isinstance(piece, ast.Slice):
                        continue
                    if any(b is not None and _contains_len(b)
                           for b in (piece.lower, piece.upper)):
                        self._hazard(node, callee)
                        return

    def _hazard(self, node: ast.Call, callee: _Callee) -> None:
        message = (
            f"{self.rec.qualname}: a len()-bounded slice reaches "
            f"{_dotted(node.func)} in a loop — the operand's shape drifts "
            f"per batch, a new signature every call; pad to a fixed "
            f"bucket instead"
        )
        self._emit("RT302", node, message)
        if callee.wrap is not None:
            callee.wrap.hazards.append(
                {
                    "rule": "RT302",
                    "path": self.rec.path,
                    "line": node.lineno,
                    "message": message,
                }
            )


# ---------------------------------------------------------------------------
# whole-program drivers
# ---------------------------------------------------------------------------


def _scan_all(sources: Sequence[Tuple[str, str]]):
    mods: List[_ModuleScan] = []
    parse_errors: List[Finding] = []
    for path, source in sources:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            parse_errors.append(
                Finding(
                    path=path,
                    line=e.lineno or 1,
                    col=(e.offset or 0) + 1,
                    rule="RT000",
                    message=f"file does not parse: {e.msg}",
                )
            )
            continue
        mods.append(_scan_module(path, source, tree))
    return mods, parse_errors


def _callee_registry(mods: Sequence[_ModuleScan]):
    """Cross-module terminal-name registry of registered programs."""
    callees: Dict[str, _Callee] = {}
    self_callees: Dict[str, _Callee] = {}
    for mod in mods:
        for wrap in mod.wraps:
            if wrap.kind != "instrument" or wrap.binding is None:
                continue
            scope, name = wrap.binding
            if scope == "global":
                _merge_callee(callees, name, _Callee((), wrap))
            elif scope == "self":
                _merge_callee(self_callees, name, _Callee((), wrap))
        for fname, wrap in _forwarders(mod).items():
            _merge_callee(callees, fname, _Callee((), wrap))
        for (scope, name), donates in mod.steps.items():
            cal = _Callee((0,) if donates else (), None)
            if scope == "global":
                _merge_callee(callees, name, cal)
            elif scope == "self":
                _merge_callee(self_callees, name, cal)
    return callees, self_callees


def _local_callees(mod: _ModuleScan, rec: _FnRec) -> Dict[str, _Callee]:
    """Registered programs and in-place steps bound to locals of `rec`."""
    out: Dict[str, _Callee] = {}
    for wrap in mod.wraps:
        if (wrap.kind == "instrument" and wrap.binding
                and wrap.binding[0] == "local"
                and wrap.enclosing == rec.qualname):
            out[wrap.binding[1]] = _Callee((), wrap)
    for stmt in ast.walk(rec.node):
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and _is_step_factory(stmt.value)):
            tgt = stmt.targets[0]
            if (isinstance(tgt, (ast.Tuple, ast.List)) and len(tgt.elts) == 2
                    and isinstance(tgt.elts[1], ast.Name)):
                out[tgt.elts[1].id] = _Callee(
                    (0,) if _donates(stmt.value) else (), None)
    return out


def _judge(mods: Sequence[_ModuleScan]) -> List[Finding]:
    findings: List[Finding] = []
    callees, self_callees = _callee_registry(mods)
    for mod in mods:
        in_test = _is_test_path(mod.path)
        for wrap in mod.wraps:
            findings.extend(_judge_rt301(wrap))
            if (wrap.kind == "torch.compile" and not wrap.registered
                    and not in_test):
                findings.append(
                    Finding(
                        path=wrap.path, line=wrap.line, col=wrap.col,
                        rule="RT306",
                        message=(
                            f"torch.compile of "
                            f"{wrap.target or '<anonymous>'} is invisible "
                            f"to the compile watch — wrap it in "
                            f"compile_watch.instrument('<name>', ...) so "
                            f"its recompiles attribute to a named program "
                            f"instead of (unregistered)"
                        ),
                    )
                )
        if not in_test:
            for line, col, name, factory in mod.bare_products:
                findings.append(
                    Finding(
                        path=mod.path, line=line, col=col, rule="RT306",
                        message=(
                            f"{factory}() returns the step {name!r} "
                            f"unregistered — rebind it through "
                            f"compile_watch.instrument('<name>', {name}) "
                            f"so the watch can name its signatures"
                        ),
                    )
                )
        for rec in mod.funcs:
            _FuncJudge(
                rec, callees, self_callees, _local_callees(mod, rec),
                findings, in_test,
            ).run()
    return findings


def _judge_rt301(wrap: _Wrap) -> List[Finding]:
    what = {"instrument": "compile_watch.instrument",
            "torch.compile": "torch.compile",
            "cuda_graph": "a CUDA-graph capture"}[wrap.kind]
    if wrap.in_loop:
        return [
            Finding(
                path=wrap.path, line=wrap.line, col=wrap.col, rule="RT301",
                message=(
                    f"{what} built inside a loop — a fresh program every "
                    f"iteration; hoist it out of the loop"
                ),
            )
        ]
    if wrap.enclosing is None or wrap.returned:
        return []  # module level, or a factory returning the program
    if wrap.binding is not None and wrap.binding[0] in ("global", "def"):
        return []  # lazy module-global cache idiom / decorated def
    fn_name = wrap.enclosing.rsplit(".", 1)[-1].lstrip("_").lower()
    if fn_name.startswith(_ONETIME_PREFIXES) or (
        wrap.enclosing.rsplit(".", 1)[-1].startswith("__")
        and wrap.enclosing.endswith("__")
    ):
        return []
    return [
        Finding(
            path=wrap.path, line=wrap.line, col=wrap.col, rule="RT301",
            message=(
                f"{what} built in the body of {wrap.enclosing}() — a "
                f"fresh program per call; build it once (module scope, "
                f"__init__ or a factory) and reuse it"
            ),
        )
    ]


def _rule_filter(rules: Optional[Iterable[str]]) -> Optional[Set[str]]:
    if rules is None:
        return None
    wanted = {r.upper() for r in rules}
    unknown = wanted - set(RULES)
    if unknown:
        raise ValueError(f"unknown rule id(s): {', '.join(sorted(unknown))}")
    return wanted


def accel_sources(
    sources: Sequence[Tuple[str, str]],
    rules: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Analyze a set of (path, source) blobs as one program."""
    only = _rule_filter(rules)
    mods, findings = _scan_all(sources)
    findings = findings + _judge(mods)
    noqa_by_path = {mod.path: _parse_noqa(mod.source) for mod in mods}
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
    # Noqa hygiene (RT390) judges the RAW findings, and is itself
    # exempt from suppression.
    if only is None or "RT390" in only:
        for mod in mods:
            kept.extend(
                noqa_hygiene(
                    mod.path,
                    mod.source,
                    findings,
                    family_digit="3",
                    known_ids=set(RULES),
                    hygiene_id="RT390",
                )
            )
    uniq: Dict[Tuple[str, int, str], Finding] = {}
    for f in kept:
        uniq.setdefault((f.path, f.line, f.rule), f)
    out = list(uniq.values())
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def _read_sources(paths: Sequence[str]):
    sources: List[Tuple[str, str]] = []
    findings: List[Finding] = []
    for file_path in _iter_py_files(paths):
        try:
            with open(file_path, "r", encoding="utf-8") as f:
                sources.append((file_path, f.read()))
        except (OSError, UnicodeDecodeError) as e:
            findings.append(
                Finding(path=file_path, line=1, col=1, rule="RT000",
                        message=f"unreadable: {e}")
            )
    return sources, findings


def accel_paths(
    paths: Sequence[str], rules: Optional[Iterable[str]] = None
) -> List[Finding]:
    sources, findings = _read_sources(paths)
    findings.extend(accel_sources(sources, rules))
    return findings


# ---------------------------------------------------------------------------
# inventory (the doctor bridge)
# ---------------------------------------------------------------------------


def build_inventory_sources(sources: Sequence[Tuple[str, str]]) -> dict:
    """Machine-readable program inventory: every `instrument` and
    `torch.compile` site, its program name (if registered), and its
    RT302 hazards. `compile_watch.static_hint()` resolves a live
    storm's program name against it."""
    mods, _ = _scan_all(sources)
    _judge(mods)  # populates wrap.hazards
    programs = []
    for mod in mods:
        for wrap in mod.wraps:
            if wrap.kind == "cuda_graph":
                continue
            programs.append(
                {
                    "program": wrap.program,
                    "name_kind": wrap.program_kind,
                    "path": wrap.path,
                    "line": wrap.line,
                    "wrap": wrap.kind,
                    "target": wrap.target or None,
                    "registered": wrap.registered,
                    "hazards": list(wrap.hazards),
                }
            )
    return {
        "version": 1,
        "programs": programs,
        "unregistered": [
            {"path": p["path"], "line": p["line"], "target": p["target"]}
            for p in programs
            if not p["registered"]
        ],
    }


def build_inventory(paths: Sequence[str]) -> dict:
    sources, _ = _read_sources(paths)
    return build_inventory_sources(sources)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    """CLI body of `python -m ray_tpu_torch.devtools.accel`. Exit codes
    mirror lint/check/race: 0 clean, 1 findings, 2 usage/IO errors."""
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.accel",
        description=(
            "accelerator hot-path analyzer for PyTorch code (rules "
            "RT301-RT306; suppress with '# rt: noqa[RT3xx]')"
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
        "--json", action="store_true", dest="as_json",
        help="emit findings as a JSON list (CI mode)",
    )
    parser.add_argument(
        "--rules", help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    parser.add_argument(
        "--inventory", action="store_true",
        help=(
            "emit the program inventory JSON (instrument and "
            "torch.compile sites, RT302 hazards) instead of findings — "
            "the doctor bridge"
        ),
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
        print(f"accel: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    if args.inventory:
        print(json.dumps(build_inventory(args.paths), indent=2), file=out)
        return 0
    only = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    try:
        findings = accel_paths(args.paths, only)
    except ValueError as e:
        print(f"accel: {e}", file=sys.stderr)
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
