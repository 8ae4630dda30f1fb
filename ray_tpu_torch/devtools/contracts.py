# Copied from ray_tpu/devtools/contracts.py.
"""Phase 1 of the whole-program contract checker: the symbol table.

`ray_tpu_torch lint` (rules.py) is deliberately single-file and syntactic;
the contract bugs that survive it are *cross-program*: a `.remote()`
call whose arity drifted from the decorated signature, an `.options()`
key the submission path silently ignores, a `client.call("m", ...)`
site naming a handler that no server registers, call-site kwargs that
no longer match the method's `wire.SCHEMAS` entry. Those need one pass
that sees every file before any file is judged.

This module builds that view. `build_symbol_table(paths)` parses every
source file once and extracts:

* every ``@rt.remote`` function and actor class, with its resolved
  signature (positional/keyword/defaults/varargs) and decorator
  options;
* every RPC handler registration — explicit ``server.register("m",
  fn)`` string literals AND the daemon's registration-loop idiom
  (``for name in ["a", "b", ...]: server.register(name,
  getattr(self, "_h_" + name))``);
* every ``wire.SCHEMAS``-style per-method argument schema (a module
  assigning ``SCHEMAS = {"method": {"field": type, ...}, ...}``);
* every RPC call site (``.call/.notify/.call_async("m", ...)`` with a
  string-literal method) and its keyword names;
* per-module name bindings (decorated defs + ``from x import y``)
  so phase 2 (check.py) can resolve receivers;
* a *liveness witness* set: every other string constant in the tree
  equal to some handler name (a method dispatched dynamically —
  ``_bundle_call(nid, "prepare_bundle", ...)`` — is alive even though
  no literal ``.call("prepare_bundle")`` exists).

The option-key universe is NOT re-derived here: it is imported from
``ray_tpu_torch._private.options`` — the same table the runtime validator
enforces, so the static and runtime halves of RT102 can never drift
from each other.

Parsed sources and per-file noqa maps ride along in the table so
phase 2 walks each tree exactly once more without re-reading files.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .lint import _dotted, _is_remote_decorator, _parse_noqa

#: RPC client verbs whose first string-literal argument names a wire
#: method, mapped to the client-side kwargs that never reach the
#: handler (RpcClient.call(method, timeout=..., retries=..., **kwargs)).
RPC_VERBS: Dict[str, frozenset] = {
    "call": frozenset({"timeout", "retries"}),
    "call_async": frozenset({"callback"}),
    "notify": frozenset(),
}


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------


@dataclass
class Signature:
    """Callable shape, reduced to what arity checking needs."""

    params: List[str]  # posonly + positional-or-keyword, in order
    posonly: int  # first `posonly` of params are positional-only
    defaults: int  # trailing params carrying defaults
    kwonly: Dict[str, bool]  # name -> has default
    vararg: bool
    kwarg: bool

    @property
    def required_positional(self) -> int:
        return len(self.params) - self.defaults

    def keyword_names(self) -> Set[str]:
        return set(self.params[self.posonly:]) | set(self.kwonly)


def signature_of(node, skip_first: bool = False) -> Signature:
    """Signature from an ast.FunctionDef/AsyncFunctionDef; `skip_first`
    drops the bound receiver (self/cls) for methods."""
    a = node.args
    posonly = [p.arg for p in a.posonlyargs]
    pos = [p.arg for p in a.args]
    params = posonly + pos
    n_posonly = len(posonly)
    if skip_first and params:
        params = params[1:]
        n_posonly = max(0, n_posonly - 1)
    defaults = len(a.defaults)
    kwonly = {
        p.arg: d is not None
        for p, d in zip(a.kwonlyargs, a.kw_defaults)
    }
    return Signature(
        params=params,
        posonly=n_posonly,
        defaults=min(defaults, len(params)),
        kwonly=kwonly,
        vararg=a.vararg is not None,
        kwarg=a.kwarg is not None,
    )


# ---------------------------------------------------------------------------
# symbols
# ---------------------------------------------------------------------------


@dataclass
class RemoteFunc:
    name: str
    path: str
    lineno: int
    sig: Signature
    options: Dict[str, ast.expr]  # decorator keyword options


@dataclass
class RemoteActor:
    name: str
    path: str
    lineno: int
    init: Signature  # __init__ minus self ((), no-arg if absent)
    methods: Dict[str, Signature]
    options: Dict[str, ast.expr]
    #: True when the class has any base besides `object`: inherited
    #: methods are invisible to the body scan, so unknown-method
    #: judgments must stay silent (precision over recall).
    has_bases: bool = False


@dataclass
class Handler:
    method: str
    path: str
    lineno: int


@dataclass
class CallSite:
    method: str
    path: str
    lineno: int
    col: int
    verb: str  # call | notify | call_async
    kwargs: Set[str]
    has_star_kwargs: bool


@dataclass
class SchemaField:
    optional: bool
    #: Accepted python types, or None when the spec expression could
    #: not be resolved statically (treated as "any").
    types: Optional[Tuple[type, ...]]


@dataclass
class ParsedFile:
    path: str
    source: str
    tree: ast.Module
    noqa: Dict[int, Optional[set]]


@dataclass
class SymbolTable:
    files: List[ParsedFile] = field(default_factory=list)
    #: (path, name) -> symbol, plus import-resolved aliases.
    bindings: Dict[str, Dict[str, object]] = field(default_factory=dict)
    functions_by_name: Dict[str, List[RemoteFunc]] = field(
        default_factory=dict
    )
    actors_by_name: Dict[str, List[RemoteActor]] = field(
        default_factory=dict
    )
    handlers: Dict[str, List[Handler]] = field(default_factory=dict)
    call_sites: List[CallSite] = field(default_factory=list)
    schemas: Dict[str, Dict[str, SchemaField]] = field(
        default_factory=dict
    )
    #: String constants seen OUTSIDE registration/schema contexts —
    #: dynamic-dispatch liveness witnesses for the dead-handler rule.
    witnesses: Set[str] = field(default_factory=set)
    #: (path, lineno) -> symbol defined at that site. Phase 2 binds
    #: these scope-aware as it walks, so two test functions each
    #: defining `@rt.remote class A` resolve to THEIR A, not the
    #: file's last one.
    by_def: Dict[Tuple[str, int], object] = field(default_factory=dict)
    #: (path, name) import edges resolved after all files parse.
    _imports: List[Tuple[str, str, str]] = field(default_factory=list)

    def resolve(self, path: str, name: str):
        """Receiver name -> RemoteFunc/RemoteActor, or None. Module
        bindings win; an unambiguous global name resolves anywhere
        (whole-program fallback for receivers built elsewhere)."""
        sym = self.bindings.get(path, {}).get(name)
        if sym is not None:
            return sym
        funcs = self.functions_by_name.get(name, [])
        actors = self.actors_by_name.get(name, [])
        if len(funcs) + len(actors) == 1:
            return (funcs or actors)[0]
        return None


# ---------------------------------------------------------------------------
# schema-expression decoding
# ---------------------------------------------------------------------------

_TYPE_NAMES = {
    "str": str,
    "int": int,
    "float": float,
    "bool": bool,
    "bytes": bytes,
    "dict": dict,
    "list": list,
    "tuple": tuple,
    "_num": (int, float),
}


def _decode_type_expr(node: ast.expr) -> Optional[Tuple[type, ...]]:
    """Schema value expression -> accepted-type tuple, or None for
    "couldn't resolve; accept anything". Handles the registry's
    idioms: bare names, `_num`, `type(None)`, tuples, and `+`-joined
    tuples."""

    def one(n) -> Optional[tuple]:
        if isinstance(n, ast.Name):
            t = _TYPE_NAMES.get(n.id)
            if t is None:
                return None
            return t if isinstance(t, tuple) else (t,)
        # type(None)
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name)
            and n.func.id == "type"
            and len(n.args) == 1
            and isinstance(n.args[0], ast.Constant)
            and n.args[0].value is None
        ):
            return (type(None),)
        if isinstance(n, ast.Tuple):
            out: tuple = ()
            for element in n.elts:
                part = one(element)
                if part is None:
                    return None
                out += part
            return out
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add):
            left, right = one(n.left), one(n.right)
            if left is None or right is None:
                return None
            return left + right
        return None

    return one(node)


# ---------------------------------------------------------------------------
# per-file extraction
# ---------------------------------------------------------------------------


class _FileScanner(ast.NodeVisitor):
    """One walk per file collecting every phase-1 fact."""

    def __init__(self, path: str, table: SymbolTable):
        self.path = path
        self.table = table
        self.bindings = table.bindings.setdefault(path, {})
        #: Constant nodes consumed by registration lists / register()
        #: first args / schema keys — excluded from liveness witnesses.
        self._consumed: Set[int] = set()
        self._strings: List[str] = []
        self._class_depth = 0

    # -- decorated defs ------------------------------------------------
    def _decorator_options(self, node) -> Dict[str, ast.expr]:
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and _is_remote_decorator(dec):
                return {
                    kw.arg: kw.value
                    for kw in dec.keywords
                    if kw.arg is not None
                }
        return {}

    def visit_FunctionDef(self, node, async_=False):
        if self._class_depth == 0 and any(
            _is_remote_decorator(d) for d in node.decorator_list
        ):
            sym = RemoteFunc(
                name=node.name,
                path=self.path,
                lineno=node.lineno,
                sig=signature_of(node),
                options=self._decorator_options(node),
            )
            self.table.functions_by_name.setdefault(
                node.name, []
            ).append(sym)
            self.bindings[node.name] = sym
            self.table.by_def[(self.path, node.lineno)] = sym
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef):
        if any(_is_remote_decorator(d) for d in node.decorator_list):
            init = Signature([], 0, 0, {}, False, False)
            methods: Dict[str, Signature] = {}
            for item in node.body:
                if not isinstance(
                    item, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                is_static = any(
                    isinstance(d, ast.Name) and d.id == "staticmethod"
                    for d in item.decorator_list
                )
                sig = signature_of(item, skip_first=not is_static)
                if item.name == "__init__":
                    init = sig
                elif not item.name.startswith("_"):
                    methods[item.name] = sig
            has_bases = any(
                not (isinstance(b, ast.Name) and b.id == "object")
                for b in node.bases
            )
            sym = RemoteActor(
                name=node.name,
                path=self.path,
                lineno=node.lineno,
                init=init,
                methods=methods,
                options=self._decorator_options(node),
                has_bases=has_bases,
            )
            self.table.actors_by_name.setdefault(node.name, []).append(
                sym
            )
            self.bindings[node.name] = sym
            self.table.by_def[(self.path, node.lineno)] = sym
        self._class_depth += 1
        self.generic_visit(node)
        self._class_depth -= 1

    # -- imports -------------------------------------------------------
    def visit_ImportFrom(self, node: ast.ImportFrom):
        for alias in node.names:
            local = alias.asname or alias.name
            # Resolved after every file is parsed (the target may not
            # have been scanned yet).
            self.table._imports.append((self.path, local, alias.name))
        self.generic_visit(node)

    # -- handlers, call sites, schemas ---------------------------------
    def visit_Call(self, node: ast.Call):
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if (
                attr == "register"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                lit = node.args[0]
                self._consumed.add(id(lit))
                self.table.handlers.setdefault(lit.value, []).append(
                    Handler(lit.value, self.path, lit.lineno)
                )
            elif (
                attr in RPC_VERBS
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                self.table.call_sites.append(
                    CallSite(
                        method=node.args[0].value,
                        path=self.path,
                        lineno=node.lineno,
                        col=node.col_offset + 1,
                        verb=attr,
                        kwargs={
                            kw.arg
                            for kw in node.keywords
                            if kw.arg is not None
                        },
                        has_star_kwargs=any(
                            kw.arg is None for kw in node.keywords
                        ),
                    )
                )
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        # Registration-loop idiom: for name in ["a", ...]:
        #     server.register(name, getattr(self, "_h_" + name))
        if (
            isinstance(node.target, ast.Name)
            and isinstance(node.iter, (ast.List, ast.Tuple))
            and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in node.iter.elts
            )
        ):
            target = node.target.id
            registers = any(
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "register"
                and sub.args
                and isinstance(sub.args[0], ast.Name)
                and sub.args[0].id == target
                for stmt in node.body
                for sub in ast.walk(stmt)
            )
            if registers:
                for element in node.iter.elts:
                    self._consumed.add(id(element))
                    self.table.handlers.setdefault(
                        element.value, []
                    ).append(
                        Handler(
                            element.value, self.path, element.lineno
                        )
                    )
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        # SCHEMAS = {"method": {"field": type, ...}, ...}
        if (
            any(
                isinstance(t, ast.Name) and t.id == "SCHEMAS"
                for t in node.targets
            )
            and isinstance(node.value, ast.Dict)
        ):
            for key, value in zip(node.value.keys, node.value.values):
                if not (
                    isinstance(key, ast.Constant)
                    and isinstance(key.value, str)
                    and isinstance(value, ast.Dict)
                ):
                    continue
                self._consumed.add(id(key))
                fields: Dict[str, SchemaField] = {}
                for fk, fv in zip(value.keys, value.values):
                    if not (
                        isinstance(fk, ast.Constant)
                        and isinstance(fk.value, str)
                    ):
                        continue
                    raw = fk.value
                    optional = raw.startswith("?")
                    fields[raw[1:] if optional else raw] = SchemaField(
                        optional=optional,
                        types=_decode_type_expr(fv),
                    )
                self.table.schemas[key.value] = fields
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant):
        if isinstance(node.value, str) and id(node) not in self._consumed:
            self._strings.append(node.value)

    def finish(self):
        # Witnesses are filtered against handler names later (cheap
        # set intersection once every file contributed its handlers).
        self.table.witnesses.update(self._strings)


# ---------------------------------------------------------------------------
# table construction
# ---------------------------------------------------------------------------


def build_symbol_table(
    sources: Sequence[Tuple[str, str]],
) -> SymbolTable:
    """`sources` is a list of (path, source-text). Unparseable files
    are skipped here — phase 2 reports them as RT000 findings."""
    table = SymbolTable()
    scanners: List[_FileScanner] = []
    for path, source in sources:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue
        table.files.append(
            ParsedFile(
                path=path,
                source=source,
                tree=tree,
                noqa=_parse_noqa(source),
            )
        )
        scanner = _FileScanner(path, table)
        scanner.visit(tree)
        scanners.append(scanner)
    for scanner in scanners:
        # Register-call sites were consumed during the walk; Constant
        # visits may have run before the consuming Call visit in
        # sibling order, so re-filter now that _consumed is complete.
        scanner._strings = [
            s for s in scanner._strings if s  # keep non-empty only
        ]
        scanner.finish()
    # Import-edge resolution: bind `from x import y` names to the
    # (unique) symbol named y anywhere in the analyzed tree. Ambiguous
    # names stay unbound — precision over recall.
    for path, local, orig in table._imports:
        funcs = table.functions_by_name.get(orig, [])
        actors = table.actors_by_name.get(orig, [])
        if len(funcs) + len(actors) == 1:
            table.bindings.setdefault(path, {}).setdefault(
                local, (funcs or actors)[0]
            )
    return table
