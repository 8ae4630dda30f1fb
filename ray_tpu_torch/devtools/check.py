# Copied from ray_tpu/devtools/check.py.
"""Whole-program contract checker (`python -m ray_tpu_torch.devtools.check`,
rules RT101-RT106).

Two phases (see contracts.py for phase 1): build a symbol table of
every remote function/actor signature, RPC handler, wire schema, call
site, and the shared option-key universe — then re-walk every file and
judge each call site against the contract it targets:

| id    | contract violated                                            |
|-------|--------------------------------------------------------------|
| RT101 | .remote() arity/keywords vs the decorated signature          |
|       | (tasks, actor creation, and actor methods via typed handles) |
| RT102 | unknown or invalid-typed .options()/@rt.remote(...) keys     |
|       | (same key universe the runtime validator enforces)           |
| RT103 | client.call("m") with no registered handler; handlers no     |
|       | call site ever names (dead wire surface)                     |
| RT104 | call-site kwargs inconsistent with the method's wire.SCHEMAS |
|       | entry; handlers served without any schema                    |
| RT105 | obviously unserializable .remote() arguments (locks,         |
|       | sockets, open files)                                         |
| RT106 | fire-and-forget .remote() whose ObjectRef is discarded —     |
|       | task errors can never be observed                            |

Where lint answers "is this line idiomatic", check answers "do the two
sides of this process boundary still agree". Both share the same
suppression (`# rt: noqa[RTxxx]`), output formats (`--json`), and exit
codes (0 clean / 1 findings / 2 usage errors), so CI treats them as
one gate (`ray_tpu_torch devtools all`).

Resolution is deliberately high-precision: a receiver is only judged
when it resolves to a known symbol (module binding, import edge, or a
globally unique name) — `.options()` on a serve DeploymentHandle or
`.remote()` through an untracked alias stays silent rather than
guessing. RT103/RT104 likewise stay silent when the analyzed tree
contains no handler registry / schema table at all (checking one file
in isolation must not drown it in "unknown method" noise).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from dataclasses import asdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .contracts import (
    RPC_VERBS,
    RemoteActor,
    RemoteFunc,
    Signature,
    SymbolTable,
    build_symbol_table,
)
from .lint import Finding, _dotted, _iter_py_files, noqa_hygiene

__all__ = ["check_sources", "check_paths", "main", "RULES"]

#: id -> one-line title (the --list-rules table).
RULES: Dict[str, str] = {
    "RT101": ".remote() arity/keyword mismatch vs decorated signature",
    "RT102": "unknown or invalid-typed .options()/@rt.remote option key",
    "RT103": "RPC method with no registered handler / dead handler",
    "RT104": "call-site kwargs drift vs wire schema / schema-less handler",
    "RT105": "obviously unserializable value passed to .remote()",
    "RT106": "fire-and-forget .remote(): result ObjectRef is discarded",
    "RT190": "stale or unknown '# rt: noqa' suppression (check family)",
}

#: Handler methods invoked by infrastructure rather than literal call
#: sites: the server synthesizes _disconnect on EOF; ping is the
#: liveness probe external tooling/tests dial directly.
INFRA_LIVE_METHODS = frozenset({"_disconnect", "ping"})

#: Constructors whose results never survive pickling across a process
#: boundary (RT105).
_UNSERIALIZABLE = {
    "threading.Thread": "thread",
    "threading.Lock": "lock",
    "threading.RLock": "lock",
    "threading.Condition": "condition",
    "threading.Event": "event",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
    "threading.Barrier": "barrier",
    "socket.socket": "socket",
    "socket.create_connection": "socket",
    "socket.socketpair": "socket",
    "open": "open file",
    "io.open": "open file",
}


def _fmt_types(types: Tuple[type, ...]) -> str:
    return "/".join(t.__name__ for t in types)


# ---------------------------------------------------------------------------
# per-file pass (RT101, RT102, RT105, RT106)
# ---------------------------------------------------------------------------


class _CheckVisitor(ast.NodeVisitor):
    def __init__(self, path: str, table: SymbolTable, sink: List[Finding]):
        self.path = path
        self.table = table
        self.sink = sink
        from ray_tpu_torch._private.options import (
            ACTOR_OPTIONS,
            NUM_RETURNS_STRINGS,
            TASK_OPTIONS,
            valid_keys,
        )

        self._task_options = TASK_OPTIONS
        self._actor_options = ACTOR_OPTIONS
        self._num_returns_strings = NUM_RETURNS_STRINGS
        self._valid_keys = valid_keys
        #: Scope stack: var name -> ("handle", RemoteActor) for actor
        #: handles, or ("unser", kind) for unserializable locals, or a
        #: RemoteFunc/RemoteActor alias from `x = f` / `x = f.options()`.
        self._scopes: List[Dict[str, object]] = [{}]

    # -- plumbing ------------------------------------------------------
    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.sink.append(
            Finding(
                path=self.path,
                line=getattr(node, "lineno", 1),
                col=getattr(node, "col_offset", 0) + 1,
                rule=rule,
                message=message,
            )
        )

    def _lookup(self, name: str):
        for scope in reversed(self._scopes):
            if name in scope:
                return scope[name]
        return self.table.resolve(self.path, name)

    # -- scopes --------------------------------------------------------
    def _visit_scope(self, node):
        self._scopes.append({})
        self.generic_visit(node)
        self._scopes.pop()

    def visit_ClassDef(self, node):
        self._bind_def(node)
        self._check_decorator_options(node)
        self._visit_scope(node)

    # -- receiver resolution -------------------------------------------
    def _resolve_target(self, expr: ast.expr):
        """Expr E of `E.remote(...)` -> ("func", sym) | ("init", sym) |
        ("method", actor, name) | None."""
        # strip .options(...) chains: options() returns the same kind.
        while (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "options"
        ):
            expr = expr.func.value
        if isinstance(expr, ast.Name):
            sym = self._lookup(expr.id)
            if isinstance(sym, RemoteFunc):
                return ("func", sym)
            if isinstance(sym, RemoteActor):
                return ("init", sym)
            if isinstance(sym, tuple) and sym[0] == "handle":
                return None  # bare handle.remote() — not a thing
            return None
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ):
            bound = self._lookup(expr.value.id)
            if isinstance(bound, tuple) and bound[0] == "handle":
                return ("method", bound[1], expr.attr)
        return None

    # -- RT101 ---------------------------------------------------------
    def _check_arity(
        self, node: ast.Call, sig: Signature, what: str
    ) -> None:
        has_starred = any(isinstance(a, ast.Starred) for a in node.args)
        has_star_kw = any(kw.arg is None for kw in node.keywords)
        n_pos = len(node.args)
        kw_names = [kw.arg for kw in node.keywords if kw.arg is not None]
        if (
            not has_starred
            and not sig.vararg
            and n_pos > len(sig.params)
        ):
            self._emit(
                "RT101",
                node,
                f"{what}.remote() takes at most {len(sig.params)} "
                f"positional argument(s) ({n_pos} given)",
            )
        if not sig.kwarg:
            legal = sig.keyword_names()
            for name in kw_names:
                if name not in legal:
                    self._emit(
                        "RT101",
                        node,
                        f"{what}.remote() got an unexpected keyword "
                        f"argument {name!r}",
                    )
        if not has_starred:
            covered = set(sig.params[: min(n_pos, len(sig.params))])
            for name in kw_names:
                if name in covered:
                    self._emit(
                        "RT101",
                        node,
                        f"{what}.remote() got multiple values for "
                        f"argument {name!r}",
                    )
            if not has_star_kw:
                missing = [
                    p
                    for p in sig.params[n_pos : sig.required_positional]
                    if p not in kw_names
                ]
                missing += [
                    k
                    for k, has_default in sig.kwonly.items()
                    if not has_default and k not in kw_names
                ]
                if missing:
                    self._emit(
                        "RT101",
                        node,
                        f"{what}.remote() missing required "
                        f"argument(s): {', '.join(missing)}",
                    )

    # -- RT102 ---------------------------------------------------------
    def _check_option_items(
        self,
        node_for_anchor: ast.AST,
        items: Iterable[Tuple[str, ast.expr]],
        kind: str,
        what: str,
    ) -> None:
        table = (
            self._task_options if kind == "task" else self._actor_options
        )
        # Same helper the runtime error message uses: the two halves
        # of RT102 can never name different valid sets.
        valid = ", ".join(self._valid_keys(kind))
        for key, value in items:
            if key not in table:
                self._emit(
                    "RT102",
                    value if hasattr(value, "lineno") else node_for_anchor,
                    f"unknown {kind} option {key!r} on {what} — "
                    f"silently ignored at submission; valid: {valid}",
                )
                continue
            spec = table[key]
            if spec is None or not isinstance(value, ast.Constant):
                continue
            literal = value.value
            if type(literal) not in spec:
                self._emit(
                    "RT102",
                    value,
                    f"{kind} option {key!r} on {what} expects "
                    f"{_fmt_types(spec)}, got "
                    f"{type(literal).__name__} ({literal!r})",
                )
            elif (
                key == "num_returns"
                and isinstance(literal, str)
                and literal not in self._num_returns_strings
            ):
                self._emit(
                    "RT102",
                    value,
                    f"num_returns string must be one of "
                    f"{'/'.join(self._num_returns_strings)}, "
                    f"got {literal!r}",
                )

    def _bind_def(self, node) -> None:
        """Bind a decorated def's symbol into the ENCLOSING scope —
        the lexical-shadowing behavior real Python has, so the second
        `@rt.remote class A` in a file resolves to itself (not to the
        file's last A) for call sites in its own scope."""
        sym = self.table.by_def.get((self.path, node.lineno))
        if sym is not None:
            self._scopes[-1][node.name] = sym

    def _check_decorator_options(self, node) -> None:
        sym = self.table.by_def.get((self.path, node.lineno))
        if isinstance(sym, RemoteFunc):
            self._check_option_items(
                node, sym.options.items(), "task", f"@remote {sym.name}"
            )
        elif isinstance(sym, RemoteActor):
            self._check_option_items(
                node, sym.options.items(), "actor", f"@remote {sym.name}"
            )

    # -- RT105 ---------------------------------------------------------
    def _unserializable_kind(self, expr: ast.expr) -> Optional[str]:
        if isinstance(expr, ast.Call):
            return _UNSERIALIZABLE.get(_dotted(expr.func))
        if isinstance(expr, ast.Name):
            bound = self._lookup(expr.id)
            if isinstance(bound, tuple) and bound[0] == "unser":
                return bound[1]
        return None

    # -- visits --------------------------------------------------------
    def visit_Assign(self, node: ast.Assign):
        if len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            var = node.targets[0].id
            value = node.value
            # h = Actor.remote(...) / h = Actor.options(...).remote(...)
            if (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr == "remote"
            ):
                target = self._resolve_target(value.func.value)
                if target is not None and target[0] == "init":
                    self._scopes[-1][var] = ("handle", target[1])
            # x = f / x = f.options(...): alias keeps resolving
            elif isinstance(value, ast.Name):
                sym = self._lookup(value.id)
                if isinstance(sym, (RemoteFunc, RemoteActor)):
                    self._scopes[-1][var] = sym
            elif (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr == "options"
                and isinstance(value.func.value, ast.Name)
            ):
                sym = self._lookup(value.func.value.id)
                if isinstance(sym, (RemoteFunc, RemoteActor)):
                    self._scopes[-1][var] = sym
            # lock = threading.Lock() and friends
            elif isinstance(value, ast.Call):
                kind = _UNSERIALIZABLE.get(_dotted(value.func))
                if kind is not None:
                    self._scopes[-1][var] = ("unser", kind)
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr):
        # RT106: statement-level `f.remote(...)` whose ref vanishes.
        value = node.value
        if (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr == "remote"
        ):
            target = self._resolve_target(value.func.value)
            if target is not None and target[0] in ("func", "method"):
                name = (
                    target[1].name
                    if target[0] == "func"
                    else f"{target[1].name}.{target[2]}"
                )
                self._emit(
                    "RT106",
                    value,
                    f"result ObjectRef of {name}.remote() is discarded"
                    " — task errors can never be observed; keep the "
                    "ref and get()/wait() it (or noqa a deliberate "
                    "fire-and-forget)",
                )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr == "remote":
                target = self._resolve_target(func.value)
                if target is not None:
                    if target[0] == "func":
                        self._check_arity(
                            node, target[1].sig, target[1].name
                        )
                    elif target[0] == "init":
                        self._check_arity(
                            node, target[1].init, target[1].name
                        )
                    elif target[0] == "method":
                        actor, mname = target[1], target[2]
                        sig = actor.methods.get(mname)
                        if sig is None:
                            # Inherited methods are invisible to the
                            # class-body scan: judge only base-less
                            # classes, where absence is definitive.
                            if not actor.has_bases:
                                self._emit(
                                    "RT101",
                                    node,
                                    f"actor {actor.name} has no method "
                                    f"{mname!r} (methods: "
                                    f"{', '.join(sorted(actor.methods)) or 'none'})",
                                )
                        else:
                            self._check_arity(
                                node, sig, f"{actor.name}.{mname}"
                            )
                # RT105 applies to ANY .remote() — a lock in flight is
                # wrong no matter how the receiver was built.
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    if isinstance(arg, ast.Starred):
                        continue
                    kind = self._unserializable_kind(arg)
                    if kind is not None:
                        self._emit(
                            "RT105",
                            arg,
                            f"{kind} passed to .remote() cannot be "
                            "serialized across the process boundary; "
                            "create it inside the task/actor instead",
                        )
            elif func.attr == "options" and isinstance(
                func.value, ast.Name
            ):
                sym = self._lookup(func.value.id)
                if isinstance(sym, RemoteFunc):
                    self._check_option_items(
                        node,
                        [
                            (kw.arg, kw.value)
                            for kw in node.keywords
                            if kw.arg is not None
                        ],
                        "task",
                        sym.name,
                    )
                elif isinstance(sym, RemoteActor):
                    self._check_option_items(
                        node,
                        [
                            (kw.arg, kw.value)
                            for kw in node.keywords
                            if kw.arg is not None
                        ],
                        "actor",
                        sym.name,
                    )
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        self._bind_def(node)
        self._check_decorator_options(node)
        self._visit_scope(node)

    visit_AsyncFunctionDef = visit_FunctionDef


# ---------------------------------------------------------------------------
# global pass (RT103, RT104)
# ---------------------------------------------------------------------------


def _global_findings(table: SymbolTable) -> List[Finding]:
    out: List[Finding] = []
    handlers = table.handlers
    schemas = table.schemas

    # RT103a: call site naming a method nobody registers. Silent when
    # the analyzed tree has no registry at all (partial-tree runs).
    if handlers:
        for site in table.call_sites:
            if site.method not in handlers:
                out.append(
                    Finding(
                        path=site.path,
                        line=site.lineno,
                        col=site.col,
                        rule="RT103",
                        message=(
                            f".{site.verb}({site.method!r}, ...) names "
                            "a method with no registered handler — the "
                            "server will reply 'no such method'"
                        ),
                    )
                )

    # RT103b: dead handlers — registered, but no call site or dynamic
    # string witness anywhere names them. Needs call sites to exist
    # (an isolated server file has no callers by construction).
    if handlers and table.call_sites:
        called = {site.method for site in table.call_sites}
        for method, defs in sorted(handlers.items()):
            if method in called or method in INFRA_LIVE_METHODS:
                continue
            if method in table.witnesses:
                continue  # dynamic dispatch keeps it alive
            for handler in defs:
                out.append(
                    Finding(
                        path=handler.path,
                        line=handler.lineno,
                        col=1,
                        rule="RT103",
                        message=(
                            f"handler {method!r} is registered but no "
                            "call site ever names it — dead wire "
                            "surface (remove it, or noqa if external "
                            "clients dial it)"
                        ),
                    )
                )

    if schemas:
        # RT104a: handlers served without any schema entry.
        for method, defs in sorted(handlers.items()):
            if method in schemas:
                continue
            for handler in defs:
                out.append(
                    Finding(
                        path=handler.path,
                        line=handler.lineno,
                        col=1,
                        rule="RT104",
                        message=(
                            f"handler {method!r} has no wire.SCHEMAS "
                            "entry — its arguments are never "
                            "validated; add a per-method schema"
                        ),
                    )
                )
        # RT104b: call-site kwargs vs the method's schema.
        for site in table.call_sites:
            schema = schemas.get(site.method)
            if schema is None:
                continue
            reserved = RPC_VERBS[site.verb]
            sent = site.kwargs - reserved
            unknown = sorted(sent - set(schema))
            for name in unknown:
                out.append(
                    Finding(
                        path=site.path,
                        line=site.lineno,
                        col=site.col,
                        rule="RT104",
                        message=(
                            f"kwarg {name!r} is not in the "
                            f"{site.method!r} wire schema (fields: "
                            f"{', '.join(sorted(schema)) or 'none'}) — "
                            "server-side validation will reject or "
                            "silently drop it"
                        ),
                    )
                )
            if not site.has_star_kwargs:
                missing = sorted(
                    f
                    for f, spec in schema.items()
                    if not spec.optional and f not in sent
                )
                if missing:
                    out.append(
                        Finding(
                            path=site.path,
                            line=site.lineno,
                            col=site.col,
                            rule="RT104",
                            message=(
                                f".{site.verb}({site.method!r}, ...) "
                                "omits required schema field(s): "
                                f"{', '.join(missing)}"
                            ),
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def check_sources(
    sources: Sequence[Tuple[str, str]],
    rules: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Check a set of (path, source) blobs as one program."""
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
    for parsed in table.files:
        _CheckVisitor(parsed.path, table, findings).visit(parsed.tree)
    findings.extend(_global_findings(table))
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
    # Noqa hygiene (RT190) audits the RAW findings and bypasses
    # suppression — a stale noqa cannot suppress its own report.
    if only is None or "RT190" in only:
        for path, source in sources:
            kept.extend(
                noqa_hygiene(
                    path,
                    source,
                    findings,
                    family_digit="1",
                    known_ids=set(RULES),
                    hygiene_id="RT190",
                )
            )
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def _rule_filter(rules: Optional[Iterable[str]]) -> Optional[Set[str]]:
    if rules is None:
        return None
    wanted = {r.upper() for r in rules}
    unknown = wanted - set(RULES)
    if unknown:
        raise ValueError(f"unknown rule id(s): {', '.join(sorted(unknown))}")
    return wanted


def check_paths(
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
    findings.extend(check_sources(sources, rules))
    return findings


def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    """CLI body shared by `ray_tpu_torch check` and `python -m
    ray_tpu_torch.devtools.check`. Exit codes mirror lint: 0 clean, 1
    findings, 2 usage/IO errors."""
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.check",
        description=(
            "whole-program contract checker (rules RT101-RT106 + RT190 "
            "noqa hygiene; suppress with '# rt: noqa[RTxxx]')"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help=(
            "files or directories to check as ONE program (default: "
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
            f"check: no such path(s): {', '.join(missing)}",
            file=sys.stderr,
        )
        return 2
    only = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    try:
        findings = check_paths(args.paths, only)
    except ValueError as e:
        print(f"check: {e}", file=sys.stderr)
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
