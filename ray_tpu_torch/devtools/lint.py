# Copied from ray_tpu/devtools/lint.py.
"""Distributed-correctness linter engine (`python -m ray_tpu_torch.devtools.lint`).

Reference motivation: the reference project backs its C++ core with
sanitizer CI (SURVEY §5.2) but the *distributed* bug classes — payload
-equality dedup of retryable messages, namespace pinning, blocking
gets inside actors, nondeterminism on replayable paths — live in
Python and slip past generic linters because they are framework
idioms, not syntax errors. This module is a purpose-built AST pass
over ray_tpu_torch's own conventions: one parse per file, one walk, every
registered rule (devtools/rules.py, RT001–RT010) dispatched from the
same visitor with shared scope context.

Suppressions: a finding is dropped when its physical line carries
``# rt: noqa`` (all rules) or ``# rt: noqa[RT002]`` /
``# rt: noqa[RT002,RT004]`` (listed rules only). Suppressions are
deliberately per-line and explicit — a wildcard file-level opt-out
would hide exactly the drift this tool exists to catch.

Output: human ``path:line:col: RTxxx message`` lines, or ``--json``
(list of finding objects) for CI. Exit codes: 0 clean, 1 findings,
2 usage/IO errors.
"""

from __future__ import annotations

import argparse
import ast
import io
import json
import os
import re
import sys
import tokenize
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "LintContext",
    "lint_source",
    "lint_paths",
    "noqa_hygiene",
    "main",
]

_NOQA_RE = re.compile(
    r"#\s*rt:\s*noqa(?:\[(?P<rules>[A-Z0-9,\s]+)\])?", re.IGNORECASE
)

_RULE_ID_RE = re.compile(r"RT\d{3}")

#: Rule-family ownership for noqa hygiene: RT0xx lint, RT1xx check,
#: RT2xx race, RT3xx accel. Each pass audits only the suppressions it
#: owns; lint additionally audits ids no family owns.
_FAMILY_DIGITS = {"0": "lint", "1": "check", "2": "race", "3": "accel"}

#: The per-pass hygiene rule ids themselves — not suppressible (a
#: stale suppression must not be able to suppress its own report).
_HYGIENE_IDS = {"RT090", "RT190", "RT290", "RT390"}

#: lint's own hygiene rule (engine-level: not an AST walker rule).
HYGIENE_RULE = ("RT090", "stale or unknown '# rt: noqa' suppression")


@dataclass
class Finding:
    """One rule violation at a source location."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _parse_noqa(source: str) -> Dict[int, Optional[set]]:
    """line -> None (suppress all rules) or {rule ids} to suppress."""
    out: Dict[int, Optional[set]] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        if "rt:" not in text:
            continue
        match = _NOQA_RE.search(text)
        if match is None:
            continue
        rules = match.group("rules")
        if rules is None:
            out[lineno] = None
        else:
            out[lineno] = {
                r.strip().upper() for r in rules.split(",") if r.strip()
            }
    return out


def _noqa_comment_rules(source: str) -> Dict[int, Set[str]]:
    """line -> explicit rule-id set, counting only genuine COMMENT
    tokens. Unlike `_parse_noqa` (which is a per-line regex so that
    suppression stays cheap and predictable), hygiene must NOT judge
    noqa text embedded in string literals — test fixtures build
    sources containing noqa markers all the time."""
    out: Dict[int, Set[str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            match = _NOQA_RE.search(tok.string)
            if match is None or match.group("rules") is None:
                continue
            out[tok.start[0]] = {
                r.strip().upper()
                for r in match.group("rules").split(",")
                if r.strip()
            }
    except (tokenize.TokenError, IndentationError, SyntaxError, ValueError):
        pass  # unparseable files already get RT000
    return out


def noqa_hygiene(
    path: str,
    source: str,
    raw_findings: Sequence[Finding],
    family_digit: str,
    known_ids: Set[str],
    hygiene_id: str,
    orphan_families: bool = False,
) -> List[Finding]:
    """Audit explicit ``# rt: noqa[RTxxx]`` comments against the RAW
    (pre-suppression) findings of the owning pass: an id that does not
    exist, or that never fires on its line, is itself a finding —
    stale suppressions must not rot silently. Shared by all four
    passes (lint RT090 / check RT190 / race RT290 / accel RT390);
    `orphan_families` additionally makes lint the reporter for ids no
    family owns (RT9xx typos etc.). Bare ``# rt: noqa`` is exempt: it
    names no claim to audit."""
    fired: Dict[int, Set[str]] = {}
    for finding in raw_findings:
        if finding.path == path:
            fired.setdefault(finding.line, set()).add(finding.rule)
    out: List[Finding] = []
    for line, ids in sorted(_noqa_comment_rules(source).items()):
        for rid in sorted(ids):
            if rid in _HYGIENE_IDS:
                if rid[2] == family_digit:
                    out.append(
                        Finding(
                            path=path, line=line, col=1, rule=hygiene_id,
                            message=(
                                f"'{rid}' is the noqa-hygiene rule itself "
                                f"and cannot be suppressed — remove it and "
                                f"fix the stale suppression it reports"
                            ),
                        )
                    )
                continue
            if _RULE_ID_RE.fullmatch(rid) is None:
                if orphan_families:
                    out.append(
                        Finding(
                            path=path, line=line, col=1, rule=hygiene_id,
                            message=(
                                f"noqa names malformed rule id '{rid}' "
                                f"(expected RTxyz)"
                            ),
                        )
                    )
                continue
            digit = rid[2]
            if digit == family_digit:
                if rid not in known_ids:
                    out.append(
                        Finding(
                            path=path, line=line, col=1, rule=hygiene_id,
                            message=(
                                f"noqa names unknown rule id {rid} — no "
                                f"such rule in the "
                                f"{_FAMILY_DIGITS[digit]} family"
                            ),
                        )
                    )
                elif rid not in fired.get(line, ()):
                    out.append(
                        Finding(
                            path=path, line=line, col=1, rule=hygiene_id,
                            message=(
                                f"noqa suppresses {rid}, which does not "
                                f"fire on this line — stale suppression; "
                                f"remove it"
                            ),
                        )
                    )
            elif orphan_families and digit not in _FAMILY_DIGITS:
                out.append(
                    Finding(
                        path=path, line=line, col=1, rule=hygiene_id,
                        message=(
                            f"noqa names unknown rule id {rid} — no "
                            f"devtools family owns RT{digit}xx"
                        ),
                    )
                )
    return out


class LintContext:
    """Shared walk state every rule reads instead of re-deriving.

    The stacks track syntactic position (function nesting, enclosing
    classes + whether they are actor classes); `at_import_time` is the
    fork-safety question "does this statement run when the module is
    imported" (module body and class bodies — both execute on import;
    function bodies do not)."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.func_stack: List[ast.AST] = []
        self.class_stack: List[Tuple[ast.ClassDef, bool]] = []

    # -- position helpers ---------------------------------------------
    @property
    def at_import_time(self) -> bool:
        return not self.func_stack

    @property
    def current_func(self) -> Optional[ast.AST]:
        return self.func_stack[-1] if self.func_stack else None

    @property
    def in_async_func(self) -> bool:
        return isinstance(self.current_func, ast.AsyncFunctionDef)

    @property
    def in_actor_class(self) -> bool:
        """Innermost method context belongs to an actor class: the
        class is directly decorated @remote / @rt.remote /
        @ray_tpu_torch.remote (bare or called)."""
        if not self.class_stack:
            return False
        # Only a method defined directly on the actor class counts —
        # a nested helper class resets the context.
        return self.class_stack[-1][1]


def _dotted(node: ast.AST) -> str:
    """`a.b.c` -> "a.b.c"; bare names -> "name"; else ""."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_remote_decorator(dec: ast.AST) -> bool:
    if isinstance(dec, ast.Call):
        dec = dec.func
    name = _dotted(dec)
    return name in ("remote", "rt.remote", "ray_tpu_torch.remote") or (
        name.endswith(".remote") and name.count(".") == 1
    )


class _Walker(ast.NodeVisitor):
    """Single-pass dispatcher: maintains the LintContext stacks and
    hands every node to each in-scope rule."""

    def __init__(self, ctx: LintContext, rules: Sequence, sink: List[Finding]):
        self.ctx = ctx
        self.rules = rules
        self.sink = sink

    def _emit(self, rule, node: ast.AST, message: str) -> None:
        self.sink.append(
            Finding(
                path=self.ctx.path,
                line=getattr(node, "lineno", 1),
                col=getattr(node, "col_offset", 0) + 1,
                rule=rule.id,
                message=message,
            )
        )

    def _dispatch(self, hook: str, node: ast.AST) -> None:
        for rule in self.rules:
            fn = getattr(rule, hook, None)
            if fn is None:
                continue
            for message, anchor in fn(node, self.ctx) or ():
                self._emit(rule, anchor if anchor is not None else node, message)

    # -- scope-tracking visits ----------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        is_actor = any(_is_remote_decorator(d) for d in node.decorator_list)
        self.ctx.class_stack.append((node, is_actor))
        self.generic_visit(node)
        self.ctx.class_stack.pop()

    def _visit_func(self, node) -> None:
        self._dispatch("on_functiondef", node)
        self.ctx.func_stack.append(node)
        self.generic_visit(node)
        self.ctx.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- node-type hooks ----------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        self._dispatch("on_call", node)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        self._dispatch("on_compare", node)
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        self._dispatch("on_except", node)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._dispatch("on_assign", node)
        self.generic_visit(node)

    def visit_keyword(self, node: ast.keyword) -> None:
        self._dispatch("on_keyword", node)
        self.generic_visit(node)


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _rules_for(path: str, rules: Sequence) -> List:
    norm = _norm(path)
    return [r for r in rules if r.in_scope(norm)]


def _wanted_ids(only: Optional[Iterable[str]]) -> Optional[Set[str]]:
    if only is None:
        return None
    from .rules import ALL_RULES

    wanted = {r.upper() for r in only}
    unknown = wanted - ({r.id for r in ALL_RULES} | {HYGIENE_RULE[0]})
    if unknown:
        raise ValueError(f"unknown rule id(s): {', '.join(sorted(unknown))}")
    return wanted


def lint_source(
    source: str,
    path: str = "<string>",
    rules: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Lint one source blob; `path` drives per-rule scoping."""
    wanted = _wanted_ids(rules)
    from .rules import ALL_RULES

    # Always walk with every in-scope rule: noqa hygiene judges the
    # RAW findings, so staleness cannot depend on the --rules filter.
    active = _rules_for(path, list(ALL_RULES))
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [
            Finding(
                path=path,
                line=e.lineno or 1,
                col=(e.offset or 0) + 1,
                rule="RT000",
                message=f"file does not parse: {e.msg}",
            )
        ]
    ctx = LintContext(path, tree)
    sink: List[Finding] = []
    if active:
        _Walker(ctx, active, sink).visit(tree)
    noqa = _parse_noqa(source)
    kept = []
    for finding in sink:
        if wanted is not None and finding.rule not in wanted:
            continue
        suppressed = noqa.get(finding.line)
        if finding.line in noqa and (
            suppressed is None or finding.rule in suppressed
        ):
            continue
        kept.append(finding)
    if wanted is None or HYGIENE_RULE[0] in wanted:
        known = {r.id for r in ALL_RULES} | {"RT000"}
        kept.extend(
            noqa_hygiene(
                path,
                source,
                sink,
                family_digit="0",
                known_ids=known,
                hygiene_id=HYGIENE_RULE[0],
                orphan_families=True,
            )
        )
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [
                d
                for d in sorted(dirnames)
                if not d.startswith(".") and d != "__pycache__"
            ]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def lint_paths(
    paths: Sequence[str], rules: Optional[Iterable[str]] = None
) -> List[Finding]:
    findings: List[Finding] = []
    for file_path in _iter_py_files(paths):
        try:
            with open(file_path, "r", encoding="utf-8") as f:
                source = f.read()
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
            continue
        findings.extend(lint_source(source, file_path, rules))
    return findings


def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    """CLI body shared by `ray_tpu_torch lint` and `python -m
    ray_tpu_torch.devtools.lint`. Returns the exit code (0 clean, 1
    findings, 2 errors) instead of exiting, so tests and the CLI
    wrapper both drive it directly."""
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description=(
            "framework-aware distributed-correctness linter "
            "(rules RT001-RT010 + RT090 noqa hygiene; suppress with "
            "'# rt: noqa[RTxxx]')"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help=(
            "files or directories to lint (default: the installed "
            "ray_tpu_torch package, wherever the CLI runs from)"
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
    from .rules import ALL_RULES

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id}  {rule.title}", file=out)
        print(f"{HYGIENE_RULE[0]}  {HYGIENE_RULE[1]}", file=out)
        return 0
    if not args.paths:
        # Default to the package this CLI shipped in — NOT a
        # cwd-relative "ray_tpu_torch", which would lint nothing (or the
        # wrong tree) from any other directory.
        args.paths = [
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        ]
    only = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    try:
        findings = lint_paths(args.paths, only)
    except ValueError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(
            f"lint: no such path(s): {', '.join(missing)}", file=sys.stderr
        )
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
