# Copied from ray_tpu/devtools/rules.py.
"""The RT001–RT010 distributed-correctness passes.

Each rule is one bug class ray_tpu_torch has actually shipped (or nearly
shipped — see ADVICE.md for the originals) generalized into a
syntactic pattern plus a path scope. Rules are deliberately
high-precision: a pass that cries wolf on idiomatic code gets noqa'd
into silence, so each one matches the narrow framework idiom and
leaves the rest of Python alone.

| id    | bug class                                                    |
|-------|--------------------------------------------------------------|
| RT001 | blocking ray_tpu_torch.get() inside actor methods / async bodies   |
| RT002 | payload-equality dedup of retryable channel/rpc records      |
| RT003 | wall-clock / RNG nondeterminism on replayable wire paths     |
| RT004 | thread/lock/socket creation at import time (fork-unsafe)     |
| RT005 | unvalidated int() narrowing of public-API numeric params     |
| RT006 | hardcoded namespace="default" outside the session module     |
| RT007 | bare/swallowed exceptions in daemon RPC handlers             |
| RT008 | cross-process wait()/join() with no timeout                  |
| RT009 | metric names/labels violating the Prometheus convention      |
| RT010 | unbounded-cardinality metric labels (per-request/object ids) |

Hooks a rule may define (all optional): ``on_call``, ``on_compare``,
``on_except``, ``on_assign``, ``on_keyword``, ``on_functiondef`` —
each ``(node, ctx) -> iterable of (message, anchor_node | None)``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional, Tuple

from .lint import LintContext, _dotted

Hit = Tuple[str, Optional[ast.AST]]


class Rule:
    id: str = "RT000"
    title: str = ""
    #: Substrings of the normalized path; None = every file.
    include: Optional[Tuple[str, ...]] = None
    exclude: Tuple[str, ...] = ()
    exclude_suffixes: Tuple[str, ...] = ()

    def in_scope(self, norm_path: str) -> bool:
        if any(s in norm_path for s in self.exclude):
            return False
        if any(norm_path.endswith(s) for s in self.exclude_suffixes):
            return False
        if self.include is None:
            return True
        return any(s in norm_path for s in self.include)


def _terminal_name(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class BlockingGetInActor(Rule):
    """RT001: `ray_tpu_torch.get()` blocks the calling thread until another
    task finishes. Inside an actor method it wedges the actor's
    (bounded-concurrency) executor; inside `async def` it starves the
    shared event loop — both are distributed deadlocks waiting for the
    right load. Use `await ref` (async) or restructure so the driver
    joins results."""

    id = "RT001"
    title = "blocking ray_tpu_torch.get() inside actor method or async def"
    exclude = ("tests/",)

    _GET_CALLEES = ("ray_tpu_torch.get", "rt.get", "ray_tpu_torch.wait", "rt.wait")

    def on_call(self, node: ast.Call, ctx: LintContext) -> Iterable[Hit]:
        name = _dotted(node.func)
        if name not in self._GET_CALLEES:
            return
        if ctx.current_func is None:
            return
        if ctx.in_async_func:
            yield (
                f"blocking {name}() inside `async def "
                f"{ctx.current_func.name}` starves the actor event loop; "
                "await the ref instead",
                None,
            )
        elif ctx.in_actor_class:
            yield (
                f"blocking {name}() inside actor method "
                f"`{ctx.current_func.name}` can deadlock the actor's "
                "bounded executor; resolve refs on the driver or pass "
                "values in",
                None,
            )


class PayloadEqualityDedup(Rule):
    """RT002: deduplicating a retried record by comparing payload
    bytes treats *distinct* records with equal bytes as retries (two
    execute() calls with the same input) and silently drops one — the
    tcp_channel.py bug class. Retry identity must be a sequence
    number / explicit token framed with the record, never content."""

    id = "RT002"
    title = "payload-equality dedup of retryable records"
    include = ("dag/", "channel", "rpc.py", "wire.py")
    exclude = ("tests/",)

    _MARKERS = ("payload", "frame")

    def on_compare(self, node: ast.Compare, ctx: LintContext) -> Iterable[Hit]:
        if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            return
        for side in (node.left, *node.comparators):
            name = _terminal_name(side).lower()
            if any(marker in name for marker in self._MARKERS):
                yield (
                    f"equality comparison on raw record bytes "
                    f"(`{_terminal_name(side)}`) — retries must be "
                    "identified by a per-channel sequence number, not "
                    "payload equality",
                    None,
                )
                return


class WireNondeterminism(Rule):
    """RT003: wire-protocol and replayable paths (compiled-DAG
    channels, frame codec, workflow replay) must produce identical
    bytes/decisions across a re-execution; wall clocks and RNGs break
    resume and cross-process agreement silently."""

    id = "RT003"
    title = "nondeterminism (time.time/random/os.urandom) on replayable path"
    include = ("dag/", "wire.py", "workflow/")
    exclude = ("tests/",)

    def on_call(self, node: ast.Call, ctx: LintContext) -> Iterable[Hit]:
        name = _dotted(node.func)
        if (
            name == "time.time"
            or name == "os.urandom"
            or name.startswith("random.")
        ):
            yield (
                f"{name}() on a replayable/wire path — a re-executed "
                "step must reproduce the original bytes; derive values "
                "from the record/step identity instead",
                None,
            )


class ImportTimeForkHazard(Rule):
    """RT004: modules pre-imported by the worker fork-server template
    (worker_forkserver.py) execute at import time in the template;
    threads/locks/sockets created there are shared copy-on-write with
    every forked worker — a thread doesn't survive fork, a lock held
    at fork deadlocks children, an fd is shared. Create them lazily
    (first use) instead."""

    id = "RT004"
    title = "thread/lock/socket created at import time in forkserver module"
    include = ("_private/", "_native/")
    exclude = ("tests/",)

    _THREADING = (
        "Thread",
        "Timer",
        "Lock",
        "RLock",
        "Condition",
        "Event",
        "Semaphore",
        "BoundedSemaphore",
        "Barrier",
    )
    _SOCKET = ("socket", "create_connection", "socketpair")

    def on_call(self, node: ast.Call, ctx: LintContext) -> Iterable[Hit]:
        if not ctx.at_import_time:
            return
        name = _dotted(node.func)
        flagged = (
            name in tuple(f"threading.{n}" for n in self._THREADING)
            or name in tuple(f"socket.{n}" for n in self._SOCKET)
        )
        if flagged:
            yield (
                f"{name}() at import time in a fork-server-loaded "
                "module; forked workers inherit it copy-on-write — "
                "create it lazily on first use",
                None,
            )


class UnvalidatedNarrowing(Rule):
    """RT005: `int(x)` on a user-supplied public-API parameter
    silently truncates 2.5 -> 2 (the autoscaler sdk bug). Validate
    first (`x.is_integer()`, `x != int(x)`, or an isinstance gate)
    or take the truncation out of the API."""

    id = "RT005"
    title = "unvalidated int() narrowing of a public-API parameter"
    exclude = ("_private/", "_native/", "tests/", "devtools/")

    def on_call(self, node: ast.Call, ctx: LintContext) -> Iterable[Hit]:
        func = ctx.current_func
        if func is None or func.name.startswith("_"):
            return
        if not (
            isinstance(node.func, ast.Name)
            and node.func.id == "int"
            and len(node.args) == 1
            and not node.keywords
            and isinstance(node.args[0], ast.Name)
        ):
            return
        param = node.args[0].id
        annotations = {
            a.arg: a.annotation
            for a in (
                *func.args.posonlyargs,
                *func.args.args,
                *func.args.kwonlyargs,
            )
        }
        if param not in annotations:
            return  # a local, not caller input
        annotation = annotations[param]
        if isinstance(annotation, ast.Name) and annotation.id == "int":
            return  # declared int; int(x) is a no-op normalization
        if self._has_validation(func, param, node):
            return
        yield (
            f"int({param}) truncates fractional caller input in public "
            f"API `{func.name}`; validate {param} is integral first",
            None,
        )

    @staticmethod
    def _has_validation(func: ast.AST, param: str, site: ast.Call) -> bool:
        for sub in ast.walk(func):
            if sub is site:
                continue
            # x.is_integer()
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "is_integer"
                and _terminal_name(sub.func.value) == param
            ):
                return True
            # x != int(x)  /  int(x) == x
            if isinstance(sub, ast.Compare):
                names = set()
                casts = set()
                for side in (sub.left, *sub.comparators):
                    if isinstance(side, ast.Name):
                        names.add(side.id)
                    if (
                        isinstance(side, ast.Call)
                        and isinstance(side.func, ast.Name)
                        and side.func.id == "int"
                        and len(side.args) == 1
                        and isinstance(side.args[0], ast.Name)
                    ):
                        casts.add(side.args[0].id)
                if param in names and param in casts:
                    return True
            # isinstance(x, int) / isinstance(x, (int, ...))
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == "isinstance"
                and len(sub.args) == 2
                and isinstance(sub.args[0], ast.Name)
                and sub.args[0].id == param
            ):
                types = sub.args[1]
                elements = (
                    types.elts if isinstance(types, ast.Tuple) else [types]
                )
                if any(
                    isinstance(e, ast.Name) and e.id == "int"
                    for e in elements
                ):
                    return True
        return False


class HardcodedNamespace(Rule):
    """RT006: a literal "default" namespace outside the session-
    context module (ray_tpu_torch/api.py) pins lookups to the wrong
    namespace for any driver that called init(namespace=...) — the
    worker.py bug class. Resolve through the session context; daemon-
    side wire-compat fallbacks carry an explicit noqa."""

    id = "RT006"
    title = 'hardcoded namespace="default" outside the session module'
    exclude = ("tests/",)
    exclude_suffixes = ("ray_tpu_torch/api.py",)

    @staticmethod
    def _is_default(node: ast.AST) -> bool:
        return isinstance(node, ast.Constant) and node.value == "default"

    def on_keyword(self, node: ast.keyword, ctx: LintContext) -> Iterable[Hit]:
        if node.arg == "namespace" and self._is_default(node.value):
            yield (
                'namespace="default" literal pins the session namespace; '
                "resolve it from the session/job context",
                node.value,
            )

    def on_assign(self, node: ast.Assign, ctx: LintContext) -> Iterable[Hit]:
        if not self._is_default(node.value):
            return
        for target in node.targets:
            if _terminal_name(target) == "namespace":
                yield (
                    'namespace = "default" literal pins the session '
                    "namespace; resolve it from the session/job context",
                    None,
                )
                return

    def on_call(self, node: ast.Call, ctx: LintContext) -> Iterable[Hit]:
        # spec.get("namespace", "default") — wire-compat fallback shape
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and len(node.args) == 2
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "namespace"
            and self._is_default(node.args[1])
        ):
            yield (
                '.get("namespace", "default") falls back to the literal '
                "default namespace; resolve through the session/job "
                "context (or noqa a deliberate wire-compat fallback)",
                None,
            )


class SwallowedHandlerError(Rule):
    """RT007: in daemon RPC dispatch, a bare `except:` (catches
    KeyboardInterrupt/SystemExit too) or an `except Exception: pass`
    inside a handler silently converts protocol bugs into hangs at
    the caller — the error never reaches a reply frame. Reply with a
    typed error instead."""

    id = "RT007"
    title = "bare/swallowed exception in daemon RPC handler"
    include = ("daemon", "rpc")
    exclude = ("tests/",)

    def on_except(
        self, node: ast.ExceptHandler, ctx: LintContext
    ) -> Iterable[Hit]:
        if node.type is None:
            yield (
                "bare `except:` in RPC-plane code catches SystemExit/"
                "KeyboardInterrupt; catch Exception (and reply with an "
                "error) instead",
                None,
            )
            return
        func = ctx.current_func
        in_handler = func is not None and (
            func.name.startswith("_h_") or func.name.startswith("handle")
        )
        swallows = (
            len(node.body) == 1
            and isinstance(node.body[0], ast.Pass)
            and isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException")
        )
        if in_handler and swallows:
            yield (
                f"`except {node.type.id}: pass` inside RPC handler "
                f"`{func.name}` drops the error — the caller hangs or "
                "sees a timeout instead of the cause; reply with an "
                "error payload",
                None,
            )


class MissingWaitTimeout(Rule):
    """RT008: a cross-process `.wait()` / `.join()` with no timeout
    turns a dead peer into an infinite hang. Every cross-process wait
    needs a deadline (or an explicit noqa stating why parking forever
    is safe)."""

    id = "RT008"
    title = "cross-process wait()/join() without a timeout"
    exclude = ("tests/",)

    def on_call(self, node: ast.Call, ctx: LintContext) -> Iterable[Hit]:
        if not isinstance(node.func, ast.Attribute):
            return
        if node.func.attr not in ("wait", "join"):
            return
        if node.args or node.keywords:
            return
        yield (
            f".{node.func.attr}() with no timeout waits forever if the "
            "peer died; pass a deadline (or noqa a deliberate park)",
            None,
        )


class MetricNamingConvention(Rule):
    """RT009: exported metric series must stay Prometheus-legal and
    follow the documented convention (README "Metrics export"):
    snake_case ``^[a-z][a-z0-9_]*$`` names, counters ending in
    ``_total``, snake_case label keys. Dots/dashes only survive
    because the exposition layer sanitizes them — two sanitized-equal
    names would silently merge into one series, so the linter rejects
    them at the declaration site instead. Scope: metrics DECLARED in
    the package (tests may name throwaway metrics freely)."""

    id = "RT009"
    title = "metric name/label violates the naming convention"
    exclude = ("tests/",)

    _CONSTRUCTORS = ("Counter", "Gauge", "Histogram")
    _NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

    def _literal_name(self, node: ast.Call):
        """The metric name argument when it is a string literal:
        first positional or `name=` keyword."""
        if node.args and isinstance(node.args[0], ast.Constant):
            if isinstance(node.args[0].value, str):
                return node.args[0].value, node.args[0]
        for kw in node.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                if isinstance(kw.value.value, str):
                    return kw.value.value, kw.value
        return None, None

    def on_call(self, node: ast.Call, ctx: LintContext) -> Iterable[Hit]:
        kind = _terminal_name(node.func)
        if kind not in self._CONSTRUCTORS:
            return
        name, anchor = self._literal_name(node)
        if name is None:
            return
        if not self._NAME_RE.match(name):
            yield (
                f"metric name {name!r} violates the convention "
                "^[a-z][a-z0-9_]*$ (sanitized-equal names merge into "
                "one exported series)",
                anchor,
            )
        elif kind == "Counter" and not name.endswith("_total"):
            yield (
                f"counter {name!r} must end in `_total` (Prometheus "
                "counter convention; rate() readers depend on it)",
                anchor,
            )
        for kw in node.keywords:
            if kw.arg != "tag_keys":
                continue
            if not isinstance(kw.value, (ast.Tuple, ast.List)):
                continue
            for element in kw.value.elts:
                if not isinstance(element, ast.Constant):
                    continue
                label = element.value
                if isinstance(label, str) and not self._NAME_RE.match(
                    label
                ):
                    yield (
                        f"label key {label!r} on metric {name!r} "
                        "violates the convention ^[a-z][a-z0-9_]*$",
                        element,
                    )


class UnboundedMetricLabels(Rule):
    """RT010: a metric label whose value is a per-request identity
    (request id, object id, task id, …) mints one Prometheus series
    per id — the head's aggregate table and every scrape grow without
    bound, and no PromQL aggregation wants the id anyway. The memory
    ledger deliberately exports only top-K owners for exactly this
    reason; per-id detail belongs in the state API
    (`ray_tpu_torch state ls objects`), traces, or the flight recorder.
    Also banned: pre-joined src/dst PAIR keys (`flow`, `src_dst`,
    `pair`, `edge`, `route`) — the transfer matrix keys on src_node
    and dst_node as SEPARATE labels (N + N series each, and PromQL
    can aggregate either side); a fused pair label is N² cardinality
    that no aggregation can take apart. Scope: metric declarations
    (`tag_keys=`) and record sites (`.inc/.set/.observe(tags={...})`)
    in the package."""

    id = "RT010"
    title = "unbounded-cardinality metric label (per-request/object id)"
    exclude = ("tests/",)

    _CONSTRUCTORS = ("Counter", "Gauge", "Histogram")
    _RECORDERS = ("inc", "set", "observe")
    #: Label keys whose values are per-entity identities. `job` is
    #: deliberately absent: jobs are few and the ledger/goodput series
    #: key on them by design. `digest`/`shape_digest` are the XLA
    #: compile-watch case: one series per arg-shape set is unbounded
    #: under exactly the recompile storm the series exists to catch —
    #: compile metrics carry the program NAME only, digests stay in
    #: the bounded diagnostic ring (compile_watch.py). src_node /
    #: dst_node are each ALLOWED (node granularity is bounded and the
    #: transfer matrix keys on them by design); what is banned is any
    #: fused src-dst PAIR key — N² series that no PromQL aggregation
    #: can decompose back into per-node sums. `edge` is deliberately
    #: absent: the compiled-DAG channel metrics key on it and a
    #: static DAG's edge set is bounded by the program, not the
    #: cluster — the dynamic pair keys below are what RT010 rejects.
    _BANNED = re.compile(
        r"^(request|object|task|actor|worker|span|trace|lease|"
        r"session|batch|flow|transfer|pull)_?id$|^(oid|tid|rid)$|"
        r"^(shape_)?digest$|^shapes?$|"
        r"^flow$|^(src_dst|dst_src)(_pair)?$|^(node_)?pair$|^route$|"
        r"^(object|obj)_?ref$"
    )

    def _flag(self, key: str, where: str, anchor) -> Iterable[Hit]:
        if isinstance(key, str) and self._BANNED.match(key):
            yield (
                f"metric label {key!r} {where} is a per-entity id — "
                "one exported series per id grows the head table and "
                "every scrape without bound; aggregate (top-K, "
                "totals) or move per-id detail to the state "
                "API/traces",
                anchor,
            )

    def on_call(self, node: ast.Call, ctx: LintContext) -> Iterable[Hit]:
        name = _terminal_name(node.func)
        if name in self._CONSTRUCTORS:
            for kw in node.keywords:
                if kw.arg != "tag_keys" or not isinstance(
                    kw.value, (ast.Tuple, ast.List)
                ):
                    continue
                for element in kw.value.elts:
                    if isinstance(element, ast.Constant):
                        yield from self._flag(
                            element.value,
                            f"declared on {name}()",
                            element,
                        )
        elif name in self._RECORDERS:
            for kw in node.keywords:
                if kw.arg != "tags" or not isinstance(
                    kw.value, ast.Dict
                ):
                    continue
                for key in kw.value.keys:
                    if isinstance(key, ast.Constant):
                        yield from self._flag(
                            key.value, f"passed to .{name}()", key
                        )


ALL_RULES = [
    BlockingGetInActor(),
    PayloadEqualityDedup(),
    WireNondeterminism(),
    ImportTimeForkHazard(),
    UnvalidatedNarrowing(),
    HardcodedNamespace(),
    SwallowedHandlerError(),
    MissingWaitTimeout(),
    MetricNamingConvention(),
    UnboundedMetricLabels(),
]
