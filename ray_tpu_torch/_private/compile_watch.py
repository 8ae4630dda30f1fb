# Copied from ray_tpu/_private/compile_watch.py, with the jax.monitoring
# listener replaced by one for nvcc builds and dynamo compiles, the digest
# keyed on the device too, and `device_memory` ported to torch.cuda.
"""Compile watcher (runtime core): the port's copy.

Eager PyTorch compiles nothing per shape. What the port does compile is
its CUDA kernels: `ops/_build.build` runs nvcc at first use and reports
each build here (`report_build`), and `torch.compile`'s dynamo, where a
caller loads it, reports its compiles through its callback hooks. So:

* ``instrument(name, fn)`` wraps every program the JAX package wraps,
  under the JAX package's names (`devtools/accel.py`'s inventory lists
  them). A call is keyed on its tensors' shape, dtype and device; a
  hit costs one digest and one set lookup. A new signature records
  one compile for the program, as the JAX watch's fallback branch
  does, so `compiles` and `distinct_shapes` count what the JAX package
  counts for the same calls: its ``duration_ms`` is the compile work
  attributed to the call (nvcc and dynamo; 0.0 when there was none),
  its ``wall_ms`` the first call's wall time.
* The listener is a thread-local frame stack, the JAX watch's: an
  nvcc build is a compile record of its own under ``kernel.<name>``
  with nvcc's wall time, and its seconds are credited to the innermost
  instrumented call running on the thread, as ``jax.monitoring``
  credits XLA's. ``compile_ms`` is billed once, by the program's
  record, or by the build itself when no program was running, and
  never for an eager miss: goodput stays honest.

The JAX package's description follows; read its XLA compiles as the
port's nvcc builds.

XLA-layer compile watcher (runtime core).

The framework can attribute every millisecond of a step to
data_wait/h2d/send/recv/queue stalls — but the layer that actually
burns the TPU, XLA, was a black box: a silent recompile storm (the
classic JAX perf killer: one drifting shape re-tracing the train step
or engine decode every iteration) showed up only as mysteriously slow
steps. This module is the per-process listener that turns compiles
into first-class observability:

* ``instrument(name, fn)`` wraps a jitted callable. The hot path is a
  digest of the call's arg shapes/dtypes checked against the shapes
  already seen — a tuple build + one set lookup, microseconds against
  a multi-ms step (the <1%-of-step bar is enforced by a unit test).
  A digest MISS means XLA is about to trace+compile: the call is
  timed, ``jax.monitoring`` event-duration hooks (registered lazily;
  available on jax 0.4.x) attribute the exact backend-compile seconds
  to the active program, and the compilation is recorded as
  (program name, shape digest, duration).
* Every recorded compile (a) bills ``compile_ms`` as a first-class
  stall phase into `step_telemetry` — cold-compile steps stop
  polluting steady-state goodput, exactly like data_wait/h2d; (b)
  exports ``rt_jax_compiles_total`` / ``rt_jax_compile_ms`` through
  the metrics pipe with the PROGRAM NAME as the only label (shape
  digests stay in the bounded diagnostic ring — RT010's
  bounded-cardinality rule holds by construction); (c) ships a
  ``kind="compile"`` record to the head, whose per-program digest
  ring makes a storm *diagnosable*: same program, ``>=
  compile_storm_threshold`` distinct shape digests -> `doctor`
  ``verdict.compile`` names the program, the compile count, and the
  differing shape dimension.
* ``device_memory()`` is the HBM side: per-process bytes-in-use/peak
  from ``device.memory_stats()`` on accelerator backends, ``None`` on
  CPU (degrade to ABSENT, never fake zeros) — `step_telemetry` folds
  it into every step record.

Digest semantics: array-typed leaves digest as (dtype, shape) — the
pair XLA keys its executable cache on. Python numeric scalars digest
as their TYPE only (jit weak-types them; digesting values would mint
a fake storm out of a healthy traced scalar), so a static-argnum
value change is undercounted rather than ever over-reported. Lives in
_private so the data/telemetry layers can import it without dragging
in jax; nothing here imports jax at module import time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import operator
import os
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "instrument",
    "WatchedFunction",
    "report_build",
    "record_compile",
    "fold_record",
    "snapshot",
    "detect_storms",
    "shape_delta",
    "device_memory",
    "configure",
    "enabled",
    "storm_threshold",
    "reset",
    "load_inventory",
    "static_hint",
]

#: Distinct shape digests retained per program (diagnostic ring; the
#: storm threshold must stay below this or a storm could never be
#: proven).
DIGEST_RING = 32

#: Cap on one WatchedFunction's seen-digest set. Under the very
#: storm the watcher detects, a drifting shape mints one digest per
#: iteration — without a cap the hot-path set grows for days. Clearing
#: on overflow costs re-misses for known shapes, each recorded again.
SEEN_CAP = 4096

#: Only digests seen within this window count toward a storm: a
#: cluster's lifetime legitimately accumulates distinct shapes
#: (warmup buckets, redeploys, successive jobs) — a storm is many
#: distinct shapes RECENTLY, and this window is what lets a healthy
#: long-lived cluster's doctor go back to exit 0 once the drifting
#: loop stops.
STORM_WINDOW_S = 600.0

#: rt_jax_compile_ms histogram boundaries (ms): sub-ms cache re-hits
#: through minutes-long TPU compiles.
COMPILE_MS_BOUNDARIES = (
    1.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0, 15000.0, 60000.0,
)

_lock = threading.Lock()  # rt: noqa[RT004] — held for dict ops only, never across a fork point
#: program name -> {"compiles", "total_ms", "digests": OrderedDict}
#: — the same structure the head daemon folds wire records into
#: (`fold_record`), so `detect_storms` serves both sides.
_programs: Dict[str, dict] = {}


def _env_enabled() -> bool:
    raw = os.environ.get("RT_compile_watch_enabled")
    if raw is None:
        return True
    return raw.lower() in ("1", "true", "yes")


_enabled = _env_enabled()
_storm_threshold = 8

#: Per-thread stack of the instrumented calls in flight (frames of
#: [program, credited seconds]): an nvcc build or a dynamo compile runs
#: on the thread that needs it, so the innermost frame there is the
#: program that pays for it.
_tl = threading.local()
_dynamo_installed = False


def configure(config) -> None:
    """Apply the cluster config. The env var stays the documented
    per-process kill switch (same contract as the flight recorder):
    registration must not re-enable a watcher this process's
    environment disabled."""
    global _enabled, _storm_threshold
    _enabled = _env_enabled() and bool(
        getattr(config, "compile_watch_enabled", True)
    )
    _storm_threshold = int(
        getattr(config, "compile_storm_threshold", _storm_threshold)
    )


def enabled() -> bool:
    return _enabled


def storm_threshold() -> int:
    return _storm_threshold


def reset() -> None:
    """Drop all recorded programs (tests)."""
    with _lock:
        _programs.clear()


# ---------------------------------------------------------------------
# arg digests
# ---------------------------------------------------------------------


_SCALARS = {type(None): ("S", "NoneType"), bool: ("S", "bool"),
            int: ("S", "int"), float: ("S", "float"),
            complex: ("S", "complex")}
#: torch's tensor types and nn.Module, once torch is loaded (never
#: imported from here): the hot path tests a leaf's type against them
#: before any attribute lookup.
_tensor_types: frozenset = frozenset()
_module_type: Any = ()
_dtype_of = operator.attrgetter("dtype")
_shape_of = operator.attrgetter("shape")
_device_of = operator.attrgetter("device")
#: A dict's keys in insertion order -> [marker, marker of a dict whose
#: values are all tensors, keys in sorted order or None when already
#: sorted, whether its values were all tensors when last checked].
#: Bounded like the seen sets.
_dict_plans: Dict[tuple, list] = {}


def _load_torch_types() -> None:
    global _tensor_types, _module_type
    torch = sys.modules.get("torch")
    if torch is not None and not _tensor_types:
        _tensor_types = frozenset((torch.Tensor, torch.nn.Parameter))
        _module_type = torch.nn.Module


def _dict_plan(x: dict, keys: tuple) -> list:
    try:
        ordered = sorted(x)
    except TypeError:
        ordered = sorted(x, key=str)
    names = tuple(map(str, ordered))
    plan = [("D",) + names, ("D*",) + names,
            None if tuple(ordered) == keys else tuple(ordered), False]
    if len(_dict_plans) >= SEEN_CAP:
        _dict_plans.clear()
    _dict_plans[keys] = plan
    return plan


def _walk(x: Any, kind: type, struct: list, tensors: list, depth: int,
          check: bool) -> None:
    """Flatten a dict, list or tuple: its markers and other leaves into
    `struct`, its tensors into `tensors`, in call order. A container
    whose values are all tensors is one starred marker and no tokens
    per value. For a dict, a check that found only tensors is kept
    with its keys and trusted unless `check`: `arg_digest` verifies
    the trust over all tensors at once and walks again with `check`
    when it failed, so a call's digest never depends on the cache."""
    if kind is dict:
        keys = tuple(x)
        plan = _dict_plans.get(keys)
        if plan is None:
            plan = _dict_plan(x, keys)
        values = x.values() if plan[2] is None else [x[k] for k in plan[2]]
        if check or not plan[3]:
            plan[3] = all(map(_tensor_types.__contains__, map(type, values)))
        marker, every, leafy = plan[0], plan[1], plan[3]
    else:
        tag = "U" if kind is tuple else "L"
        marker, every, values = (tag, len(x)), (tag + "*", len(x)), x
        leafy = all(map(_tensor_types.__contains__, map(type, x)))
    if leafy:
        struct.append(every)
        tensors += values
        return
    struct.append(marker)
    depth += 1
    for v in values:
        kind = type(v)
        if kind in _tensor_types:
            struct.append("A")
            tensors.append(v)
        elif kind is dict or kind is list or kind is tuple:
            if depth > 6:
                struct.append(("...",))
            else:
                _walk(v, kind, struct, tensors, depth, check)
        else:
            struct.append(_sig(v, depth))


def _sig(x: Any, depth: int = 0) -> tuple:
    """Structural signature of a leaf `_walk` does not flatten: numeric
    scalars keep only their type (see module docstring), strings keep
    their value, an `nn.Module` counts by its type (its weights are
    state the call reads, and the config that sizes them travels as an
    argument of its own), array-likes become ("A", dtype, shape,
    device), and containers of other types recurse."""
    kind = type(x)
    scalar = _SCALARS.get(kind)
    if scalar is not None:
        return scalar
    if kind is str:
        return ("C", x)
    if kind in _tensor_types:
        return ("A", x.dtype, x.shape, x.device)
    if depth > 6:
        return ("...",)
    if isinstance(x, _module_type):
        return ("T", kind.__name__)
    shape = getattr(x, "shape", None)
    if shape is not None:
        dtype = getattr(x, "dtype", None)
        if dtype is not None:
            return ("A", dtype, tuple(shape), getattr(x, "device", None))
    if isinstance(x, (bool, int, float, complex)):
        return ("S", type(x).__name__)
    if isinstance(x, str):
        return ("C", x)
    if isinstance(x, (tuple, list)):
        return tuple(_sig(v, depth + 1) for v in x)
    if isinstance(x, dict):
        return (
            "D",
            tuple(
                (str(k), _sig(v, depth + 1))
                for k, v in sorted(x.items(), key=lambda kv: str(kv[0]))
            ),
        )
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (
            "O",
            type(x).__name__,
            tuple(
                (f.name, _sig(getattr(x, f.name), depth + 1))
                for f in dataclasses.fields(x)
            ),
        )
    return ("T", type(x).__name__)


def arg_digest(args: tuple, kwargs: dict) -> tuple:
    """Hashable digest of a call's shape/dtype structure — the hot
    path of every instrumented call (the <1%-of-step bar lives
    here). The port's walk (the JAX package's fast path is jax's C
    tree_flatten) flattens the containers into a tuple of markers and
    a list of tensors, whose dtypes, shapes and devices are read in
    three C loops: (markers, dtypes, shapes, devices), the objects
    stringified only when a compile is recorded."""
    if not _tensor_types:
        _load_torch_types()
    struct: list = []
    tensors: list = []
    _walk(args, tuple, struct, tensors, 0, False)
    if kwargs:
        _walk(kwargs, dict, struct, tensors, 0, False)
    if not all(map(_tensor_types.__contains__, map(type, tensors))):
        # A dict that held only tensors when last seen holds more now.
        struct.clear()
        tensors.clear()
        _walk(args, tuple, struct, tensors, 0, True)
        if kwargs:
            _walk(kwargs, dict, struct, tensors, 0, True)
    return (tuple(struct), tuple(map(_dtype_of, tensors)),
            tuple(map(_shape_of, tensors)), tuple(map(_device_of, tensors)))


def _array_leaves(sig: Any, out: List[tuple]) -> None:
    if isinstance(sig, tuple):
        if len(sig) == 4 and sig[0] == "A":
            leaf = (str(sig[1]).replace("torch.", ""), tuple(sig[2]))
            out.append(leaf if sig[3] is None else leaf + (str(sig[3]),))
            return
        for part in sig:
            _array_leaves(part, out)


def digest_leaves(digest: Any) -> List[tuple]:
    """The (dtype, shape, device) array leaves of a digest, in call
    order — what `shape_delta` diffs and the wire ships: the tensors
    where the markers place them, and the array-likes inside other
    leaves' signatures."""
    struct, dtypes, shapes, devices = digest
    tensors = iter(range(len(dtypes)))
    leaves: List[tuple] = []
    for token in struct:
        if token == "A":
            count = 1
        elif token[:1] in (("D*",), ("L*",), ("U*",)):
            count = len(token) - 1 if token[0] == "D*" else token[1]
        else:
            _array_leaves(token, leaves)
            continue
        for i in itertools.islice(tensors, count):
            leaves.append((str(dtypes[i]).replace("torch.", ""),
                           tuple(shapes[i]), str(devices[i])))
    return leaves


_DTYPE_SHORT = {
    "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "float64": "f64", "int32": "i32", "int64": "i64", "int8": "i8",
    "uint8": "u8", "bool": "b1",
}


def _leaf_repr(leaf: tuple) -> str:
    dtype, shape = leaf[0], leaf[1]
    short = _DTYPE_SHORT.get(str(dtype), str(dtype))
    device = f"@{leaf[2]}" if len(leaf) > 2 else ""
    return f"{short}[{','.join(str(d) for d in shape)}]{device}"


def shapes_repr(leaves) -> str:
    """Compact human rendering of a digest's array leaves, e.g.
    ``i32[1,32] f32[8,256]`` (bounded: first 8 leaves + a count)."""
    leaves = list(leaves)
    head = " ".join(_leaf_repr(leaf) for leaf in leaves[:8])
    if len(leaves) > 8:
        head += f" +{len(leaves) - 8} more"
    return head


def digest_key(digest: Any) -> str:
    """Deterministic short key for a digest — stable ACROSS processes
    (`hash()` is salted per interpreter), so the head's distinct-shape
    count doesn't inflate when eight ranks compile the same shape."""
    return hashlib.sha1(repr(digest).encode()).hexdigest()[:12]


def shape_delta(prev_leaves, new_leaves) -> str:
    """Name WHAT drifted between two compiles of one program: the
    first array leaf whose shape/dtype differs, down to the
    dimension — the 'find the drifting shape' half of the recompile
    runbook. Indices are FLATTENED array-leaf positions in call
    order (a nested param tree contributes many leaves before the
    batch arrays), so the message says "array leaf", never "arg"."""
    prev_leaves, new_leaves = list(prev_leaves), list(new_leaves)
    prev_leaves = [tuple(leaf) if not isinstance(leaf, tuple) else leaf
                   for leaf in prev_leaves]
    new_leaves = [tuple(leaf) if not isinstance(leaf, tuple) else leaf
                  for leaf in new_leaves]
    if len(prev_leaves) != len(new_leaves):
        return (
            f"array-leaf arity changed: {len(prev_leaves)} -> "
            f"{len(new_leaves)} array leaves"
        )
    for i, (a, b) in enumerate(zip(prev_leaves, new_leaves)):
        a = (a[0], tuple(a[1])) + tuple(a[2:])
        b = (b[0], tuple(b[1])) + tuple(b[2:])
        if a == b:
            continue
        if a[0] != b[0]:
            return (
                f"array leaf {i}: dtype "
                f"{_leaf_repr(a)} -> {_leaf_repr(b)}"
            )
        if a[1] == b[1]:
            return (
                f"array leaf {i}: device "
                f"{_leaf_repr(a)} -> {_leaf_repr(b)}"
            )
        dims = [
            d for d, (x, y) in enumerate(zip(a[1], b[1])) if x != y
        ] or ["rank"]
        return (
            f"array leaf {i}: {_leaf_repr(a)} -> {_leaf_repr(b)} "
            f"(dim {dims[0]} drifting)"
        )
    return "shapes identical (static-arg or donation change)"


# ---------------------------------------------------------------------
# the program table (shared shape: local registry AND head fold)
# ---------------------------------------------------------------------


def fold_record(
    programs: Dict[str, dict],
    program: str,
    duration_ms: float,
    info: Optional[dict] = None,
    ring: int = DIGEST_RING,
) -> None:
    """Fold one compile event into a program table. Used by the local
    registry below and by the head daemon on ``kind="compile"`` wire
    records — one structure, one storm detector. Caller owns
    locking."""
    info = info or {}
    row = programs.setdefault(
        program,
        {"compiles": 0, "total_ms": 0.0, "digests": OrderedDict()},
    )
    row["compiles"] += 1
    row["total_ms"] += float(duration_ms)
    key = info.get("digest")
    if not key:
        return
    digests = row["digests"]
    entry = digests.get(key)
    if entry is not None:
        entry["count"] += 1
        entry["ms"] = float(duration_ms)
        entry["time"] = float(info.get("time", time.time()))
        digests.move_to_end(key)
        return
    while len(digests) >= ring:
        digests.popitem(last=False)
    digests[key] = {
        "count": 1,
        "ms": round(float(duration_ms), 3),
        "time": float(info.get("time", time.time())),
        "shapes": str(info.get("shapes", "")),
        "leaves": tuple(
            tuple(leaf) for leaf in info.get("leaves", ())
        ),
    }


def detect_storms(
    programs: Dict[str, dict],
    threshold: Optional[int] = None,
    window_s: float = STORM_WINDOW_S,
) -> List[dict]:
    """Recompile-storm findings over a program table: same program
    name, >= threshold distinct shape digests seen within
    `window_s`. A healthy program with a bounded bucket family
    (prefill length buckets, policy batch buckets) mints its digests
    once at warmup and they AGE OUT of the window; a drifting shape
    mints a new digest every iteration and holds the count above
    threshold for as long as the storm runs."""
    threshold = _storm_threshold if threshold is None else int(threshold)
    now = time.time()
    storms: List[dict] = []
    for name in sorted(programs):
        row = programs[name]
        digests = row.get("digests") or {}
        keys = [
            k
            for k, entry in digests.items()
            if float(entry.get("time", now)) >= now - window_s
        ]
        if len(keys) < max(2, threshold):
            continue
        delta = shape_delta(
            digests[keys[-2]].get("leaves", ()),
            digests[keys[-1]].get("leaves", ()),
        )
        last = digests[keys[-1]]
        storms.append(
            {
                "program": name,
                "compiles": row["compiles"],
                "distinct_shapes": len(keys),
                "total_ms": round(row["total_ms"], 1),
                "last_shapes": last.get("shapes", ""),
                "delta": delta,
                "detail": (
                    f"program {name!r} compiled {row['compiles']}x "
                    f"over {len(keys)} recent distinct arg-shape "
                    f"sets ({row['total_ms']:.0f} ms total) — "
                    f"{delta}"
                ),
            }
        )
    return storms


def snapshot() -> Dict[str, dict]:
    """This process's per-program compile table (counts, total ms,
    digest ring) — the local half of ``verdict.compile``; the head
    serves the cluster-folded equivalent."""
    with _lock:
        out: Dict[str, dict] = {}
        for name, row in _programs.items():
            out[name] = {
                "compiles": row["compiles"],
                "total_ms": round(row["total_ms"], 3),
                "distinct_shapes": len(row["digests"]),
                "digests": {
                    k: dict(v) for k, v in row["digests"].items()
                },
            }
        return out


# ---------------------------------------------------------------------
# recording + instrumentation
# ---------------------------------------------------------------------


def record_compile(
    program: str,
    digest: Any,
    duration_ms: float,
    *,
    wall_ms: Optional[float] = None,
    bill: bool = True,
) -> None:
    """Record one compilation: local ring, ``compile_ms`` stall
    phase, and the metrics pipe (counter + histogram labeled by
    program NAME only; digest/shape detail rides the kind="compile"
    record into the head's bounded diagnostic ring, never a metric
    label). ``compile_ms`` is billed only for compile work
    (`duration_ms` > 0) and only when `bill`: an eager miss bills
    nothing, and a build credited to a running program is billed by
    that program's record."""
    if not _enabled:
        return
    now = time.time()
    leaves = digest_leaves(digest) if digest is not None else []
    info = {
        "digest": digest_key(digest) if digest is not None else "",
        "shapes": shapes_repr(leaves) if leaves else "",
        "leaves": leaves,
        "time": now,
    }
    with _lock:
        fold_record(_programs, program, duration_ms, info)
    # Cold-compile time is a stall the loop paid, exactly like
    # data_wait: bill it so the compiling step's residual step_ms
    # stays honest and goodput classifies it as stall, not compute.
    if bill and duration_ms > 0.0:
        from .step_telemetry import add_phase

        add_phase("compile_ms", float(duration_ms))
    try:
        from ..util.metrics import _Buffer

        tags = (("program", str(program)),)
        buf = _Buffer.get()
        buf.push(
            ("counter", "rt_jax_compiles_total", 1.0, tags)
        )
        buf.push(
            (
                "histogram",
                "rt_jax_compile_ms",
                float(duration_ms),
                tags,
                COMPILE_MS_BOUNDARIES,
            )
        )
        buf.push(
            (
                "compile",
                str(program),
                float(duration_ms),
                tuple(
                    sorted(
                        {
                            "pid": os.getpid(),
                            "digest": info["digest"],
                            "shapes": info["shapes"],
                            "leaves": tuple(
                                tuple(leaf) for leaf in leaves
                            ),
                            "wall_ms": round(
                                float(
                                    wall_ms
                                    if wall_ms is not None
                                    else duration_ms
                                ),
                                3,
                            ),
                        }.items()
                    )
                ),
            )
        )
    except Exception:  # noqa: BLE001 — observability never raises
        pass


# ---------------------------------------------------------------------
# the listener: nvcc builds and dynamo compiles
# ---------------------------------------------------------------------


def _active_stack() -> list:
    stack = getattr(_tl, "stack", None)
    if stack is None:
        stack = _tl.stack = []
    return stack


def _credit(seconds: float) -> bool:
    """Credit compile seconds to the innermost instrumented call on
    this thread; False when none is running."""
    stack = getattr(_tl, "stack", None)
    if not stack:
        return False
    stack[-1][1] += float(seconds)
    return True


def report_build(kernels: Dict[str, float], seconds: float) -> None:
    """What `ops/_build.build` calls after compiling kernels: one
    record per kernel under ``kernel.<name>`` with nvcc's wall time
    for it (seconds), and the build's wall time (`seconds`, the
    sources compile in parallel) credited to the instrumented call
    running on this thread, or billed as ``compile_ms`` itself when
    none is."""
    credited = _credit(seconds)
    for name, kernel_s in kernels.items():
        record_compile(f"kernel.{name}", None, float(kernel_s) * 1e3,
                       bill=False)
    if not credited and _enabled and seconds > 0.0:
        from .step_telemetry import add_phase

        add_phase("compile_ms", float(seconds) * 1e3)


def _on_dynamo_start(*_args) -> None:
    _tl.dynamo_t0 = time.perf_counter()


def _on_dynamo_end(*_args) -> None:
    t0 = getattr(_tl, "dynamo_t0", None)
    if t0 is None:
        return
    _tl.dynamo_t0 = None
    seconds = time.perf_counter() - t0
    if not _credit(seconds):
        # A compile outside any instrumented program: still counted,
        # with no digest, so it can never fake a storm.
        record_compile("(unregistered)", None, seconds * 1e3)


def _install_dynamo() -> None:
    """Hook dynamo's compile callbacks once, and only where a caller
    has loaded dynamo: the watcher never imports it."""
    global _dynamo_installed
    if _dynamo_installed or "torch._dynamo" not in sys.modules:
        return
    with _lock:
        if _dynamo_installed:
            return
        _dynamo_installed = True
        try:
            from torch._dynamo.callback import (
                on_compile_end,
                on_compile_start,
            )

            on_compile_start(_on_dynamo_start)
            on_compile_end(_on_dynamo_end)
        except Exception:  # noqa: BLE001 — a dynamo without the hooks
            pass


class WatchedFunction:
    """An instrumented program. Hot path (signature already seen):
    digest + one set lookup, then straight through. Miss path: the
    call runs inside a thread-local program frame, so the listener
    credits it with any nvcc build or dynamo compile it triggers, and
    one compile is recorded for the new signature."""

    __slots__ = ("name", "_fn", "_seen", "_seen_lock")

    def __init__(self, name: str, fn: Callable):
        self.name = str(name)
        self._fn = fn
        self._seen: set = set()
        self._seen_lock = threading.Lock()
        _install_dynamo()

    def __call__(self, *args, **kwargs):
        if not _enabled:
            return self._fn(*args, **kwargs)
        digest = arg_digest(args, kwargs)
        with self._seen_lock:
            hit = digest in self._seen
            if not hit:
                # Claimed before the call: a thread missing the same new
                # signature meanwhile takes the hit path, so the
                # signature is recorded once.
                if len(self._seen) >= SEEN_CAP:
                    self._seen.clear()
                self._seen.add(digest)
        if hit:
            return self._fn(*args, **kwargs)
        _install_dynamo()
        stack = _active_stack()
        frame = [self.name, 0.0]
        stack.append(frame)
        t0 = time.perf_counter()
        try:
            out = self._fn(*args, **kwargs)
        except BaseException:
            # A call that failed saw no signature: the next one records.
            with self._seen_lock:
                self._seen.discard(digest)
            raise
        finally:
            stack.pop()
        wall_ms = (time.perf_counter() - t0) * 1e3
        record_compile(self.name, digest, frame[1] * 1e3, wall_ms=wall_ms)
        return out

    def signatures(self) -> int:
        """The signatures this wrapper has seen (its hot-path set)."""
        with self._seen_lock:
            return len(self._seen)

    def stats(self) -> Dict[str, Any]:
        """This program's compile counts from the process registry
        (the `engine_stats` surface: a mid-traffic new signature is an
        engine bug — now a visible counter)."""
        with _lock:
            row = _programs.get(self.name)
            if row is None:
                return {"compiles": 0, "distinct_shapes": 0}
            return {
                "compiles": row["compiles"],
                "distinct_shapes": len(row["digests"]),
            }


def instrument(name: str, fn: Callable) -> WatchedFunction:
    """Register a program with the compile watcher by NAME and return
    the wrapped callable. Names must be bounded-cardinality (program
    families, not per-request ids): they become the only label on the
    exported compile series."""
    return WatchedFunction(name, fn)


# ---------------------------------------------------------------------
# device memory (HBM) telemetry
# ---------------------------------------------------------------------


def device_memory() -> Optional[Dict[str, int]]:
    """HBM stats of this process's card, from
    ``torch.cuda.memory_stats()`` (the JAX package reads
    ``device.memory_stats()`` of its local devices): bytes in use and
    the peak by PyTorch's allocator, and the card's total memory as the
    limit. Returns None when torch is not loaded or CUDA is not
    initialised in this process (probing must never be the call that
    initialises it) — callers must treat None as ABSENT (no fields),
    never as zero: a fake 0/NaN would read as 'no pressure' on exactly
    the rank being diagnosed."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats()
        limit = torch.cuda.get_device_properties(
            torch.cuda.current_device()
        ).total_memory
    except Exception:  # noqa: BLE001 — probing must never raise
        return None
    if "allocated_bytes.all.current" not in stats:
        return None
    out = {
        "hbm_bytes_in_use": int(stats["allocated_bytes.all.current"]),
        "hbm_peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
    }
    if limit > 0:
        out["hbm_bytes_limit"] = int(limit)
    return out


# ---------------------------------------------------------------------
# static inventory bridge (devtools/accel.py <-> verdict.compile)
# ---------------------------------------------------------------------

#: Cached program inventory (or False after a failed load, so a
#: broken environment probes the filesystem exactly once).
_inventory: Any = None


def load_inventory(path: Optional[str] = None, *, refresh: bool = False):
    """The static half of the bridge: the program inventory produced
    by ``python -m ray_tpu_torch.devtools.accel --inventory`` (every
    `instrument` site, its registered program name, and its RT302
    recompile-hazard sites). Resolution order: explicit `path` arg ->
    ``RT_accel_inventory`` env var (a JSON file, for clusters whose CI
    exports the inventory as an artifact) -> a lazy in-process scan of
    the installed package. Returns the inventory dict or None; failures
    are cached so the doctor path never pays the scan twice."""
    global _inventory
    if refresh:
        _inventory = None
    if _inventory is not None:
        return _inventory or None
    src = path or os.environ.get("RT_accel_inventory")
    try:
        if src:
            import json

            with open(src) as f:
                _inventory = json.load(f)
        else:
            from ..devtools.accel import build_inventory

            pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            _inventory = build_inventory([pkg])
    except Exception:  # noqa: BLE001 — a hint source must never break diagnose
        _inventory = False
        return None
    return _inventory or None


def static_hint(program: str) -> Optional[str]:
    """Resolve a live program name (as seen in a recompile storm) to
    its static wrap site and any RT302 hazards the analyzer proved
    there. Literal inventory names match exactly; f-string program
    names were inventoried as fnmatch patterns (``engine.run[*]``).
    Returns a one-line human hint or None when the bridge has nothing
    — absence of a hint must read as 'unknown', not 'clean'."""
    inv = load_inventory()
    if not inv:
        return None
    import re

    def _pattern_matches(pattern: str, name: str) -> bool:
        # Program names legitimately contain fnmatch metacharacters
        # (`engine.run[gen3]`), so only `*` is a wildcard — everything
        # else matches literally.
        parts = (re.escape(p) for p in pattern.split("*"))
        return re.fullmatch(".*".join(parts), name) is not None

    match = None
    for rec in inv.get("programs", ()):
        name = rec.get("program")
        if not name:
            continue
        if rec.get("name_kind") == "literal":
            if name == program:
                match = rec
                break
        elif _pattern_matches(name, program) and match is None:
            match = rec
    if match is None:
        return None
    site = f"{match['path']}:{match['line']}"
    hazards = match.get("hazards") or []
    if hazards:
        spots = "; ".join(
            f"{h['path']}:{h['line']} {h['message']}" for h in hazards
        )
        return (
            f"static analysis flagged this program (RT302): {spots} "
            f"[wrap at {site}]"
        )
    return (
        f"wrap site {site} has no static RT302 hazard on record — "
        f"suspect call-site shape drift; run "
        f"`python -m ray_tpu_torch.devtools.accel` after reproducing"
    )
