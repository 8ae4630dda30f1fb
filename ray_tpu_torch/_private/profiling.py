# Copied from ray_tpu/_private/profiling.py, with the gang window's device
# trace ported from jax.profiler to torch.profiler.
"""In-process on-demand profilers.

Reference: python/ray/dashboard/modules/reporter/profile_manager.py —
the dashboard attaches py-spy (CPU stacks / flamegraph) or memray
(allocations) to a live worker on demand. Neither tool ships in this
environment, and both need ptrace or an injected allocator; the
TPU-native rebuild profiles from INSIDE the worker instead — every
worker already runs an RPC server, so the profilers are pure-Python
handlers over interpreter introspection:

  cpu    — wall-clock stack sampler over sys._current_frames at a
           fixed rate; emits collapsed/folded stacks ("a;b;c N"), the
           flamegraph.pl / speedscope interchange format py-spy's
           --format raw produces.
  memory — tracemalloc window: top allocation sites grouped by
           traceback between start and stop.
  stack  — one immediate dump of every thread's Python stack
           (py-spy dump equivalent).

In-process sampling observes only Python frames (a thread stuck in C
shows its last Python frame — same blind spot py-spy --native=false
has) and costs nothing while not attached.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter
from typing import Dict, List, Optional


def dump_stacks() -> str:
    """All threads' current Python stacks as text."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        out.append(
            f"--- thread {ident} ({names.get(ident, '?')}) ---"
        )
        out.extend(
            line.rstrip()
            for line in traceback.format_stack(frame)
        )
    return "\n".join(out)


def _folded(frame) -> str:
    """One sampled stack, root-first, flamegraph-collapsed."""
    parts: List[str] = []
    while frame is not None:
        code = frame.f_code
        parts.append(
            f"{code.co_name} "
            f"({code.co_filename.rsplit('/', 1)[-1]}"
            f":{frame.f_lineno})"
        )
        frame = frame.f_back
    return ";".join(reversed(parts))


def sample_cpu(
    duration_s: float = 5.0,
    hz: float = 100.0,
    exclude_thread: Optional[int] = None,
) -> dict:
    """Sample all threads for `duration_s` at `hz`.

    Returns {"folded": "stack N\n...", "samples": n, "threads": k}.
    The sampler thread excludes itself (and optionally the caller's
    RPC thread) so the profile shows the profilee, not the profiler.
    """
    duration_s = min(float(duration_s), 120.0)
    interval = 1.0 / max(1.0, min(float(hz), 1000.0))
    me = threading.get_ident()
    counts: Counter = Counter()
    threads_seen: set = set()
    samples = 0
    deadline = time.monotonic() + duration_s
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me or ident == exclude_thread:
                continue
            threads_seen.add(ident)
            counts[_folded(frame)] += 1
        samples += 1
        time.sleep(interval)
    folded = "\n".join(
        f"{stack} {n}" for stack, n in counts.most_common()
    )
    return {
        "folded": folded,
        "samples": samples,
        "threads": len(threads_seen),
        "duration_s": duration_s,
        "hz": hz,
    }


def profile_memory(duration_s: float = 5.0, top: int = 20) -> dict:
    """tracemalloc window: allocations between start and stop,
    grouped by allocation site, biggest first."""
    import tracemalloc

    duration_s = min(float(duration_s), 120.0)
    was_tracing = tracemalloc.is_tracing()
    if not was_tracing:
        tracemalloc.start(10)
    try:
        before = tracemalloc.take_snapshot()
        time.sleep(duration_s)
        after = tracemalloc.take_snapshot()
    finally:
        if not was_tracing:
            tracemalloc.stop()
    stats = after.compare_to(before, "traceback")
    entries = []
    for stat in stats[: int(top)]:
        entries.append(
            {
                "size_diff_kb": round(stat.size_diff / 1024, 1),
                "count_diff": stat.count_diff,
                "traceback": stat.traceback.format(),
            }
        )
    current, peak = (
        tracemalloc.get_traced_memory()
        if tracemalloc.is_tracing()
        else (0, 0)
    )
    return {
        "top": entries,
        "traced_current_kb": round(current / 1024, 1),
        "traced_peak_kb": round(peak / 1024, 1),
        "duration_s": duration_s,
    }


#: Cap on chrome-trace slices one timeline capture may emit (a 100 Hz
#: window over a thrashing thread churns slices; the merged gang
#: artifact must stay loadable).
_MAX_TIMELINE_EVENTS = 20000


def sample_timeline(
    duration_s: float = 2.0,
    hz: float = 100.0,
    start_at: Optional[float] = None,
) -> dict:
    """Wall-clock TIMELINE sampler: like `sample_cpu`, but instead of
    folding samples into counts it coalesces consecutive samples of
    one thread's leaf frame into chrome-trace 'X' slices on the
    UNIX-EPOCH-us clock — the shared clock every rank of a gang
    agrees on, which is what makes the merged gang profile line up.
    `start_at` (unix seconds) synchronizes the window start across
    ranks: the sampler sleeps until then before its first sample.
    Returns {"events", "folded", "samples", "threads", "t0", "t1"}.
    """
    duration_s = min(float(duration_s), 120.0)
    interval = 1.0 / max(1.0, min(float(hz), 1000.0))
    if start_at is not None:
        delay = float(start_at) - time.time()
        if delay > 0:
            time.sleep(min(delay, 30.0))
    me = threading.get_ident()
    counts: Counter = Counter()
    #: thread ident -> [slice_name, start_us, last_seen_us]
    open_slices: Dict[int, list] = {}
    events: List[dict] = []
    names = {t.ident: t.name for t in threading.enumerate()}

    def close(ident: int, now_us: float) -> None:
        entry = open_slices.pop(ident, None)
        if entry is None or len(events) >= _MAX_TIMELINE_EVENTS:
            return
        name, start_us, _last = entry
        events.append(
            {
                "name": name,
                "cat": "sample",
                "ph": "X",
                "ts": start_us,
                "dur": max(1.0, now_us - start_us),
                "pid": "profile",
                "tid": names.get(ident, f"thread {ident}"),
            }
        )

    samples = 0
    threads_seen: set = set()
    t0 = time.time()
    deadline = t0 + duration_s
    while time.time() < deadline:
        now_us = time.time() * 1e6
        frames = sys._current_frames()
        for ident in list(open_slices):
            if ident not in frames:
                close(ident, now_us)
        for ident, frame in frames.items():
            if ident == me:
                continue
            threads_seen.add(ident)
            if ident not in names:
                names[ident] = next(
                    (
                        t.name
                        for t in threading.enumerate()
                        if t.ident == ident
                    ),
                    f"thread {ident}",
                )
            code = frame.f_code
            leaf = (
                f"{code.co_name} "
                f"({code.co_filename.rsplit('/', 1)[-1]}"
                f":{frame.f_lineno})"
            )
            counts[_folded(frame)] += 1
            entry = open_slices.get(ident)
            if entry is not None and entry[0] == leaf:
                entry[2] = now_us
            else:
                if entry is not None:
                    close(ident, now_us)
                open_slices[ident] = [leaf, now_us, now_us]
        samples += 1
        time.sleep(interval)
    end_us = time.time() * 1e6
    for ident in list(open_slices):
        close(ident, end_us)
    return {
        "events": events,
        "folded": "\n".join(
            f"{stack} {n}" for stack, n in counts.most_common()
        ),
        "samples": samples,
        "threads": len(threads_seen),
        "duration_s": duration_s,
        "hz": hz,
        "t0": t0,
        "t1": end_us / 1e6,
    }


def capture_gang(
    duration_s: float = 2.0,
    hz: float = 100.0,
    start_at: Optional[float] = None,
) -> dict:
    """One rank's share of a coordinated gang-profile window. In a
    process that has initialised CUDA the window additionally runs
    under a `torch.profiler` trace of the card (CPU and CUDA
    activities), exported as a chrome trace whose path rides back in
    the result as "device_trace" (the JAX package takes a
    `jax.profiler` trace the same way, when jax is loaded); everywhere
    else — and alongside it — the in-process timeline sampler provides
    the chrome-trace slices the head merges. torch is only touched
    when the process already imported it and CUDA is initialised (the
    window never initialises it); failures degrade to sampler-only,
    never fail the capture."""
    import sys as _sys

    profiler = None
    torch = _sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                from torch.profiler import ProfilerActivity, profile

                profiler = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                profiler.start()
        except Exception:  # noqa: BLE001 — sampler-only fallback
            profiler = None
    trace_path = None
    try:
        result = sample_timeline(
            duration_s=duration_s, hz=hz, start_at=start_at
        )
    finally:
        if profiler is not None:
            try:
                profiler.stop()
                import tempfile

                trace_dir = tempfile.mkdtemp(prefix="rt_gang_trace_")
                trace_path = f"{trace_dir}/device_trace.json"
                profiler.export_chrome_trace(trace_path)
            except Exception:  # noqa: BLE001
                trace_path = None
    if trace_path is not None:
        result["device_trace"] = trace_path
    return result


#: RPC surface: kind -> handler(**params). Registered on the worker's
#: direct server and reachable through the daemon/head `profile_worker`
#: relay (dashboard /api/profile) — `gang` is the synchronized-window
#: capture rt.profile_gang fans out.
def run_profile(kind: str, **params) -> dict:
    if kind == "stack":
        return {"stacks": dump_stacks()}
    if kind == "cpu":
        return sample_cpu(
            duration_s=params.get("duration_s", 5.0),
            hz=params.get("hz", 100.0),
            exclude_thread=params.get("exclude_thread"),
        )
    if kind == "memory":
        return profile_memory(
            duration_s=params.get("duration_s", 5.0),
            top=params.get("top", 20),
        )
    if kind == "gang":
        return capture_gang(
            duration_s=params.get("duration_s", 2.0),
            hz=params.get("hz", 100.0),
            start_at=params.get("start_at"),
        )
    raise ValueError(f"unknown profile kind: {kind!r}")
