"""Reads a torch.profiler window: device time by kernel group, the union
of device activity against the window's wall time, and the longest idle
gaps named by what the host was doing.

Kernel groups follow the port's kernel table: the flash kernels by
name, the matrix products (cuBLAS and CUTLASS kernels), NCCL's
collectives, and the rest ("elementwise": casts, norms, RoPE, adds, the
optimizer's loops, gathers). Copies and fills count as device activity
but in no kernel group.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

#: Substrings of every flash kernel's device name in the port.
FLASH_KERNELS = ("flash_fwd", "flash_bwd")
MATMUL_KERNELS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
COPY_PREFIXES = ("memcpy", "memset")
#: Spans the harness records around its calls into the program.
SPAN_PREFIX = "gpubench."
#: Idle gaps shorter than this (a launch's latency) are summed apart.
SHORT_GAP_US = 20.0


def group_of(name: str) -> str:
    low = name.lower()
    if low.startswith(COPY_PREFIXES):
        return "copy"
    if any(k in low for k in FLASH_KERNELS):
        return "flash"
    if "nccl" in low:
        return "nccl"
    if any(k in low for k in MATMUL_KERNELS):
        return "matmul"
    return "elementwise"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def summarize(device_events, host_events, window_s: float, top: int = 10
              ) -> dict:
    """`device_events` and `host_events`: (name, start_us, end_us) in one
    clock; `host_events` are the host's outermost ops and the harness's
    spans. Returns seconds by group and by kernel, busy seconds, the
    window, and the idle gaps between device activity by what overlaps
    them on the host."""
    # c10d marks each NCCL kernel's span again as "nccl:<op>".
    device_events = [d for d in device_events if not d[0].startswith("nccl:")]
    groups: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, float] = defaultdict(float)
    for name, start, end in device_events:
        groups[group_of(name)] += (end - start) * 1e-6
        kernels[name] += (end - start) * 1e-6
    busy = _union([(s, e) for _, s, e in device_events])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    spans = _Timeline([h for h in host_events if h[0].startswith(SPAN_PREFIX)])
    ops = _Timeline([h for h in host_events if not h[0].startswith(SPAN_PREFIX)])
    for (_, end), (start, _) in zip(busy, busy[1:]):
        if start - end < SHORT_GAP_US:
            name = f"gaps under {SHORT_GAP_US:g} us"
        else:
            name = f"{spans.most(end, start) or 'no span'} / {ops.most(end, start) or 'no op'}"
        gaps[name] += (start - end) * 1e-6
    return {
        "groups_s": dict(groups),
        "busy_s": busy_s,
        "window_s": window_s,
        "device_ops": sorted(kernels.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
    }


class _Timeline:
    """Host events sorted by start, to find the one that overlaps an
    interval most among the last `SCAN` that start before its end."""

    SCAN = 256

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e[1])
        self.starts = [e[1] for e in self.events]

    def most(self, g0: float, g1: float):
        i = bisect.bisect_left(self.starts, g1)
        best, name = 0.0, None
        for ev_name, s, e in self.events[max(0, i - self.SCAN):i]:
            over = min(g1, e) - max(g0, s)
            if over > best:
                best, name = over, ev_name
        return name


def warm_profiler(torch) -> None:
    """Start and stop the profiler once on a trivial op: its first start
    in a process pays CUPTI's set-up, which would land in a window."""
    w = Window(torch)
    w.start()
    torch.ones(1, device="cuda").add_(1)
    w.stop()


class Window:
    """A profiled window: `start`, `stop`, and later `summary` (reading
    the events holds the interpreter for seconds, so a caller with
    threads at work reads them once the work is done)."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.window_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        # Host ops of the starting thread only: recording another
        # thread's (the serving engine's) would slow it several-fold.
        # Kernels and runtime calls are recorded from every thread.
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, sync: bool = True) -> None:
        if sync:
            self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> dict:
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.prof.events():
            item = (e.name, e.time_range.start, e.time_range.end)
            annotation = (getattr(e, "is_user_annotation", False)
                          or e.name.startswith((SPAN_PREFIX, "ProfilerStep")))
            if e.device_type == DeviceType.CUDA:
                if not annotation:
                    device.append(item)
            elif e.cpu_parent is None or annotation:
                host.append(item)
        return summarize(device, host, self.window_s)


@contextmanager
def profiled(torch, record: dict):
    """Profile the body on the card and put `summarize`'s result into
    `record["trace"]`. The body should begin synchronised with the
    device; the window ends synchronised."""
    w = Window(torch)
    w.start()
    yield
    w.stop()
    record["trace"] = w.summary()
