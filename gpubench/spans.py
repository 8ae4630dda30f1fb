"""Reads a profiled window against the program's own spans: the serving
engine's loop and the train step record theirs in the process's flight
recorder (`ray_tpu_torch._private.flight_recorder`), both ends stamped
with `time.time_ns()`, the clock of torch.profiler's events, so that
`trace_start_ns` turns them into the profiler's microseconds.

`summarize` is `trace.summarize` with more readings, given spans:
`span_device_s`, the device seconds of each kernel, copy and fill by the
innermost program span open when the host called the runtime for it
(the call the profiler links to it by correlation id); idle gaps named
by the program span that covers most of each gap, the harness's
`gpubench.` span only where none does; and `idle_by_span_s`, the idle
seconds of the gaps of at least `trace.SHORT_GAP_US` by that name alone.
Without program spans it returns exactly what `trace.summarize` returns.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace

#: Spans that time a request's wait, not a thread's work: they overlap
#: the engine's own spans and launch nothing.
WAIT_SPANS = ("engine.queue",)
#: Kinds of the program's spans.
KINDS = ("engine", "train")
NO_SPAN = "no span"

Span = Tuple[str, float, float]


class _Spans:
    """Spans sorted by start; the innermost one open at a time is the
    latest started that has not ended (they nest or follow)."""

    SCAN = 64

    def __init__(self, spans: Sequence[Span]):
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.starts = [s[1] for s in self.spans]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t)
        for name, start, end in reversed(self.spans[max(0, i - self.SCAN):i]):
            if end >= t:
                return name
        return None

    def most(self, g0: float, g1: float) -> Optional[str]:
        """The span that overlaps [g0, g1] most; of equal ones the
        innermost."""
        i = bisect.bisect_left(self.starts, g1)
        best, name = 0.0, None
        for ev_name, s, e in self.spans[max(0, i - self.SCAN):i]:
            over = min(g1, e) - max(g0, s)
            if over > 0 and over >= best:
                best, name = over, ev_name
        return name


def summarize(device_events, host_events, window_s: float,
              program: Sequence[Span] = (),
              launches: Sequence[Optional[float]] = (), top: int = 10) -> dict:
    """`trace.summarize(device_events, host_events, window_s, top)`;
    given `program`, the program's spans (label, start_us, end_us) on
    the same clock, and `launches`, the time of each device event's
    runtime call (None where the profiler links none: its time goes to
    no span), it adds `span_device_s` and names the idle gaps by the
    program's spans."""
    out = trace.summarize(device_events, host_events, window_s, top)
    program = [s for s in program if s[0] not in WAIT_SPANS]
    if not program:
        return out
    spans = _Spans(program)
    by_span: Dict[str, float] = defaultdict(float)
    for (name, start, end), at in zip(device_events, launches):
        if name.startswith("nccl:"):
            continue
        label = (at is not None and spans.at(at)) or NO_SPAN
        by_span[label] += (end - start) * 1e-6
    harness = _Spans([h for h in host_events
                      if h[0].startswith(trace.SPAN_PREFIX)])
    ops = trace._Timeline([h for h in host_events
                           if not h[0].startswith(trace.SPAN_PREFIX)])
    busy = trace._union([(s, e) for n, s, e in device_events
                         if not n.startswith("nccl:")])
    gaps: Dict[str, float] = defaultdict(float)
    owners: Dict[str, float] = defaultdict(float)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        if start - end < trace.SHORT_GAP_US:
            name = f"gaps under {trace.SHORT_GAP_US:g} us"
        else:
            owner = (spans.most(end, start) or harness.most(end, start)
                     or NO_SPAN)
            owners[owner] += (start - end) * 1e-6
            name = f"{owner} / {ops.most(end, start) or 'no op'}"
        gaps[name] += (start - end) * 1e-6
    out["idle_gaps"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    out["span_device_s"] = _by_value(by_span)
    out["idle_by_span_s"] = _by_value(owners)
    return out


def _by_value(d: Dict[str, float]) -> Dict[str, float]:
    return dict(sorted(d.items(), key=lambda kv: -kv[1]))


def ring_spans() -> List[dict]:
    """The program's span records in this process's flight recorder
    (none where the recorder keeps no spans)."""
    from ray_tpu_torch._private import flight_recorder

    return [r for r in flight_recorder.snapshot(kinds=list(KINDS))
            if "start_ns" in r and "end_ns" in r]


def to_profiler_us(records: Sequence[dict], trace_start_ns: int) -> List[Span]:
    """Span records as (label, start_us, end_us) on the profiler's
    timeline (microseconds after `trace_start_ns`)."""
    return [(f"{r['kind']}.{r['name']}", (r["start_ns"] - trace_start_ns) / 1e3,
             (r["end_ns"] - trace_start_ns) / 1e3) for r in records]


def profiler_events(prof):
    """(device_events, host_events, launches) of a stopped
    `torch.profiler.profile`, the first two as `trace.Window.summary`
    takes them, `launches` the start of the runtime call linked to each
    device event (None where none is)."""
    from torch.autograd import DeviceType

    device, host, corr, runtime = [], [], [], {}
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.name.startswith((trace.SPAN_PREFIX, "ProfilerStep")))
        if e.device_type == DeviceType.CUDA:
            if not annotation:
                device.append(item)
                corr.append(e.id)
            continue
        if e.name.startswith("cu"):  # cudaLaunchKernel, cuLaunchKernelEx, ...
            runtime[e.id] = e.time_range.start
        if e.cpu_parent is None or annotation:
            host.append(item)
    return device, host, [runtime.get(c) for c in corr]


def window_summary(window, records: Sequence[dict]) -> dict:
    """`summarize` of a stopped `trace.Window` against `records`, the
    program's span records taken when it stopped."""
    device, host, launches = profiler_events(window.prof)
    start_ns = window.prof.profiler.kineto_results.trace_start_ns()
    lo = min((s for _, s, _ in device + host), default=0.0)
    hi = max((e for _, _, e in device + host), default=0.0)
    program = [s for s in to_profiler_us(records, start_ns)
               if s[2] >= lo and s[1] <= hi]
    out = summarize(device, host, window.window_s, program, launches)
    out["clock_checks"] = clock_checks(device, launches, program, out)
    return out


def clock_checks(device, launches, program: Sequence[Span], out: dict) -> dict:
    """How well the program's spans line up with the device trace: the
    share of kernels (not copies or fills) whose runtime call falls
    inside a `*.launch` span, the share of device time any program span
    owns, and the share of idle seconds, in gaps of at least
    `trace.SHORT_GAP_US`, named by no span."""
    launch = _Spans([s for s in program if s[0].endswith(".launch")])
    kernels = [at for (name, _, _), at in zip(device, launches)
               if trace.group_of(name) != "copy" and not name.startswith("nccl:")]
    inside = (sum(1 for at in kernels if at is not None and launch.at(at))
              if launch.spans else None)
    by_span = out.get("span_device_s", {})
    total = sum(by_span.values())
    owned = total - by_span.get(NO_SPAN, 0.0)
    idle_by = out.get("idle_by_span_s", {})
    idle = sum(idle_by.values())
    unnamed = idle_by.get(NO_SPAN, 0.0)
    return {"kernels": len(kernels),
            "kernels_launched_in_launch_spans": (
                inside / len(kernels) if kernels and inside is not None else None),
            "device_share_in_spans": owned / total if total else None,
            "idle_share_no_span": unnamed / idle if idle else None}
