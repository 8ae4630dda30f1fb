"""Runs one traced run of a cell and reads it against the program's
spans and the serving engine's span counters, which the harness's own
readers do not take yet:

    python3 -m gpubench.spanprobe --workload <name> --seed <n> --seconds <s>

Prints the `--trace 1` result line with the run's record and one key
more, "spans": the readings the spans give (the serve ones of
`SERVE_READINGS` and `optimizer_ms.train`), the serving
engine's counters over the window and its drain less the profiled slice,
the two sums that must agree with the step counters, each span's count,
total, median and largest ms over the whole run (`ring`), and the
profiled window's `spans.window_summary` (device seconds and idle gaps
by span, and how well the spans line up with the device trace).

It lays this over the harness in its own process only: the serving
driver's counters take the engine's span counters beside its own, and a
profiled window keeps the flight recorder's spans as it stops. The
drivers, readers and records of `python3 -m gpubench` are unchanged.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from contextlib import ExitStack
from unittest import mock

from . import run, spans, spec, trace
from .drivers import serve as serve_driver

#: `engine.stats()` counters of the engine's spans.
SERVE_KEYS = ("admitted", "queue_wait_ms", "prefill_chunks",
              "prefill_launch_ms", "prefill_wait_ms", "decode_launch_ms",
              "decode_wait_ms", "decode_emit_ms", "idle_ms")
#: Reading -> (numerator, denominator) of the serve counters.
SERVE_READINGS = {
    "queue_wait_ms.serve": ("queue_wait_ms", "admitted"),
    "prefill_launch_ms.serve": ("prefill_launch_ms", "prefill_chunks"),
    "decode_launch_ms.serve": ("decode_launch_ms", "decode_steps"),
    "decode_emit_ms.serve": ("decode_emit_ms", "decode_steps"),
}
#: Spans kept for a window: a serve run's slice is read after its
#: drain, a minute of spans later.
RING_CAPACITY = 1 << 17


def serve_readings(counted: dict) -> dict:
    out = {}
    for name, (num, den) in SERVE_READINGS.items():
        if counted.get(den) and num in counted:
            out[name] = counted[num] / counted[den]
    if "decode_launch_ms" in counted and counted["decode_ms"]:
        out["decode_launch_and_wait_over_step_ms"] = (
            counted["decode_launch_ms"] + counted["decode_wait_ms"]
        ) / counted["decode_ms"]
    if "prefill_launch_ms" in counted and counted["prefill_ms"]:
        out["prefill_launch_and_wait_over_prefill_ms"] = (
            counted["prefill_launch_ms"] + counted["prefill_wait_ms"]
        ) / counted["prefill_ms"]
    return out


def span_stats(records) -> dict:
    """{kind.name: count, total, median and largest ms} of span records."""
    by = {}
    for r in records:
        by.setdefault(f"{r['kind']}.{r['name']}", []).append(
            (r["end_ns"] - r["start_ns"]) * 1e-6)
    return {name: {"count": len(ms), "total_ms": sum(ms),
                   "median_ms": statistics.median(ms), "max_ms": max(ms)}
            for name, ms in sorted(by.items())}


def probe(cell: spec.Cell, seed: int, seconds: float, device: str = "cuda",
          root=None) -> dict:
    """`run.run_cell(..., trace=True)` with the readings of the spans
    under the result's "spans"."""
    windows, counted = [], {}
    base_counters = serve_driver._counters
    base_window = serve_driver._window
    base_stop, base_summary = trace.Window.stop, trace.Window.summary

    def counters(stats):
        out = base_counters(stats)
        out.update({k: stats[k] for k in SERVE_KEYS if k in stats})
        return out

    def window(*args, **kwargs):
        w = base_window(*args, **kwargs)
        counted.update(w["counted"])
        return w

    def stop(self, sync=True):
        base_stop(self, sync)
        self.ring = spans.ring_spans()

    def summary(self):
        out = base_summary(self)
        windows.append(spans.window_summary(self, self.ring))
        return out

    from ray_tpu_torch._private import flight_recorder

    ring = flight_recorder.recorder()
    if ring._ring.maxlen < RING_CAPACITY:
        ring.resize(RING_CAPACITY)
    with ExitStack() as stack:
        for target, name, new in (
                (serve_driver, "_counters", counters),
                (serve_driver, "_window", window),
                (trace.Window, "stop", stop),
                (trace.Window, "summary", summary)):
            stack.enter_context(mock.patch.object(target, name, new))
        result = run.run_cell(cell, seed, seconds, True, device=device,
                              root=root)
    readings = serve_readings(counted)
    profiled = windows[-1] if windows else None
    steps = result["record"].get("profile_steps")
    if profiled and steps and "span_device_s" in profiled:
        optimizer_s = profiled["span_device_s"].get("train.optimizer")
        if optimizer_s is not None:
            readings["optimizer_ms.train"] = 1e3 * optimizer_s / steps
    result["spans"] = {"readings": readings,
                       "counted": counted or None,
                       "ring": span_stats(spans.ring_spans()),
                       "window": profiled}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gpubench.spanprobe")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    cell = spec.cell(args.workload)
    run.cache_dirs(spec.PACKAGE.parent)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench.spanprobe: {args.workload} needs {cell.chips} CUDA "
              "card(s)", file=sys.stderr)
        return 2
    result = probe(cell, args.seed, args.seconds)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
