"""Runs one cell once and prints its result:

    python3 -m gpubench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's mix names its driver (`drivers/<driver>.py`). With `--trace 0`
the result's metrics are the cell's end-to-end metrics; with `--trace 1`
its per-layer metrics, each read by `metrics/<name>.py` from the run's
record and profile. Every run compares what the timed path produced
with the plain reference and prints each compared number beside its
limit, as the last lines of standard error and as the last key of the
result, the last line of standard output.

It refuses to run without enough CUDA cards, and fails, printing no
result, if JAX or the JAX package is loaded in this process once the
window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import spec  # noqa: E402
from .reference import compare  # noqa: E402

#: Top-level modules that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port's nvcc
    builds already go to build/ray_tpu_torch)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root=None) -> dict:
    """The result line of one run of `cell` (the harness's look for the
    card is the caller's)."""
    driver = importlib.import_module(f"{__package__}.drivers.{cell.mix['driver']}")
    out = driver.run(cell, seed, seconds, trace, STARTED, device=device)
    checks = compare.checks(out["numbers"], cell.limits)
    correct = compare.within(checks) and out["failed"] == 0
    if trace:
        metrics = spec.read_per_layer(cell, out["record"], root)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {name: {"value": out["e2e"][name], "unit": units[name]}
                   for name in units}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(cell, out, device)}
    tr = out["record"].get("trace")
    if trace and tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                               "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    result["record"] = {k: v for k, v in out["record"].items() if k != "trace"}
    result["record"]["numbers"] = out["numbers"]
    if tr is not None:
        result["record"]["trace_groups_s"] = tr["groups_s"]
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result


def device_info(cell, out: dict, device: str) -> dict:
    import torch

    if device == "cuda":
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": cell.chips,
            "memory_peak_bytes": out["memory_peak_bytes"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gpubench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.cell(args.workload)
    cache_dirs(spec.PACKAGE.parent)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"gpubench: loaded in this run: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("gpubench record: " + json.dumps(result.pop("record"), default=str),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
