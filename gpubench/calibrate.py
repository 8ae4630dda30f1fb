"""Readings that set a cell's limits and rate; not part of a run.

    python3 -m gpubench.calibrate --workload <name> --seeds <n>... \\
        [--control-seeds <n>...] [--seconds <s>] [--rates <r>...]

For every seed: the program's compared numbers against the reference,
through the cell's own driver (a training cell's checked steps with no
window; a serving cell's run with a window of `--seconds` at the mix's
rate). For each control seed besides: the reference in the precision
below the configuration's (fp8) put in the program's place, and, for a
training cell, the fault of a loss over half the batch planted in the
reference. With `--rates`, a serving cell's sweep instead: one run a
rate at the first seed, for the knee. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from . import run, spec
from .reference import compare


def _line(**kw) -> None:
    print(json.dumps(kw, default=str), flush=True)


def train(cell, seeds, control_seeds, device) -> None:
    from .drivers import train as driver

    for seed in seeds:
        out = driver.run(cell, seed, 0.0, False, time.perf_counter(), device)
        _line(kind="program", seed=seed, **out["numbers"],
              losses=out["program"]["losses"],
              reference_s=out["record"]["reference_s"])
        if seed not in control_seeds:
            continue
        steps = cell.mix["checked_steps"]
        for name, kw in (("fp8", {"precision": "fp8"}),
                         ("half_batch", {"drop_half": True})):
            stand_in = driver.reference(cell, seed, device, **kw)
            _line(kind=name, seed=seed,
                  **compare.train_numbers(stand_in, out["reference"], steps))


def serve(cell, seeds, control_seeds, seconds, device) -> None:
    from .drivers import serve as driver

    for seed in seeds:
        out = driver.run(cell, seed, seconds, False, time.perf_counter(),
                         device, controls=seed in control_seeds)
        _line(kind="program", seed=seed, **out["numbers"], **out["e2e"],
              failed=out["failed"], attempted=out["attempted"])


def sweep(cell, seed, seconds, rates, device) -> None:
    from .drivers import serve as driver

    for rate in rates:
        c = dataclasses.replace(cell, mix={**cell.mix, "rate_per_s": rate})
        out = driver.run(c, seed, seconds, False, time.perf_counter(), device)
        r = out["record"]
        _line(kind="sweep", rate=rate, **out["e2e"], failed=out["failed"],
              attempted=out["attempted"], ttft_quarters_ms=r["ttft_quarters_ms"],
              last_token_after_close_s=r["last_token_after_close_s"],
              decode=r["decode"], prefill=r["prefill"], prefix=r["prefix"],
              logit_gap=out["numbers"]["logit_gap"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    run.cache_dirs(spec.PACKAGE.parent)
    if cell.mix["driver"] == "train":
        train(cell, args.seeds, set(args.control_seeds), args.device)
    elif args.rates:
        sweep(cell, args.seeds[0], args.seconds, args.rates, args.device)
    else:
        serve(cell, args.seeds, set(args.control_seeds), args.seconds,
              args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
