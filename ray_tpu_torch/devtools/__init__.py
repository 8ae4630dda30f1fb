"""Developer tooling of the port: static analysis for distributed
correctness, and the lock witness the runtime imports at start.

Four layers, one suppression/output contract (`# rt: noqa[RTxxx]`,
`--json`, exit 0/1/2), each a `python -m` entry point:

* `python -m ray_tpu_torch.devtools.lint [paths]` — per-file,
  syntactic (rules RT001-RT010 in devtools/rules.py; engine in
  devtools/lint.py; both copied from `ray_tpu/devtools/`).
* `python -m ray_tpu_torch.devtools.check [paths]` — whole-program,
  two-phase (symbol table in devtools/contracts.py; rules RT101-RT106
  in devtools/check.py; copied): `.remote()` arity vs decorated
  signatures, `.options()` keys vs the port's option universe
  (`_private/options.py`), RPC call sites vs registered handlers and
  the port's `wire.SCHEMAS`.
* `python -m ray_tpu_torch.devtools.concurrency [paths]` — the race
  pass (rules RT201-RT206; copied): execution contexts x shared
  attributes x lock discipline. Its runtime counterpart is
  devtools/lock_witness.py (copied).
* `python -m ray_tpu_torch.devtools.accel [paths]` — accelerator
  hot-path analysis for PyTorch code (devtools/accel.py, rules
  RT301-RT306, written for the port): programs the compile watch
  cannot name, len()-bounded shape drift into a registered program,
  host syncs in hot loops, state read after an in-place step,
  launch-only timing. Its runtime counterpart is
  `_private/compile_watch.py`, and `accel.build_inventory()` is the
  bridge: a live recompile storm resolves its program name to the
  static site (`compile_watch.static_hint`).

Every pass also audits the suppressions it owns (RT090/RT190/RT290/
RT390): a `# rt: noqa[RTxxx]` naming a nonexistent rule, or
suppressing one that never fires on that line, is itself a finding.

Programmatic:

    from ray_tpu_torch.devtools import (
        lint_paths, check_paths, race_paths, accel_paths,
    )
    findings = (
        lint_paths(["ray_tpu_torch"])
        + check_paths(["ray_tpu_torch"])
        + race_paths(["ray_tpu_torch"])
        + accel_paths(["ray_tpu_torch"])
    )

The repo holds the port to all four in tests/test_torch_devtools.py.
The names above load at first use (PEP 562): the runtime imports the
lock witness at start, and must not pay for the passes (about 75 ms).
"""

_EXPORTS = {
    "accel_paths": ".accel", "accel_sources": ".accel",
    "build_inventory": ".accel",
    "check_paths": ".check", "check_sources": ".check",
    "race_paths": ".concurrency", "race_sources": ".concurrency",
    "Finding": ".lint", "lint_paths": ".lint", "lint_source": ".lint",
    "main": ".lint", "ALL_RULES": ".rules",
}
_MAINS = {"accel_main": ".accel", "check_main": ".check",
          "race_main": ".concurrency"}

__all__ = sorted([*_EXPORTS, *_MAINS, "all_main"])


def all_main(argv=None, out=None) -> int:
    """`python -m ray_tpu_torch devtools all [paths] [--json]` — lint +
    check + race + accel over the same tree with merged findings: the
    single CI gate, as the JAX package's `devtools.all_main`. Shares
    the passes' default path (this package), validation, rendering
    and exit codes (0 clean, 1 findings, 2 usage errors)."""
    import argparse
    import json
    import os
    import sys
    from dataclasses import asdict

    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="ray_tpu_torch devtools all",
        description=("lint + check + race + accel with merged findings "
                     "(single CI gate)"),
    )
    parser.add_argument(
        "paths", nargs="*", help="files/dirs (default: ray_tpu_torch)")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit merged findings as JSON (CI mode)")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    paths = args.paths or [
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"devtools: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    findings = []
    for name in ("lint_paths", "check_paths", "race_paths", "accel_paths"):
        findings += __getattr__(name)(paths)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if args.as_json:
        print(json.dumps([asdict(f) for f in findings], indent=2),
              file=out)
    else:
        for finding in findings:
            print(finding.render(), file=out)
        if findings:
            print(f"{len(findings)} finding(s)", file=out)
    return 1 if findings else 0


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name], __name__),
                       name)
    if name in _MAINS:
        return importlib.import_module(_MAINS[name], __name__).main
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
