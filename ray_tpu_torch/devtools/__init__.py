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

__all__ = sorted([*_EXPORTS, *_MAINS])


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name], __name__),
                       name)
    if name in _MAINS:
        return importlib.import_module(_MAINS[name], __name__).main
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
