"""Finds a cell's pieces by name: `BENCHMARK.json` beside this package,
`configs/<config>.json`, `mixes/<traffic>.json`, `limits/<workload>.json`
and one reader a per-layer metric, `metrics/<metric>.py`. Adding a
configuration, a mix, a cell or a metric adds files and entries; no
code here or in the drivers names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config_name: str
    config: dict
    mix_name: str
    mix: dict
    limits: dict
    end_to_end: List[dict]   #: the BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    chips: int


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Optional[Path] = None) -> dict:
    root = Path(root) if root is not None else PACKAGE.parent
    return _json(root / "BENCHMARK.json")


def _reported(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list names the
    cell, or, without one, the cell reports the metric it moves (or,
    for an end-to-end metric, every cell does)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: Optional[Path] = None) -> Cell:
    root = Path(root) if root is not None else PACKAGE.parent
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"have {sorted(by_name)}")
    w = by_name[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    pkg = root / PACKAGE.name
    e2e = [m for m in bench["end_to_end"] if _reported(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(
        name=name, workload=w, config_name=w["config"],
        config=_json(root / config["file"]), mix_name=w["traffic"],
        mix=_json(pkg / "mixes" / f"{w['traffic']}.json"),
        limits=_json(pkg / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, chips=int(w["chips"]))


def reader(metric: str, root: Optional[Path] = None) -> Callable:
    """`read(record) -> float | None` of `metrics/<metric>.py`."""
    root = Path(root) if root is not None else PACKAGE.parent
    path = root / PACKAGE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE.name}_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_per_layer(c: Cell, record: dict, root: Optional[Path] = None
                   ) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds, with its
    unit; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in c.per_layer:
        value = reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
