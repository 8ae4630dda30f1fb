"""BENCHMARK.json keeps to its contract, every piece is found by name, and
a new configuration, mix, cell and metric need only new files and
entries."""

import json
import re
from pathlib import Path

import pytest

from gpubench import run, spec
from gpubench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"] + BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS - {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS - {"bound"} and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
        if m["name"].split(".")[0].endswith(("_roofline", "mfu")) or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    c = spec.cell(w["name"])
    assert c.mix["driver"] in ("train", "serve")
    assert (REPO / "gpubench" / "drivers" / f"{c.mix['driver']}.py").exists()
    assert c.limits and all(v > 0 for v in c.limits.values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported
        assert spec.reader(m["name"])({}) is None  # nothing to read: nothing
    config = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert config["file"].startswith("gpubench/")


def test_file_names_are_made_of_name_characters():
    for path in (REPO / "gpubench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_a_new_cell_needs_only_new_files(tiny_root: Path):
    """Add a configuration, a mix, a cell and a metric in a copy, editing
    no file the copy has: the harness finds them and reports the
    metric."""
    before = {p: p.read_bytes() for p in (tiny_root / "gpubench").rglob("*")
              if p.is_file() and p.suffix in (".py", ".json")}
    pkg = tiny_root / "gpubench"
    config = json.loads((pkg / "configs" / "tiny-mistral.json").read_text())
    config["num_hidden_layers"] = 1
    (pkg / "configs" / "tiny-one-layer.json").write_text(json.dumps(config))
    mix = json.loads((pkg / "mixes" / "tiny-train.json").read_text())
    mix["batch"] = 1
    (pkg / "mixes" / "tiny-train-b1.json").write_text(json.dumps(mix))
    (pkg / "limits" / "tiny-new.json").write_text(
        json.dumps({"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.05}))
    (pkg / "metrics" / "tokens_a_step.train.py").write_text(
        "def read(record):\n"
        "    return record['batch'] * record['seq'] if 'batch' in record else None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-one-layer", "source": "test",
                             "file": "gpubench/configs/tiny-one-layer.json",
                             "reduced": ["num_hidden_layers"], "why": "test"})
    bench["workloads"].append({"name": "tiny-new", "config": "tiny-one-layer",
                               "traffic": "tiny-train-b1", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "train_tokens_per_s" == m["name"]:
            m["workloads"].append("tiny-new")
    bench["per_layer"].append({"name": "tokens_a_step.train", "unit": "tokens",
                               "better": "higher", "source": "program_counter",
                               "layer": "train step", "moves": "train_tokens_per_s",
                               "workloads": ["tiny-new"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.cell("tiny-new", tiny_root)
    assert c.config["num_hidden_layers"] == 1 and c.mix["batch"] == 1
    assert [m["name"] for m in c.per_layer] == ["tokens_a_step.train"]
    result = run.run_cell(c, 11, 0.2, True, device="cpu", root=tiny_root)
    assert result["metrics"] == {"tokens_a_step.train": {"value": 64, "unit": "tokens"}}
    assert result["correct"] is True
    after = {p: p.read_bytes() for p in before}
    assert after == before
