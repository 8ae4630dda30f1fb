"""A tiny copy of the benchmark for CPU tests: the package beside a
BENCHMARK.json that adds two cells at a small width (the shapes of the
real configurations, scaled down), with their own mixes and limits."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16)


def make_tiny(root: Path) -> Path:
    pkg = root / "gpubench"
    shutil.copytree(REPO / "gpubench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())

    def derived(src, dst, **kw):
        data = json.loads((pkg / src).read_text())
        for key, value in kw.items():
            if isinstance(value, dict) and isinstance(data.get(key), dict):
                data[key].update(value)
            else:
                data[key] = value
        (pkg / dst).write_text(json.dumps(data))

    derived("configs/mistral-7b-v0.3.json", "configs/tiny-mistral.json", **SMALL)
    derived("configs/qwen3-8b.json", "configs/tiny-qwen3.json", **SMALL)
    derived("mixes/train-4k.json", "mixes/tiny-train.json", seq=64)
    derived("mixes/serve-chat.json", "mixes/tiny-serve.json",
            engine={"slots": 4, "max_len": 256, "prefill_chunk": 32},
            rate_per_s=4.0, prefixes={"tokens": 32, "shares": [0.6, 0.4]},
            user_tokens={"median": 40, "sigma": 0.5, "min": 8, "max": 96},
            output_tokens={"median": 12, "sigma": 0.5, "min": 4, "max": 24},
            warmup={"user_tokens": 8, "output_tokens": 2},
            check_requests=4)
    (pkg / "limits" / "tiny-train.json").write_text(json.dumps(
        {"loss_gap": 0.01, "grad_gap": 0.05, "change_gap": 0.05}))
    (pkg / "limits" / "tiny-serve.json").write_text(json.dumps(
        {"logit_gap": 0.2}))
    for name, config in (("tiny-mistral", "configs/tiny-mistral.json"),
                         ("tiny-qwen3", "configs/tiny-qwen3.json")):
        bench["configs"].append({"name": name, "source": "a test's width",
                                 "file": f"gpubench/{config}", "reduced": [],
                                 "why": "CPU tests"})
    bench["workloads"] += [
        {"name": "tiny-train", "config": "tiny-mistral", "traffic": "tiny-train",
         "chips": 1, "why": "CPU tests"},
        {"name": "tiny-serve", "config": "tiny-qwen3", "traffic": "tiny-serve",
         "chips": 1, "why": "CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads", [])
        if any("train" in c for c in cells):
            cells.append("tiny-train")
        if any("serve" in c for c in cells):
            cells.append("tiny-serve")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(tmp_path)
