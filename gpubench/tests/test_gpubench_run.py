"""Whole runs at a test's width on the CPU: the result line, the refusal
without a card, and the timed path broken underneath coming out not
correct (the look for a card is skipped: `run_cell` is what `main` calls
once it has found one)."""

import json

import pytest
import torch

from gpubench import run, spec
from gpubench.drivers import train as train_driver
from gpubench.reference import compare

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def cell(root, name):
    return spec.cell(name, root)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "mistral-7b-train-4k", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


@pytest.mark.parametrize("name,trace", [("tiny-train", False),
                                        ("tiny-serve", False),
                                        ("tiny-serve", True)])
def test_result_line(tiny_root, name, trace):
    c = cell(tiny_root, name)
    result = run.run_cell(c, 2**33 + 3, 1.0, trace, device="cpu", root=tiny_root)
    result.pop("record")
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert set(result) <= set(KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == set(c.limits)
    wanted = ({m["name"] for m in c.per_layer} if trace
              else {m["name"] for m in c.end_to_end})
    assert set(result["metrics"]) <= wanted
    if not trace:
        assert set(result["metrics"]) == wanted
    json.dumps(result)


def _unchanged(monkeypatch):
    from ray_tpu_torch.train import train_step

    def apply(self, params, grads, state, grad_norm):
        state["count"] += 1

    monkeypatch.setattr(train_step.AdamW, "apply", apply)


def _half_batch(monkeypatch):
    from ray_tpu_torch.models import llama

    full = llama.loss_fn

    def loss_fn(model, tokens, targets, **kw):
        targets = targets.clone()
        targets[targets.shape[0] // 2:] = -1
        return full(model, tokens, targets, **kw)

    monkeypatch.setattr(llama, "loss_fn", loss_fn)


def _altered_token(monkeypatch):
    from ray_tpu_torch.models import generate

    sample, calls = generate._sample, [0]

    def altered(logits, *args, **kw):
        calls[0] += 1
        tok = sample(logits, *args, **kw)
        return (tok + 1) % logits.shape[-1] if calls[0] % 5 == 0 else tok

    monkeypatch.setattr(generate, "_sample", altered)


@pytest.mark.parametrize("name,fault", [("tiny-train", _unchanged),
                                        ("tiny-train", _half_batch),
                                        ("tiny-serve", _altered_token)],
                         ids=["state unchanged", "half the batch", "token altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, name, fault):
    fault(monkeypatch)
    result = run.run_cell(cell(tiny_root, name), 2**32 + 17, 1.0, False,
                          device="cpu", root=tiny_root)
    assert result["correct"] is False, result["checks"]


def test_the_control_reads_above_the_program(tiny_root):
    """The reference in fp8, put in the program's place, against the f32
    reference: at a test's width it reads above the program on every
    number (the chip's readings at the cells' sizes set the limits)."""
    c = cell(tiny_root, "tiny-train")
    out = train_driver.run(c, 5, 0.0, False, 0.0, device="cpu")
    control = train_driver.reference(c, 5, "cpu", precision="fp8")
    fp8 = compare.train_numbers(control, out["reference"], c.mix["checked_steps"])
    for key in ("loss_gap", "grad_gap", "change_gap"):
        assert fp8[key] > out["numbers"][key], (key, fp8, out["numbers"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mistral-7b-train-4k", "qwen3-8b-serve-chat"])
def test_the_control_fails_the_limits_on_the_card(workload):
    """On the card, at the cell's own size: the reference in fp8 put in
    the program's place breaks at least one of the cell's limits, and the
    program on the same seed keeps to all of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gpubench.drivers import serve as serve_driver

    c = spec.cell(workload)
    seed = 2**31 + 77
    if c.mix["driver"] == "train":
        out = train_driver.run(c, seed, 0.0, False, 0.0)
        control = compare.train_numbers(
            train_driver.reference(c, seed, "cuda", precision="fp8"),
            out["reference"], c.mix["checked_steps"])
    else:
        out = serve_driver.run(c, seed, 20.0, False, 0.0, controls=True)
        control = {"logit_gap": out["numbers"]["fp8_gap"]}
    assert compare.within(compare.checks(out["numbers"], c.limits))
    assert not compare.within(compare.checks(control, c.limits)), control


def test_serve_pool_holds_what_the_traffic_reaches(tiny_root):
    """The KV pool is every slot at full length plus the cached system
    prefixes, and the window's fill of it is read and recorded."""
    from gpubench.drivers import serve as serve_driver

    c = cell(tiny_root, "tiny-serve")
    rec = run.run_cell(c, 7, 2.0, False, device="cpu", root=tiny_root)["record"]
    e = c.mix["engine"]
    slots_blocks = e["slots"] * (e["max_len"] // e["kv_block_len"])
    assert rec["kv_blocks"] == serve_driver.pool_blocks(c.mix) - 1 > slots_blocks
    peak = rec["pool_peak"]
    assert peak["reads"] > 0
    assert 0 < peak["kv_blocks_used"] <= peak["kv_blocks_used_or_cached"] <= rec["kv_blocks"]
    assert 0 < peak["slots_used"] <= e["slots"]
    assert rec["compiles"]["before"] == rec["compiles"]["after"]
