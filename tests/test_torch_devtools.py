"""The port's static gates on the CPU (`ray_tpu_torch/devtools/`).

`lint`, `check` and `race` are copies of the JAX package's passes: each
of their rules fires on the JAX package's own fixtures
(`tests/test_lint.py`, `tests/test_check.py`,
`tests/test_concurrency_analysis.py`) and stays quiet on their twins,
through both packages' passes, the fixtures' module names rewritten
for the port's. `accel` is written for the port (PyTorch hot paths):
each of its rules has a firing and a silent snippet here. All four run
clean over `ray_tpu_torch/`; its inventory feeds the compile watch's
`static_hint`; and `train.telemetry` re-exports the step-telemetry
surface as the JAX package's does."""

import ast
import io
import json
import os
import re
import textwrap

import pytest
import torch

import test_check
import test_concurrency_analysis
import test_lint
from ray_tpu.devtools import check as jax_check
from ray_tpu.devtools import concurrency as jax_race
from ray_tpu.devtools import lint as jax_lint
from ray_tpu_torch._private import compile_watch as cw
from ray_tpu_torch.devtools import accel, check, concurrency, lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ray_tpu_torch")

_MODULE = re.compile(r"\bray_tpu\b(?!_torch)")


def _as_port(text: str) -> str:
    """A fixture as the port reads it: module names rewritten as the
    copies' are (`tests/_torch_fork.py`)."""
    return _MODULE.sub("ray_tpu_torch", text)


PACKAGES = {
    "jax": (jax_lint, jax_check, jax_race, lambda text: text),
    "port": (lint, check, concurrency, _as_port),
}
packages = pytest.mark.parametrize("package", sorted(PACKAGES))


# ---------------------------------------------------------------------------
# the four gates over the port
# ---------------------------------------------------------------------------

GATES = {"lint": lint.main, "check": check.main, "race": concurrency.main,
         "accel": accel.main}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_exits_clean_over_the_port(gate):
    out = io.StringIO()
    assert GATES[gate]([PKG], out=out) == 0, out.getvalue()


# ---------------------------------------------------------------------------
# the copied passes: the JAX package's fixtures through both packages
# ---------------------------------------------------------------------------


def _ids(cases, rule_at, expect_at):
    return [f"{c[rule_at]}-{'fires' if c[expect_at] else 'quiet'}-{i}"
            for i, c in enumerate(cases)]


@packages
@pytest.mark.parametrize("rule,path,source,expect", test_lint.CASES,
                         ids=_ids(test_lint.CASES, 0, 3))
def test_lint_rule_fixtures(package, rule, path, source, expect):
    passes, rewrite = PACKAGES[package][0], PACKAGES[package][3]
    rules = {f.rule for f in passes.lint_source(
        textwrap.dedent(rewrite(source)), rewrite(path))}
    assert (rule in rules) == expect, rules


@packages
@pytest.mark.parametrize("rule,files,expect", test_check.CASES,
                         ids=_ids(test_check.CASES, 0, 2))
def test_check_rule_fixtures(package, rule, files, expect):
    passes, rewrite = PACKAGES[package][1], PACKAGES[package][3]
    sources = [(rewrite(path), textwrap.dedent(rewrite(source)))
               for path, source in files.items()]
    rules = {f.rule for f in passes.check_sources(sources)}
    assert (rule in rules) == expect, rules


@packages
@pytest.mark.parametrize("rule,source,expect",
                         test_concurrency_analysis.CASES,
                         ids=_ids(test_concurrency_analysis.CASES, 0, 2))
def test_race_rule_fixtures(package, rule, source, expect):
    passes, rewrite = PACKAGES[package][2], PACKAGES[package][3]
    rules = {f.rule for f in passes.race_sources(
        [("mod.py", textwrap.dedent(rewrite(source)))])}
    assert (rule in rules) == expect, rules


@packages
@pytest.mark.parametrize("hygiene", ["RT090", "RT190", "RT290"])
def test_stale_suppressions_are_findings(package, hygiene):
    """Each copied pass audits the suppressions of its own family."""
    passes = PACKAGES[package]
    source = {
        "RT090": "x = 1  # rt: noqa[RT001]\n",
        "RT190": "x = 1  # rt: noqa[RT101]\n",
        "RT290": "x = 1  # rt: noqa[RT201]\n",
    }[hygiene]
    if hygiene == "RT090":
        rules = {f.rule for f in passes[0].lint_source(source, "mod.py")}
    elif hygiene == "RT190":
        rules = {f.rule for f in passes[1].check_sources([("mod.py", source)])}
    else:
        rules = {f.rule for f in passes[2].race_sources([("mod.py", source)])}
    assert hygiene in rules


def test_copied_rules_are_the_jax_packages():
    from ray_tpu.devtools.rules import ALL_RULES as JAX_RULES
    from ray_tpu_torch.devtools.rules import ALL_RULES

    assert [r.id for r in ALL_RULES] == [r.id for r in JAX_RULES]
    assert concurrency.RULES == jax_race.RULES


# ---------------------------------------------------------------------------
# accel: the torch pass, one firing and one silent snippet per rule
# ---------------------------------------------------------------------------

HEAD = """
import time

import torch

from ray_tpu_torch._private import compile_watch
from ray_tpu_torch.train import make_train_step


def _impl(x):
    return x * 2


_step = compile_watch.instrument("train.step", _impl)
"""

ACCEL_CASES = [
    # (rule, source after HEAD, expect_fire)
    ("RT301", """
    def run(xs):
        for x in xs:
            prog = compile_watch.instrument("p", _impl)
            prog(x)
    """, True),
    ("RT301", """
    def serve(x):
        fast = torch.compile(_impl)
        return fast(x)
    """, True),
    ("RT301", """
    def replay(xs):
        for x in xs:
            graph = torch.cuda.CUDAGraph()
    """, True),
    ("RT301", """
    class Engine:
        def __init__(self):
            self._prog = compile_watch.instrument("p", _impl)

        def step(self, x):
            return self._prog(x)

    def make_program():
        return compile_watch.instrument("q", _impl)
    """, False),
    ("RT302", """
    def drift(tokens, rows):
        for row in rows:
            _step(tokens[:, :len(row)])
    """, True),
    ("RT302", """
    def bucketed(tokens, rows, bucket=64):
        for row in rows:
            _step(tokens[:, :bucket])
    """, False),
    ("RT303", """
    def loop(batches):
        losses = []
        for batch in batches:
            loss = _step(batch)
            losses.append(loss.item())
        return losses
    """, True),
    ("RT303", """
    def loop(batches):
        for batch in batches:
            out = _step(batch)
            torch.cuda.synchronize()
        return out
    """, True),
    ("RT303", """
    def loop(batches):
        for batch in batches:
            loss = _step(batch)
            if float(loss) > 10:
                break
    """, True),
    ("RT303", """
    def loop(batches):
        total = 0
        for batch in batches:
            total = total + _step(batch)
        return total.item()
    """, False),
    ("RT304", """
    def train(model, tokens, targets, loss_fn, opt):
        init_fn, step_fn = make_train_step(loss_fn, opt)
        state = init_fn(model)
        new_state, metrics = step_fn(state, tokens, targets)
        return state.step
    """, True),
    ("RT304", """
    def train(model, tokens, targets, loss_fn, opt):
        init_fn, step_fn = make_train_step(loss_fn, opt)
        state = init_fn(model)
        state, metrics = step_fn(state, tokens, targets)
        kept_fn, copy_fn = make_train_step(loss_fn, opt, donate=False)
        new_state, _ = copy_fn(state, tokens, targets)
        return state.step, new_state.step
    """, False),
    ("RT305", """
    def bench(x):
        t0 = time.perf_counter()
        out = _step(x)
        return time.perf_counter() - t0
    """, True),
    ("RT305", """
    def bench(x):
        t0 = time.perf_counter()
        out = _step(x)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    """, False),
    ("RT306", """
    fast = torch.compile(_impl)
    """, True),
    ("RT306", """
    def make_step(model):
        def step_fn(x):
            return model(x)
        return step_fn
    """, True),
    ("RT306", """
    fast = compile_watch.instrument("fast", torch.compile(_impl))

    def make_step(model):
        def step_fn(x):
            return model(x)
        step_fn = compile_watch.instrument("step", step_fn)
        return step_fn
    """, False),
    ("RT390", """
    x = 1  # rt: noqa[RT303]
    """, True),
    ("RT390", """
    def loop(batches):
        for batch in batches:
            loss = _step(batch)
            print(loss.item())  # rt: noqa[RT303] — the log line is the product
    """, False),
]


def _accel_rules(body: str, path: str = "ray_tpu_torch/train/loop.py"):
    source = HEAD + textwrap.dedent(body)
    return {f.rule for f in accel.accel_sources([(path, source)])}


@pytest.mark.parametrize("rule,body,expect", ACCEL_CASES,
                         ids=_ids(ACCEL_CASES, 0, 2))
def test_accel_rule_fixtures(rule, body, expect):
    rules = _accel_rules(body)
    assert (rule in rules) == expect, rules


def test_accel_keeps_host_rules_out_of_test_files():
    """As in the JAX pass: RT303/RT305/RT306 stay out of test files,
    RT301/RT302 apply everywhere."""
    body = ACCEL_CASES[6][1] + ACCEL_CASES[14][1] + ACCEL_CASES[4][1]
    rules = _accel_rules(body, "tests/test_loop.py")
    assert "RT302" in rules
    assert not rules & {"RT303", "RT305", "RT306"}


def test_accel_cli_contract(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(HEAD + textwrap.dedent(ACCEL_CASES[14][1]))
    good = tmp_path / "good.py"
    good.write_text(HEAD)
    out = io.StringIO()
    assert accel.main([str(good)], out=out) == 0
    assert accel.main([str(bad)], out=out) == 1
    out = io.StringIO()
    assert accel.main([str(bad), "--json"], out=out) == 1
    assert [f["rule"] for f in json.loads(out.getvalue())] == ["RT306"]
    assert accel.main([str(bad), "--rules", "RT301"], out=io.StringIO()) == 0
    assert accel.main([str(bad), "--rules", "RT999"], out=io.StringIO()) == 2
    assert accel.main([str(tmp_path / "missing.py")],
                      out=io.StringIO()) == 2
    out = io.StringIO()
    assert accel.main(["--list-rules"], out=out) == 0
    assert set(re.findall(r"RT3\d\d", out.getvalue())) == set(accel.RULES)
    out = io.StringIO()
    assert accel.main([str(bad), "--inventory"], out=out) == 0
    inventory = json.loads(out.getvalue())
    assert inventory["unregistered"][0]["target"] == "_impl"


def test_accel_inventory_names_patterns_and_hazards():
    source = HEAD + textwrap.dedent("""
    class Stage:
        def __init__(self, stage):
            self.stage = stage
            self._fwd = compile_watch.instrument(f"mpmd.s{stage}.fwd", _impl)

        def run(self, tokens, rows):
            for row in rows:
                self._fwd(tokens[: len(row)])
    """)
    inv = accel.build_inventory_sources([("mod.py", source)])
    by_name = {p["program"]: p for p in inv["programs"]}
    assert by_name["train.step"]["name_kind"] == "literal"
    assert by_name["train.step"]["hazards"] == []
    stage = by_name["mpmd.s*.fwd"]
    assert stage["name_kind"] == "pattern"
    assert [h["rule"] for h in stage["hazards"]] == ["RT302"]
    assert inv["unregistered"] == []


# ---------------------------------------------------------------------------
# the bridge: a live storm resolves to its wrap site
# ---------------------------------------------------------------------------


def test_static_hint_resolves_a_live_storm_to_its_wrap_site(monkeypatch):
    """A prefill whose sequence length drifts is a storm on
    `generate.prefill`; the port's inventory (scanned in process when
    no file is given) names the line that registers it."""
    from ray_tpu_torch.models import generate as gen
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=32, dim=16, n_layers=1, n_heads=2,
                            n_kv_heads=2, intermediate=32, max_seq_len=64,
                            dtype=torch.float32, attention="reference",
                            remat=False)
    model = llama.Llama(cfg, device="cpu")
    monkeypatch.setattr(cw, "_inventory", None)
    cw.reset()
    try:
        with torch.no_grad():
            for t in range(2, 12):
                gen.prefill(model, cfg, torch.ones(1, t, dtype=torch.long),
                            gen.init_kv_cache(cfg, 1, 16, device="cpu"), 0, t)
        storms = cw.detect_storms(cw.snapshot(), 8)
        assert [s["program"] for s in storms] == ["generate.prefill"]
        assert "dim 1" in storms[0]["delta"]
        cw.load_inventory(refresh=True)
        hint = cw.static_hint("generate.prefill")
        line = next(
            i for i, text in enumerate(
                open(gen.__file__).read().splitlines(), 1)
            if '"generate.prefill"' in text)
        assert f"ray_tpu_torch/models/generate.py:{line}" in hint
        assert "python -m ray_tpu_torch.devtools.accel" in hint
        # Engine families resolve through their pattern.
        assert "llm/engine.py" in cw.static_hint("engine.paged_prefill[tiny]")
    finally:
        cw.reset()
        # The storm's records were queued for a head: drop them.
        from ray_tpu_torch.util import metrics

        metrics._Buffer.reset()


def test_static_hint_carries_an_rt302_hazard(tmp_path, monkeypatch):
    source = HEAD + textwrap.dedent(ACCEL_CASES[4][1])
    inv = accel.build_inventory_sources([("loop.py", source)])
    path = tmp_path / "inventory.json"
    path.write_text(json.dumps(inv))
    monkeypatch.setattr(cw, "_inventory", None)
    cw.load_inventory(str(path), refresh=True)
    hint = cw.static_hint("train.step")
    assert "RT302" in hint and "loop.py" in hint
    assert cw.static_hint("no.such.program") is None


# ---------------------------------------------------------------------------
# train.telemetry
# ---------------------------------------------------------------------------


def test_train_telemetry_reexports_step_telemetry():
    from ray_tpu_torch import exceptions, train
    from ray_tpu_torch._private import step_telemetry

    telemetry = train.telemetry
    source = open(os.path.join(REPO, "ray_tpu", "train",
                               "telemetry.py")).read()
    jax_all = next(
        ast.literal_eval(node.value) for node in ast.parse(source).body
        if isinstance(node, ast.Assign)
        and getattr(node.targets[0], "id", "") == "__all__")
    assert telemetry.__all__ == jax_all
    for name in ("add_phase", "take_phases", "phase_timer", "timed_iter",
                 "report_step", "steps_to_chrome_trace"):
        assert getattr(telemetry, name) is getattr(step_telemetry, name)
    assert "telemetry" in train.__all__
    with pytest.raises(exceptions.RayTpuError, match="ray_tpu_torch.init"):
        telemetry.step_summary()
