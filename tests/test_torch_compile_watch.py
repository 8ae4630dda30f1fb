"""The port's compile watch (`ray_tpu_torch/_private/compile_watch.py`)
on the CPU, mirroring `tests/test_compile_watch.py` where the cases
apply, and held to the JAX package's watch on the same calls.

What counts as a compile in the port: an nvcc build (reported by
`ops/_build.build` through `compile_watch.report_build`) and a dynamo
compile. A new signature of an instrumented program records one compile
whatever ran, so `compiles` and `distinct_shapes` count what the JAX
package counts, and `compile_ms` is billed only for compile work. Every
test resets the port's registry after itself."""

import os
import stat
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import compile_watch as jax_cw
from ray_tpu._private import step_telemetry as jax_step_telemetry
from ray_tpu.models import generate as jax_gen
from ray_tpu.models import llama as jax_llama
from ray_tpu_torch._private import compile_watch as cw
from ray_tpu_torch._private import step_telemetry
from ray_tpu_torch.models import generate as gen
from ray_tpu_torch.models import llama

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)


def _drop_buffered_records():
    """The compile records queued for a head that was never started: a
    later `init` in this process would ship them to its head."""
    from ray_tpu_torch.util import metrics

    metrics._Buffer.reset()


@pytest.fixture(autouse=True)
def _fresh_registry():
    """Each test starts and ends with an empty registry, no billed
    phases and no queued compile records, in both packages, so nothing
    leaks into a later test."""
    cw.reset()
    step_telemetry.take_phases()
    yield
    cw.reset()
    step_telemetry.take_phases()
    _drop_buffered_records()
    jax_cw.reset()
    jax_step_telemetry.take_phases()


def _watch_both_packages(monkeypatch):
    """The parity tests run the JAX package's watch too (the module
    fixture switches it off)."""
    monkeypatch.setattr(jax_cw, "_enabled", True)
    monkeypatch.setattr(cw, "_enabled", True)


# ---------------------------------------------------------------------------
# digests and shape deltas
# ---------------------------------------------------------------------------


def test_arg_digest_keys_on_shape_dtype_and_device():
    a32 = torch.zeros(4, 8)
    b32 = torch.ones(4, 8)  # same shape/dtype/device, other values
    wide = torch.zeros(4, 16)
    a16 = torch.zeros(4, 8, dtype=torch.float16)
    meta = torch.zeros(4, 8, device="meta")
    assert cw.arg_digest((a32,), {}) == cw.arg_digest((b32,), {})
    assert cw.arg_digest((a32,), {}) != cw.arg_digest((wide,), {})
    assert cw.arg_digest((a32,), {}) != cw.arg_digest((a16,), {})
    assert cw.arg_digest((a32,), {}) != cw.arg_digest((meta,), {})
    # numpy arrays key the same way; parameters like tensors.
    assert cw.arg_digest((np.zeros((4, 8), np.float32),), {}) != \
        cw.arg_digest((np.zeros((4, 9), np.float32),), {})
    assert cw.arg_digest((torch.nn.Parameter(a32),), {}) == \
        cw.arg_digest((a32,), {})
    # Python scalars digest by TYPE, not value; strings by value.
    assert cw.arg_digest((a32, 1), {}) == cw.arg_digest((a32, 2), {})
    assert cw.arg_digest((a32, 1), {}) != cw.arg_digest((a32, 1.0), {})
    assert cw.arg_digest((a32, "mean"), {}) != cw.arg_digest(
        (a32, "sum"), {})
    # A module counts by its type, not its weights.
    assert cw.arg_digest((torch.nn.Linear(2, 3),), {}) == cw.arg_digest(
        (torch.nn.Linear(5, 7),), {})
    # Containers recurse, dicts in key order.
    assert cw.arg_digest(({"b": a32, "a": wide},), {}) == cw.arg_digest(
        ({"a": wide, "b": b32},), {})
    key = cw.digest_key(cw.arg_digest((a32,), {}))
    assert key == cw.digest_key(cw.arg_digest((b32,), {}))
    assert len(key) == 12
    assert cw.digest_leaves(cw.arg_digest((a32, [a16]), {})) == [
        ("float32", (4, 8), "cpu"), ("float16", (4, 8), "cpu")]


def test_arg_digest_does_not_depend_on_what_a_dict_held_before():
    """The walk trusts a dict's keys to hold only tensors once it saw
    them so; a dict with those keys that holds something else now
    digests as a fresh walk does, and its array leaves keep call
    order."""
    a32, a16 = torch.zeros(4, 8), torch.zeros(2, dtype=torch.float16)
    tree = {"w": a32, "b": a32}

    def fresh(*args):
        cw._dict_plans.clear()
        return cw.arg_digest(args, {})

    first = cw.arg_digest((tree,), {})
    assert first == fresh(tree)
    tree["b"] = {"inner": a16}
    assert cw.arg_digest((tree,), {}) == fresh(tree) != first
    tree["b"] = 3
    assert cw.arg_digest((tree,), {}) == fresh(tree)
    tree["b"] = a16
    assert cw.arg_digest((tree,), {}) == fresh(tree)
    assert cw.digest_leaves(cw.arg_digest(
        (a16, {"z": [a32, 1, np.zeros(3, np.int8)], "a": a16}), {"k": a32},
    )) == [("float16", (2,), "cpu"), ("float16", (2,), "cpu"),
           ("float32", (4, 8), "cpu"), ("int8", (3,), "cpu"),
           ("float32", (4, 8), "cpu")]


def test_shape_delta_names_drifting_dimension_dtype_and_device():
    def leaves(x):
        return cw.digest_leaves(cw.arg_digest((x,), {}))

    prev = leaves(torch.zeros(8, 128, dtype=torch.int32))
    new = leaves(torch.zeros(8, 131, dtype=torch.int32))
    delta = cw.shape_delta(prev, new)
    assert "dim 1" in delta and "i32[8,128]" in delta
    assert "dtype" in cw.shape_delta(prev, leaves(torch.zeros(8, 128)))
    assert "arity" in cw.shape_delta(prev, prev + new)
    moved = leaves(torch.zeros(8, 128, dtype=torch.int32, device="meta"))
    delta = cw.shape_delta(prev, moved)
    assert "device" in delta and "@meta" in delta


def test_storm_detector_thresholds():
    programs: dict = {}
    for i in range(6):
        cw.fold_record(programs, "bucketed.prefill", 5.0,
                       {"digest": f"bucket{i}",
                        "leaves": (("int32", (8, 2 ** i)),)})
    assert cw.detect_storms(programs, 8) == []
    for i in range(6, 12):
        cw.fold_record(programs, "bucketed.prefill", 5.0,
                       {"digest": f"bucket{i}",
                        "leaves": (("int32", (8, 2 ** i)),)})
    storms = cw.detect_storms(programs, 8)
    assert len(storms) == 1
    assert storms[0]["program"] == "bucketed.prefill"
    assert storms[0]["distinct_shapes"] == 12
    assert "bucketed.prefill" in storms[0]["detail"]


def test_storm_window_ages_out_old_digests():
    programs: dict = {}
    stale = time.time() - 2 * cw.STORM_WINDOW_S
    for i in range(20):
        cw.fold_record(programs, "longlived.step", 5.0,
                       {"digest": f"old{i}", "time": stale + i})
    assert cw.detect_storms(programs, 8) == []
    for i in range(8):
        cw.fold_record(programs, "longlived.step", 5.0, {"digest": f"new{i}"})
    storms = cw.detect_storms(programs, 8)
    assert len(storms) == 1 and storms[0]["distinct_shapes"] == 8


def test_digest_ring_and_seen_set_are_bounded(monkeypatch):
    programs: dict = {}
    for i in range(4 * cw.DIGEST_RING):
        cw.fold_record(programs, "p", 1.0, {"digest": f"d{i}"})
    assert programs["p"]["compiles"] == 4 * cw.DIGEST_RING
    assert len(programs["p"]["digests"]) == cw.DIGEST_RING
    monkeypatch.setattr(cw, "SEEN_CAP", 4)
    fn = cw.instrument("test.capped", lambda x: x)
    for i in range(10):
        fn(torch.zeros(i + 1))
    assert len(fn._seen) <= 4
    assert fn.stats()["compiles"] == 10


def test_concurrent_misses_record_each_signature_once():
    """Threads racing on the same new signatures (more threads than
    cores, a short switch interval) record each one once; a call that
    raised leaves its signature unseen."""
    import sys
    import threading

    calls = []
    fn = cw.instrument("test.racing", lambda x: calls.append(x.shape))
    shapes = [(4, n) for n in range(1, 6)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [fn(torch.zeros(s)) for _ in range(50)
                            for s in shapes]) for _ in range(2 * os.cpu_count())]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(calls) == 50 * len(shapes) * len(threads)
    assert fn.stats() == {"compiles": 5, "distinct_shapes": 5}

    def boom(x):
        raise ValueError("no")

    failing = cw.instrument("test.failing", boom)
    for _ in range(2):
        with pytest.raises(ValueError):
            failing(torch.zeros(3))
    assert failing.signatures() == 0
    assert "test.failing" not in cw.snapshot()


# ---------------------------------------------------------------------------
# recording and billing
# ---------------------------------------------------------------------------


def test_eager_miss_records_one_compile_and_bills_nothing():
    """A new signature of an eager program is one compile record (the
    count the JAX package keeps), with no compile work: duration 0,
    nothing billed as compile_ms, and the hit path records nothing."""
    fn = cw.instrument("test.eager", lambda x: x * 2)
    for n in (4, 4, 8, 4, 8):
        fn(torch.ones(n))
    assert fn.stats() == {"compiles": 2, "distinct_shapes": 2}
    row = cw.snapshot()["test.eager"]
    assert row["total_ms"] == 0.0
    assert all(d["ms"] == 0.0 for d in row["digests"].values())
    assert "compile_ms" not in step_telemetry.take_phases()


def test_compile_ms_billed_only_on_the_step_whose_call_built():
    """compile_ms is billed on the step whose call ran a build, through
    the hook `_build.build` calls, once (the build's seconds credit the
    running program, whose record bills them), and on no later step;
    the build is also a record of its own under kernel.<name>."""
    def step(x, build):
        if build:
            cw.report_build({"flash_fwd": 0.25, "flash_bwd": 0.125}, 0.3)
        return x + 1

    fn = cw.instrument("test.billed_step", step)
    phases = []
    for s in range(3):
        fn(torch.zeros(16), s == 0)
        phases.append(step_telemetry.take_phases())
    assert phases[0]["compile_ms"] == pytest.approx(300.0)
    assert "compile_ms" not in phases[1] and "compile_ms" not in phases[2]
    snap = cw.snapshot()
    assert snap["test.billed_step"]["compiles"] == 1
    assert snap["test.billed_step"]["total_ms"] == pytest.approx(300.0)
    assert snap["kernel.flash_fwd"]["compiles"] == 1
    assert snap["kernel.flash_fwd"]["total_ms"] == pytest.approx(250.0)
    assert snap["kernel.flash_bwd"]["total_ms"] == pytest.approx(125.0)
    # The kernel records carry no digest: a rebuild can never fake a
    # storm.
    assert snap["kernel.flash_fwd"]["distinct_shapes"] == 0
    # Outside any program the build bills itself.
    cw.report_build({"flash_fwd_any": 0.1}, 0.1)
    assert step_telemetry.take_phases()["compile_ms"] == pytest.approx(100.0)


def _fake_nvcc(tmp_path):
    """An executable standing in for nvcc: writes the `-o` target and a
    ptxas-like line, after a short pause."""
    script = tmp_path / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        time.sleep(0.05)
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "w").write("not a library")
        print("ptxas info    : Used 32 registers")
        """))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_build_runs_the_hook_inside_an_instrumented_call(tmp_path,
                                                          monkeypatch):
    """`_build.build` itself reports: a build of flash_fwd inside an
    instrumented call is one kernel.flash_fwd record with the build's
    wall time, and that time is the program's compile_ms."""
    from ray_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    fn = cw.instrument("test.loads_kernel",
                       lambda x: _build.build(("flash_fwd",)))
    reports = fn(torch.zeros(2))
    assert "Used 32 registers" in reports["flash_fwd"]
    assert _build.library_path("flash_fwd").exists()
    snap = cw.snapshot()
    kernel = snap["kernel.flash_fwd"]
    assert kernel["compiles"] == 1 and kernel["total_ms"] >= 50.0
    program = snap["test.loads_kernel"]
    assert program["compiles"] == 1
    assert program["total_ms"] >= kernel["total_ms"]
    # (the snapshot rounds to the microsecond)
    assert step_telemetry.take_phases()["compile_ms"] == pytest.approx(
        program["total_ms"], abs=1e-3)
    # A second build finds the library: nothing built, nothing billed.
    assert _build.build(("flash_fwd",)) == {}
    assert cw.snapshot()["kernel.flash_fwd"]["compiles"] == 1
    assert "compile_ms" not in step_telemetry.take_phases()


def test_dynamo_compile_is_credited_to_the_running_program():
    """Where a caller loads dynamo, its compiles are credited to the
    instrumented call that triggered them, as nvcc's builds are."""
    compiled = torch.compile(lambda x: torch.sin(x) + 1, backend="eager")
    fn = cw.instrument("test.dynamo", compiled)
    fn(torch.zeros(8))
    fn(torch.zeros(8))
    row = cw.snapshot()["test.dynamo"]
    assert row["compiles"] == 1 and row["total_ms"] > 0.0
    assert step_telemetry.take_phases()["compile_ms"] == pytest.approx(
        row["total_ms"], abs=1e-3)


def test_config_kill_switch_and_threshold():
    from ray_tpu_torch._private.config import Config

    try:
        cw.configure(Config(compile_watch_enabled=False))
        assert not cw.enabled()
        fn = cw.instrument("test.disabled", lambda x: x)
        assert fn(41) == 41
        cw.report_build({"flash_fwd": 1.0}, 1.0)
        assert cw.snapshot() == {}
        assert "compile_ms" not in step_telemetry.take_phases()
        cw.configure(Config(compile_watch_enabled=True,
                            compile_storm_threshold=3))
        assert cw.enabled() and cw.storm_threshold() == 3
    finally:
        cw.configure(Config())


def test_hot_path_overhead_under_the_jax_bar():
    """The JAX package's bar: the hot path (digest + seen-set lookup)
    on a train-step argument tree of 96 tensors costs under 0.2 ms a
    call, 1% of a 20 ms step."""
    params = {
        f"layer_{i}": {
            "attn": {k: torch.zeros(4, 4) for k in ("wq", "wk", "wv", "wo")},
            "mlp": {"w1": torch.zeros(4, 8), "w2": torch.zeros(8, 4)},
        }
        for i in range(16)
    }
    batch = torch.zeros(8, 128, dtype=torch.int32)
    fn = cw.instrument("test.overhead", lambda *a: None)
    fn(params, batch, batch)  # the one recorded compile
    n = 2000
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(params, batch, batch)
        best = min(best, (time.perf_counter() - t0) / n)
    overhead_ms = best * 1e3
    assert overhead_ms < 0.01 * 20.0, (
        f"compile-watch hot path costs {overhead_ms:.4f} ms/call")
    assert fn.stats()["compiles"] == 1


def test_doctor_names_a_drifting_program_through_the_port_runtime():
    """A shape-unstable loop is convicted by the port's doctor
    (`rt.diagnose`, verdict.compile): program, count and drifting
    dimension; a shape-stable program beside it stays clean."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import metrics
    from ray_tpu_torch.util.state import compile_summary

    _drop_buffered_records()
    rt.init(num_cpus=1)
    try:
        drifting = cw.instrument("test.drifting_step", lambda x: x.sum())
        stable = cw.instrument("test.stable_step", lambda x: x.sum())
        for i in range(2, 14):
            drifting(torch.zeros(4, i))
            stable(torch.zeros(4, 8))
        metrics.flush()
        verdict = rt.diagnose(capture_stacks=False)
        storms = [p for p in verdict["problems"]
                  if p["kind"] == "recompile_storm"]
        assert [s["program"] for s in storms] == ["test.drifting_step"]
        assert storms[0]["compiles"] == 12
        assert "dim 1" in storms[0]["delta"]
        programs = verdict["compile"]["programs"]
        assert programs["test.stable_step"]["distinct_shapes"] == 1
        assert compile_summary()["storms"][0]["program"] == \
            "test.drifting_step"
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# parity with the JAX package's watch
# ---------------------------------------------------------------------------

#: A configuration no other test uses, so the JAX package's programs
#: see new signatures (its watch records a miss only when XLA compiles).
KW = dict(vocab_size=44, dim=48, n_layers=1, n_heads=4, n_kv_heads=2,
          intermediate=96, max_seq_len=64)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig(dtype=jnp.float32, attention="reference",
                                 **KW)
    cfg = llama.LlamaConfig(dtype=torch.float32, attention="reference",
                            remat=False, **KW)
    tree = jax.tree.map(np.asarray,
                        jax_llama.init_params(jax.random.PRNGKey(3), jcfg))
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, model


def _counts(snap, name):
    row = snap.get(name, {"compiles": 0, "distinct_shapes": 0})
    return row["compiles"], row["distinct_shapes"]


def test_generate_programs_count_as_the_jax_package(models, monkeypatch):
    """The same calls through the JAX package's instrumented
    `generate.prefill` / `paged_decode_step` and the port's give equal
    compiles and distinct shapes per program."""
    _watch_both_packages(monkeypatch)
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(0)
    for t in (8, 12, 8, 12, 8):
        toks = rng.integers(1, 44, (1, t)).astype(np.int32)
        jax_gen.prefill(params, jcfg, jnp.asarray(toks),
                        jax_gen.init_kv_cache(jcfg, 1, 32), 0, t)
        gen.prefill(model, cfg, torch.from_numpy(toks).long(),
                    gen.init_kv_cache(cfg, 1, 32, device="cpu"), 0, t)
    for b in (2, 3, 2):
        jpool = jax_gen.init_block_pool(jcfg, 8, 4)
        pool = gen.init_block_pool(cfg, 8, 4, device="cpu")
        tables = np.ones((b, 2), np.int32)
        positions = np.full((b,), 3, np.int32)
        logits = np.zeros((b, 44), np.float32)
        alive = np.ones((b,), bool)
        jax_gen.paged_decode_step(
            params, jcfg, jpool, jnp.asarray(tables), jnp.asarray(logits),
            jnp.asarray(positions), jnp.asarray(alive),
            jax.random.PRNGKey(0), temperature=0.0, top_k=0)
        gen.paged_decode_step(
            model, cfg, pool, torch.from_numpy(tables).long(),
            torch.from_numpy(logits), torch.from_numpy(positions).long(),
            torch.from_numpy(alive), None, temperature=0.0, top_k=0)
    jsnap, snap = jax_cw.snapshot(), cw.snapshot()
    for name, want in (("generate.prefill", (2, 2)),
                       ("generate.paged_decode_step", (2, 2))):
        assert _counts(snap, name) == want
        assert _counts(jsnap, name) == want


def _run_engine(engine, prompts):
    streams = [engine.submit(p, max_new_tokens=4) for p in prompts]
    outs = [list(s) for s in streams]
    stats = engine.stats()
    engine.close()
    return outs, stats


def test_engine_compiles_equal_the_jax_engine(models, monkeypatch):
    """The JAX and port engines on the same traffic give equal
    stats()["compiles"][*]["distinct_shapes"]. The JAX engine's first
    run shows 0: its generate.* programs, running inside its
    engine.* programs, take XLA's compile events. So its programs are
    warmed, XLA's caches cleared, and a second engine counts."""
    from ray_tpu.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.llm import InferenceEngine as JaxEngine
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine

    _watch_both_packages(monkeypatch)
    jcfg, params, cfg, model = models
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 44, size=n).tolist() for n in (5, 8, 11)]
    opts = dict(max_new_tokens=4, slots=2, max_len=32, prefill_chunk=8)
    _run_engine(JaxEngine(params, jcfg, JaxEngineConfig(**opts),
                          family="cw"), prompts)
    jax_cw.reset()
    jax.clear_caches()
    jouts, jstats = _run_engine(
        JaxEngine(params, jcfg, JaxEngineConfig(**opts), family="cw"),
        prompts)
    outs, stats = _run_engine(
        InferenceEngine(model, cfg, EngineConfig(**opts), family="cw"),
        prompts)
    assert outs == jouts
    assert set(stats["compiles"]) == set(jstats["compiles"]) == {
        "prefill", "decode"}
    for key in ("prefill", "decode"):
        assert stats["compiles"][key]["distinct_shapes"] == \
            jstats["compiles"][key]["distinct_shapes"] == 1
        assert stats["compiles"][key]["compiles"] == 1
    assert set(cw.snapshot()) >= {"engine.paged_prefill[cw]",
                                  "engine.paged_decode_step[cw]"}


def _jax_instrument_names():
    """Every program name `ray_tpu` registers: the JAX inventory lists
    its jit wraps' names; the engine's three families wrap plain
    forwarders, so they come from an AST walk of the `instrument`
    calls, read with the JAX pass's own name reader."""
    import ast

    import ray_tpu
    from ray_tpu.devtools import accel as jax_accel

    pkg = os.path.dirname(ray_tpu.__file__)
    names = {p["program"] for p in jax_accel.build_inventory([pkg])["programs"]
             if p["registered"]}
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py") or "devtools" in root:
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and jax_accel._dotted(node.func).endswith("instrument")
                        and len(node.args) >= 2):
                    name, _kind = jax_accel._program_name(node.args[0])
                    if name:
                        names.add(name)
    return names


def test_the_port_registers_every_program_the_jax_package_does():
    import ray_tpu_torch
    from ray_tpu_torch.devtools import accel

    pkg = os.path.dirname(ray_tpu_torch.__file__)
    port = {p["program"] for p in accel.build_inventory([pkg])["programs"]
            if p["registered"]}
    want = _jax_instrument_names()
    assert port == want
    assert {"engine.paged_prefill[*]", "engine.paged_decode_step[*]",
            "engine.policy[*]", "mpmd.s*.*", "train.step",
            "rl.ppo.minibatch_update"} <= port
