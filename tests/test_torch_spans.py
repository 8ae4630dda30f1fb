"""The port's spans: the flight recorder's `span`/`record_span` on
torch.profiler's clock, the serving engine's loop spans and their
counters in `stats()`, and the train step's three spans. On the CPU, at
a tiny width; no JAX."""

import time

import pytest
import torch

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch.llm import EngineConfig, InferenceEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.train import default_optimizer, make_train_step


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    cfg = llama.LlamaConfig.tiny(attention="reference", remat=False)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")


def spans_since(t0_ns, kind):
    return [r for r in flight_recorder.snapshot(kinds=[kind])
            if r.get("start_ns", 0) >= t0_ns]


def serve(model, prompts, max_new=6, **kw):
    """Each prompt's (request id, client ns of its first and last
    token), submitted together, and the engine's stats."""
    cfg, m = model
    eng = InferenceEngine(m, cfg, EngineConfig(
        max_len=64, prefill_chunk=8, prefix_cache=False, **kw), family="tiny")
    try:
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        out = []
        for s in streams:
            times = [time.time_ns() for _ in s]
            assert len(times) == max_new
            out.append((s.request_id, times[0], times[-1]))
        return out, eng.stats()
    finally:
        eng.close()


@pytest.fixture
def recorder_off(monkeypatch):
    """RT_flight_recorder_enabled=0, applied as a process applies it."""
    ring = flight_recorder.recorder()
    was = ring.enabled
    monkeypatch.setenv("RT_flight_recorder_enabled", "0")
    flight_recorder.configure(object())
    yield
    ring.enabled = was


def test_a_span_lands_on_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile, record_function

    def traced():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with flight_recorder.span("test", "marker"):
                with record_function("test.marker"):
                    time.sleep(0.05)
        return prof

    traced()  # the profiler's first start in a process pays its set-up
    t0 = time.time_ns()
    prof = traced()
    ring = spans_since(t0, "test")[-1]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    marker = next(e for e in prof.events() if e.name == "test.marker")
    # The profiler's microseconds from its start, as the ring's stamps
    # read them after conversion.
    assert abs((ring["start_ns"] - start_ns) / 1e3
               - marker.time_range.start) < 1000
    assert abs((ring["end_ns"] - start_ns) / 1e3
               - marker.time_range.end) < 1000
    assert ring["dur_ms"] == pytest.approx(
        (ring["end_ns"] - ring["start_ns"]) / 1e6, abs=1e-3)


def test_engine_launch_and_wait_add_up_and_a_queued_request_waits(model):
    (first, second), stats = serve(model, [[1, 2, 3] * 5, [4, 5, 6] * 5],
                                   slots=1)
    steps = sum(r["steps"] for r in stats["decode_by_batch"].values())
    decode_ms = sum(r["ms"] for r in stats["decode_by_batch"].values())
    assert steps == stats["steps"] == 12
    assert stats["decode_launch_ms"] + stats["decode_wait_ms"] == \
        pytest.approx(decode_ms, rel=1e-9)
    assert stats["prefill_launch_ms"] + stats["prefill_wait_ms"] == \
        pytest.approx(stats["prefill_ms"], rel=1e-9)
    assert stats["admitted"] == 2 and stats["decode_emit_ms"] > 0
    # One slot: the second request waits while the first streams.
    _, a_first, a_last = first
    assert stats["queue_wait_ms"] >= (a_last - a_first) / 1e6


def test_engine_spans_carry_request_and_step_ids(model):
    t0 = time.time_ns()
    served, stats = serve(model, [[7, 8, 9, 10], [11, 12] * 6], slots=2)
    spans = spans_since(t0, "engine")
    ids = {rid for rid, _, _ in served}
    by_name = {}
    for r in spans:
        by_name.setdefault(r["name"], []).append(r)
    for name in ("queue", "admit"):
        assert {r["request"] for r in by_name[name]} == ids
    chunks = by_name["prefill.launch"]
    assert len(chunks) == stats["prefill_chunks"] == len(by_name["prefill.wait"])
    assert {r["request"] for r in chunks} == ids
    assert sorted(r["offset"] for r in chunks) == [0, 0, 8]
    for name in ("decode.launch", "decode.wait", "decode.emit"):
        assert [r["step"] for r in by_name[name]] == list(range(stats["steps"]))
    assert {r["batch"] for r in by_name["decode.launch"]} <= {1, 2}
    # A step's three spans follow one another on the engine's thread.
    for launch, wait, emit in zip(by_name["decode.launch"],
                                  by_name["decode.wait"],
                                  by_name["decode.emit"]):
        assert launch["end_ns"] == wait["start_ns"]
        assert wait["end_ns"] == emit["start_ns"] <= emit["end_ns"]
        assert launch["tid"] == wait["tid"] == emit["tid"]
    total = sum(r["dur_ms"] for r in by_name["decode.launch"]
                + by_name["decode.wait"])
    assert total == pytest.approx(
        sum(r["ms"] for r in stats["decode_by_batch"].values()), abs=0.01)


def test_an_idle_period_is_one_span(model):
    """The loop parks every `idle_wait_s` while idle; a run of parks is
    one span, recorded when work resumes, and counted in `idle_ms`."""
    cfg, m = model
    t0 = time.time_ns()
    eng = InferenceEngine(m, cfg, EngineConfig(
        max_len=64, prefill_chunk=8, idle_wait_s=0.005), family="tiny")
    try:
        list(eng.submit([1, 2, 3], max_new_tokens=2))
        time.sleep(0.1)
        list(eng.submit([4, 5, 6], max_new_tokens=2))
        stats = eng.stats()
    finally:
        eng.close()
    idle = [r["dur_ms"] for r in spans_since(t0, "engine") if r["name"] == "idle"]
    # The pause, and perhaps the park before the first request.
    assert len([ms for ms in idle if ms >= 90]) == 1 and len(idle) <= 2
    assert stats["idle_ms"] == pytest.approx(sum(idle), abs=2e-3)


def test_recorder_off_records_no_span_and_still_counts(model, recorder_off):
    t0 = time.time_ns()
    _, stats = serve(model, [[1, 2, 3]], slots=1)
    with flight_recorder.span("train", "optimizer"):
        pass
    assert spans_since(t0, "engine") == spans_since(t0, "train") == []
    assert stats["admitted"] == 1 and stats["decode_launch_ms"] > 0
    assert stats["prefill_launch_ms"] > 0 and stats["queue_wait_ms"] > 0


def test_train_step_records_its_three_spans_in_order(model):
    cfg, _ = model
    m = llama.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    init_fn, step_fn = make_train_step(llama.loss_fn, default_optimizer(),
                                       device="cpu")
    state = init_fn(m)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(2))
    t0 = time.time_ns()
    state, _ = step_fn(state, tokens[:, :-1], tokens[:, 1:])
    spans = spans_since(t0, "train")
    assert [r["name"] for r in spans] == ["forward_backward", "grad_norm",
                                          "optimizer"]
    assert {r["step"] for r in spans} == {0}
    for a, b in zip(spans, spans[1:]):
        assert a["end_ns"] <= b["start_ns"]
