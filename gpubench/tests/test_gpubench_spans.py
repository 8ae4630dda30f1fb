"""The program's spans read against a profiled window (`gpubench.spans`):
device time by the innermost span open at each launch and idle gaps by
span, on synthetic events; and the probe that lays them and the serving
engine's span counters over a run (`gpubench.spanprobe`), on the tiny
serve cell on the CPU."""

import pytest

from gpubench import spanprobe, spans, spec, trace

#: (name, start_us, end_us): kernels, a copy, and one kernel the
#: profiler links to no runtime call.
DEVICE = [("k_fwd", 100, 200), ("k_opt", 300, 400), ("memcpyHtoD", 410, 420),
          ("k_free", 700, 800), ("k_late", 1000, 1100)]
#: When the host called the runtime for each device event.
LAUNCHES = [90, 290, 405, 600, None]
HOST = [("gpubench.train_step", 0, 2000), ("cudaLaunchKernel", 88, 95),
        ("aten::mm", 500, 900)]
PROGRAM = [("train.forward_backward", 50, 250), ("train.optimizer", 260, 450),
           ("train.inner", 285, 295), ("engine.queue", 0, 2000)]


def test_device_time_goes_to_the_innermost_span_open_at_launch():
    out = spans.summarize(DEVICE, HOST, 0.002, PROGRAM, LAUNCHES)
    assert out["span_device_s"] == pytest.approx({
        "train.forward_backward": 100e-6, "train.inner": 100e-6,
        "train.optimizer": 10e-6, spans.NO_SPAN: 200e-6})
    # The wait span covers everything and owns nothing.
    assert "engine.queue" not in out["span_device_s"]


def test_gaps_are_named_by_the_program_span_then_the_harness_span():
    out = spans.summarize(DEVICE, HOST, 0.002, PROGRAM, LAUNCHES)
    assert dict(out["idle_gaps"]) == pytest.approx({
        # 200-300: forward_backward overlaps it 50 us, optimizer 40.
        "train.forward_backward / no op": 100e-6,
        "gaps under 20 us": 10e-6,
        # 420-700: only the optimizer's span; aten::mm overlaps most.
        "train.optimizer / aten::mm": 280e-6,
        # 800-1000: no program span, so the harness's.
        "gpubench.train_step / aten::mm": 200e-6})
    assert out["idle_by_span_s"] == pytest.approx({
        "train.forward_backward": 100e-6, "train.optimizer": 280e-6,
        "gpubench.train_step": 200e-6})
    bare = spans.summarize(DEVICE, HOST[1:], 0.002, PROGRAM, LAUNCHES)
    assert bare["idle_by_span_s"][spans.NO_SPAN] == pytest.approx(200e-6)


def test_nested_spans_name_a_gap_by_the_inner_one():
    device = [("a", 0, 10), ("b", 110, 120)]
    program = [("engine.decode.launch", 0, 200), ("engine.admit", 5, 150)]
    out = spans.summarize(device, [], 0.001, program, [1, 100])
    assert out["idle_by_span_s"] == pytest.approx({"engine.admit": 100e-6})
    assert out["span_device_s"] == pytest.approx(
        {"engine.decode.launch": 10e-6, "engine.admit": 10e-6})


@pytest.mark.parametrize("program", [(), [("engine.queue", 0, 2000)]],
                         ids=["none", "wait spans only"])
def test_without_program_spans_the_reading_is_the_harness_own(program):
    assert spans.summarize(DEVICE, HOST, 0.002, program, LAUNCHES) == \
        trace.summarize(DEVICE, HOST, 0.002)


def test_ring_records_convert_to_the_profiler_timeline():
    records = [{"kind": "engine", "name": "decode.launch", "start_ns": 5_000,
                "end_ns": 9_500, "step": 3}]
    assert spans.to_profiler_us(records, 1_000) == [
        ("engine.decode.launch", 4.0, 8.5)]


def test_clock_checks():
    out = spans.summarize(DEVICE, HOST, 0.002, PROGRAM, LAUNCHES)
    program = PROGRAM + [("engine.decode.launch", 80, 95)]
    checks = spans.clock_checks(DEVICE, LAUNCHES, program, out)
    # Four kernels (the copy is none); one launched in a launch span.
    assert checks["kernels"] == 4
    assert checks["kernels_launched_in_launch_spans"] == pytest.approx(0.25)
    assert checks["device_share_in_spans"] == pytest.approx(210 / 410)
    assert checks["idle_share_no_span"] == 0.0


def _serve(tiny_root):
    c = spec.cell("tiny-serve", tiny_root)
    return spanprobe.probe(c, 2**33 + 5, 1.0, device="cpu", root=tiny_root)


def test_probe_reads_the_serve_counters(tiny_root):
    result = _serve(tiny_root)
    assert result["correct"] is True, result["checks"]
    readings = result["spans"]["readings"]
    for name in spanprobe.SERVE_READINGS:
        assert readings[name] > 0, name
    assert readings["decode_launch_and_wait_over_step_ms"] == pytest.approx(1.0, abs=1e-6)
    assert readings["prefill_launch_and_wait_over_prefill_ms"] == pytest.approx(1.0, abs=1e-6)
    counted = result["spans"]["counted"]
    assert counted["decode_steps"] == result["record"]["decode"]["steps"]
    assert counted["prefill_ms"] == result["record"]["prefill"]["ms"]
    assert set(result["metrics"]) >= {"decode_step_ms.serve",
                                      "prefill_tokens_per_s.serve"}


def test_probe_leaves_out_what_an_older_engine_does_not_count(tiny_root,
                                                               monkeypatch):
    """An engine whose `stats()` lacks the span counters: the probe
    reads none of them, and the run's own metrics are still read."""
    from ray_tpu_torch.llm import InferenceEngine

    stats = InferenceEngine.stats
    new = set(spanprobe.SERVE_KEYS) - {"prefill_chunks"}

    def older(self):
        return {k: v for k, v in stats(self).items() if k not in new}

    monkeypatch.setattr(InferenceEngine, "stats", older)
    result = _serve(tiny_root)
    assert result["correct"] is True, result["checks"]
    assert result["spans"]["readings"] == {}
    assert set(result["metrics"]) >= {"decode_step_ms.serve",
                                      "prefill_tokens_per_s.serve"}
