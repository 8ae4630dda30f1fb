"""The serving driver: the port's `InferenceEngine` (the engine that
`llm/serving.py` deploys) in this process, sent an open loop of chat
requests through `submit` and read through each request's `TokenStream`.

Set-up builds the model and the engine, its KV pool sized to what the
traffic can reach (every slot at `max_len`, and the system prefixes kept
in the prefix cache besides), and sends one short request a system
prefix, which runs every shape the window runs and fills the prefix
cache as a server that has been up has it. The pool's fill and the
engine's compile counts are read through the window and its drain. The window
sends each request at its due time whatever the engine's state; no
request is sent after it closes, and those sent may finish for up to
the mix's drain. TTFT runs from a request's due time to its first
token; the gaps are between its consecutive tokens. Once all have
finished, a sample drawn from the seed, the longest among them, is
checked against the reference.
"""

from __future__ import annotations

import gc
import math
import random
import threading
import time
from typing import List, Optional

from .. import traffic
from . import port


class Flight:
    """One request as the client sees it."""

    def __init__(self, req: traffic.Request, due: float):
        self.req = req
        self.due = due
        self.sent: Optional[float] = None
        self.tokens: List[int] = []
        self.times: List[float] = []
        self.error: Optional[BaseException] = None
        self.stream = None
        self.thread: Optional[threading.Thread] = None

    def consume(self):
        try:
            for tok in self.stream:
                self.times.append(time.perf_counter())
                self.tokens.append(tok)
        except Exception as e:  # noqa: BLE001 - the request failed
            self.error = e

    @property
    def finished(self) -> bool:
        return self.error is None and len(self.tokens) == self.req.output_tokens


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def send(engine, reqs, t0: float, actions=()) -> List[Flight]:
    """The open loop: each request at its due time, a reader thread each.
    `actions`, (seconds after t0, callable), run in the same loop at
    their times (the profiler starts and stops on this thread)."""
    flights = []
    todo = sorted(actions, key=lambda x: x[0])
    for r in reqs:
        f = Flight(r, t0 + r.due_s)
        flights.append(f)
        while todo and t0 + todo[0][0] <= f.due:
            _sleep_until(t0 + todo[0][0])
            todo.pop(0)[1]()
        _sleep_until(f.due)
        f.sent = time.perf_counter()
        try:
            f.stream = engine.submit(r.prompt, max_new_tokens=r.output_tokens)
        except Exception as e:  # noqa: BLE001 - refused: counts as failed
            f.error = e
            continue
        f.thread = threading.Thread(target=f.consume, daemon=True)
        f.thread.start()
    for at, fn in todo:
        _sleep_until(t0 + at)
        fn()
    return flights


def _sleep_until(when: float) -> None:
    delay = when - time.perf_counter()
    if delay > 0:
        time.sleep(delay)


def drain(engine, flights: List[Flight], deadline: float) -> None:
    """Wait for every reader until `deadline`; cancel what is left."""
    for f in flights:
        if f.thread is not None:
            f.thread.join(max(0.0, deadline - time.perf_counter()))
    for f in flights:
        if f.thread is not None and f.thread.is_alive():
            f.stream.cancel()
            f.thread.join(30.0)
            if f.error is None and not f.finished:
                f.error = TimeoutError("unfinished at the drain's end")


def live_token_sum(flights: List[Flight], skip=(0.0, 0.0)) -> int:
    """Cache tokens the decode steps attended over: the i-th served
    token of a request (from 0) is sampled by a step that reads its
    prompt and i + 1 tokens. Tokens that came within `skip` (a profiled
    slice) are left out."""
    total = 0
    for f in flights:
        p = len(f.req.prompt)
        total += sum(p + i + 1 for i, t in enumerate(f.times)
                     if not skip[0] <= t <= skip[1])
    return total


def pool_blocks(mix: dict) -> int:
    """The KV pool's blocks: every slot at `max_len`, the system
    prefixes' blocks kept in the prefix cache, and the engine's one
    reserved block."""
    e = mix["engine"]
    pre = mix.get("prefixes")
    cached = len(pre["shares"]) * (pre["tokens"] // e["kv_block_len"]) if pre else 0
    return e["slots"] * (e["max_len"] // e["kv_block_len"]) + cached + 1


class PoolWatch:
    """The highest fill of the KV pool and of the slots, read from
    `engine.stats()` every `every_s` seconds on a thread of its own."""

    KEYS = ("kv_blocks_used", "kv_blocks_cached", "slots_used", "waiting")

    def __init__(self, engine, every_s: float):
        self.engine, self.every_s = engine, every_s
        self.peak = dict.fromkeys(self.KEYS + ("kv_blocks_used_or_cached",), 0)
        self.reads = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.every_s):
            s = self.engine.stats()
            now = {k: s[k] for k in self.KEYS}
            now["kv_blocks_used_or_cached"] = (s["kv_blocks_used"]
                                               + s["kv_blocks_cached"])
            for k, v in now.items():
                self.peak[k] = max(self.peak[k], v)
            self.reads += 1


def _counters(stats: dict) -> dict:
    by_batch = stats["decode_by_batch"].values()
    return {"decode_steps": sum(r["steps"] for r in by_batch),
            "decode_ms": sum(r["ms"] for r in by_batch),
            "prefill_tokens": stats["prefill_tokens"],
            "prefill_ms": stats["prefill_ms"],
            "prefix_hits": stats["prefix_hits"],
            "prefix_misses": stats["prefix_misses"]}


def _delta(after: dict, before: dict, *slices) -> dict:
    """Counters over the window and its drain, less any profiled slice."""
    out = {k: after[k] - before[k] for k in after}
    for lo, hi in slices:
        for k in out:
            out[k] -= hi[k] - lo[k]
    return out


def _window(torch, cell, seed, seconds, trace, started, dev, record) -> dict:
    """Set-up, the window and its drain, on an engine that lives only
    here. Fills `record` with the engine's size and trace."""
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine

    from .. import trace as tracing

    mix = cell.mix
    cuda = dev.type == "cuda"
    ec_spec = dict(mix["engine"])
    model, cfg, a = port.build_model(cell.config, seed, dev, remat=False,
                                     max_seq_len=ec_spec["max_len"])
    model.requires_grad_(False)
    ec_spec["kv_blocks"] = pool_blocks(mix)
    engine = InferenceEngine(model, cfg, EngineConfig(**ec_spec),
                             family=cell.config_name)
    stats = engine.stats()
    record.update(arch=a, kv_blocks=stats["kv_blocks_total"],
                  kv_bytes=stats["kv_bytes"])
    flights: List[Flight] = []
    watch = PoolWatch(engine, mix["pool_watch_s"])
    try:
        warm = [engine.submit(r.prompt, max_new_tokens=r.output_tokens)
                for r in traffic.warmup_requests(mix, seed, a["vocab"])]
        for stream in warm:
            list(stream)
        reqs = traffic.serve_requests(mix, seed, seconds, a["vocab"])
        before = _counters(engine.stats())
        compiles_before = engine.stats().get("compiles")
        actions = []
        if trace and cuda:
            tracing.warm_profiler(torch)
            window = tracing.Window(torch)
            profiled = _ProfiledSlice(engine, window)
            actions = [(mix["profile_start_s"], profiled.start),
                       (mix["profile_start_s"] + mix["profile_s"], profiled.stop)]
        t0 = time.perf_counter()
        setup_s = t0 - started
        watch.start()
        flights = send(engine, reqs, t0, actions)
        drain(engine, flights, t0 + seconds + mix["drain_s"])
        watch.stop()
        after = _counters(engine.stats())
        record.update(pool_peak=dict(watch.peak, reads=watch.reads),
                      compiles={"before": compiles_before,
                                "after": engine.stats().get("compiles")})
        slices, span = [], (0.0, 0.0)
        if actions:
            record["trace"] = window.summary()
            slices, span = [profiled.counters], profiled.span
        memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    finally:
        watch.stop()
        engine.close()
        for f in flights:
            f.stream = None  # a stream holds the engine
    return {"flights": flights, "t0": t0, "setup_s": setup_s,
            "counted": _delta(after, before, *slices), "span": span,
            "memory_peak": memory_peak}


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda", controls: bool = False) -> dict:
    import torch

    mix = cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    record: dict = {}
    w = _window(torch, cell, seed, seconds, trace, started, dev, record)
    # The engine, its pool and the model were the window's alone: free
    # them before the reference runs.
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    flights, t0 = w["flights"], w["t0"]
    failed = [f for f in flights if not f.finished]
    ttft, gaps = [], []
    for f in flights:
        if f.times:
            ttft.append((f.times[0] - f.due) * 1e3)
            gaps += [(y - x) * 1e3 for x, y in zip(f.times, f.times[1:])]
        else:  # never came: it waited out the drain
            ttft.append((t0 + seconds + mix["drain_s"] - f.due) * 1e3)
    counted = w["counted"]
    record.update(
        requests=len(flights),
        decode={"steps": counted["decode_steps"], "ms": counted["decode_ms"]},
        prefill={"tokens": counted["prefill_tokens"], "ms": counted["prefill_ms"]},
        prefix={"hits": counted["prefix_hits"], "misses": counted["prefix_misses"]},
        live_tokens=live_token_sum(flights, w["span"]),
        sender_late_ms=max(((f.sent or f.due) - f.due) * 1e3 for f in flights),
        ttft_p50_ms=percentile(ttft, 50), itl_p50_ms=percentile(gaps, 50),
        ttft_quarters_ms=[percentile(ttft[i * len(ttft) // 4:(i + 1) * len(ttft) // 4], 50)
                          for i in range(4)],
        last_token_after_close_s=max((f.times[-1] for f in flights if f.times),
                                     default=t0) - (t0 + seconds),
    )

    done = [f for f in flights if f.finished]
    numbers = {"logit_gap": float("inf"), "served_tokens": 0}
    if done:
        sample = check_sample(done, seed, mix["check_requests"])
        pairs = [(f.req.prompt, f.tokens) for f in sample]
        t_ref = time.perf_counter()
        if cuda:
            record["allocated_before_reference"] = torch.cuda.memory_allocated(dev)
        numbers = reference(cell, seed, dev, pairs, controls)
        record["reference_s"] = time.perf_counter() - t_ref
    return {
        "e2e": {"ttft_p90_ms": percentile(ttft, 90),
                "itl_p95_ms": percentile(gaps, 95), "setup_s": w["setup_s"]},
        "record": record,
        "numbers": numbers,
        "attempted": len(flights),
        "failed": len(failed),
        "memory_peak_bytes": w["memory_peak"],
    }


class _ProfiledSlice:
    """A profiled slice of the window, with the engine's counters at its
    ends, so that the counted metrics can leave the slice out."""

    def __init__(self, engine, window):
        self.engine, self.window = engine, window

    def start(self) -> None:
        self.begin = time.perf_counter()
        self.lo = _counters(self.engine.stats())
        self.window.start()

    def stop(self) -> None:
        self.window.stop(sync=False)
        self.counters = (self.lo, _counters(self.engine.stats()))
        self.span = (self.begin, time.perf_counter())


def check_sample(done: List[Flight], seed: int, n: int) -> List[Flight]:
    """The longest finished request (most tokens in all) and n - 1 more
    drawn from the seed."""
    longest = max(done, key=lambda f: (len(f.req.prompt) + len(f.tokens),
                                       -f.req.index))
    rest = [f for f in done if f is not longest]
    return [longest] + random.Random(seed).sample(rest, min(n - 1, len(rest)))


def reference(cell, seed: int, device, pairs, controls: bool = False) -> dict:
    from .. import weights
    from ..reference import model as ref_model
    from ..reference import serve as ref_serve

    ref_model.no_tf32()
    precisions = ("f32", "fp8") if controls else ("f32",)
    logits = ref_serve.served_logits(weights.arch(cell.config), seed, pairs,
                                     device, precisions)
    return ref_serve.gap_readings(logits, pairs)

