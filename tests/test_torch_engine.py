"""The port's continuous-batching engine (`ray_tpu_torch.llm`) on the
CPU, mirroring the JAX package's engine and allocator tests
(`tests/test_llm_engine.py`, `tests/test_kv_blocks.py`, the engine half
of `tests/test_rl_dataflow.py`).

The copied `SlotScheduler` and `BlockAllocator` run the same cases as
the JAX package's originals. The engine serves a tiny f32 GQA model
whose parameters come from the JAX package through `load_jax_params`,
and its greedy tokens are held exactly to the port's `generate` and to
the JAX package's."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import kv_slots as jax_kv_slots
from ray_tpu.llm import scheduler as jax_scheduler
from ray_tpu.models import generate as jax_gen
from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.llm import (
    BatchProgram,
    EngineConfig,
    EngineDead,
    EngineOverloaded,
    InferenceEngine,
    kv_slots,
    scheduler,
)
from ray_tpu_torch.models import generate as gen
from ray_tpu_torch.models import llama

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

IMPLS = {"port": (scheduler, kv_slots), "jax": (jax_scheduler, jax_kv_slots)}
impls = pytest.mark.parametrize("impl", sorted(IMPLS))


# ---------------------------------------------------------------------
# scheduler and allocator: the copies and the originals, case by case
# ---------------------------------------------------------------------

@impls
def test_scheduler_fifo_admission_and_slot_reuse(impl):
    sched = IMPLS[impl][0].SlotScheduler(2, max_waiting=8)
    for name in ("a", "b", "c", "d"):
        sched.submit(name)
    first, second = sched.admit_next(), sched.admit_next()
    assert (first[0], second[0]) == ("a", "b")
    assert sched.admit_next() is None
    assert sched.release(first[1]) == "a"
    third = sched.admit_next()
    assert third == ("c", first[1])
    assert sched.stats() == {"slots_total": 2, "slots_used": 2, "waiting": 1}
    assert sorted(sched.drain()) == ["b", "c", "d"]
    assert sched.admit_next() is None


@impls
def test_scheduler_overload_and_waiting_removal(impl):
    mod = IMPLS[impl][0]
    sched = mod.SlotScheduler(1, max_waiting=2)
    sched.submit("a")
    sched.submit("b")
    with pytest.raises(mod.EngineOverloaded):
        sched.submit("c")
    assert sched.remove_waiting("b")
    assert not sched.remove_waiting("b")
    sched.submit("d")
    assert list(sched.waiting) == ["a", "d"]
    # A vetoed head stays the head: no skip-ahead.
    assert sched.admit_next(gate=lambda r: r != "a") is None
    assert sched.admit_next()[0] == "a"


@impls
def test_allocator_reserve_release_and_oom(impl):
    kv = IMPLS[impl][1]
    alloc = kv.BlockAllocator(9)
    assert alloc.capacity() == alloc.available() == 8
    blocks = alloc.reserve(5)
    assert len(set(blocks)) == 5 and 0 not in blocks
    assert (alloc.used(), alloc.available()) == (5, 3)
    with pytest.raises(kv.BlocksExhausted):
        alloc.reserve(4)
    assert alloc.available() == 3  # all or nothing
    alloc.release(blocks)
    assert (alloc.used(), alloc.available()) == (0, 8)
    with pytest.raises(ValueError):
        alloc.release(blocks[:1])  # double free


@impls
def test_allocator_prefix_refcount_lru_and_pinning(impl):
    alloc = IMPLS[impl][1].BlockAllocator(3)  # 2 usable
    a, b = alloc.reserve(2)
    assert alloc.register(a, ("a",)) is True
    assert alloc.register(b, ("a",)) is False  # first writer wins
    alloc.register(b, ("b",))
    assert alloc.match_prefix([("a",)]) == [a]  # shared: refcount 2
    alloc.release([a])
    assert alloc.used() == 2
    alloc.release([a])
    alloc.release([b])
    assert (alloc.used(), alloc.cached()) == (0, 2)
    assert alloc.peek_cached([("a",), ("b",)], 2) == 2
    assert alloc.match_prefix([("b",)]) == [b]  # pinned out of eviction
    [evicted] = alloc.reserve(1)
    assert evicted == a  # the oldest cached-free block
    assert alloc.peek_prefix([("a",)]) == 0  # its prefix entry is gone
    assert alloc.peek_prefix([("b",), ("c",), ("a",)]) == 1
    with pytest.raises(ValueError):
        alloc.register(99, ("x",))  # unpinned


@impls
def test_block_len_and_buckets(impl):
    kv = IMPLS[impl][1]
    assert [kv.default_block_len(c) for c in (32, 8, 24, 7)] == [16, 8, 12, 7]
    assert kv.bucket_for(9, 8, 48) == 16
    with pytest.raises(ValueError):
        kv.bucket_for(49, 8, 48)


def test_prefix_keys_equal_the_jax_package_and_cover_full_blocks():
    cfg = llama.LlamaConfig(vocab_size=32, dim=16, n_layers=1, n_heads=2,
                            n_kv_heads=1, intermediate=32,
                            dtype=torch.float32)
    jcfg = jax_llama.LlamaConfig(vocab_size=32, dim=16, n_layers=1,
                                 n_heads=2, n_kv_heads=1, intermediate=32,
                                 dtype=jnp.float32)
    cache = kv_slots.PagedKVCache(cfg, 8, 8, 64, 8, device="cpu")
    jcache = jax_kv_slots.PagedKVCache(jcfg, 8, 8, 64, 8)
    prompt = list(range(20))
    keys = cache.prefix_keys(prompt)
    assert len(keys) == 2 and keys == jcache.prefix_keys(prompt)
    assert cache.prefix_keys([99] + prompt[1:])[1] != keys[1]
    assert cache.max_blocks == 8 and cache.blocks_for(9) == 2
    assert cache.pool["k"].shape == (1, 8, 1, 8, 8)
    assert cache.nbytes() == 2 * 8 * 8 * 8 * 4
    for bad in [(8, 16, 64, 8), (8, 8, 60, 8)]:
        with pytest.raises(ValueError):
            kv_slots.PagedKVCache(cfg, *bad, device="cpu")


# ---------------------------------------------------------------------
# the engine on a tiny model
# ---------------------------------------------------------------------

KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
          intermediate=128, max_seq_len=128)
ENGINE_KW = dict(slots=2, max_len=48, prefill_chunk=8)


def _pair(seed):
    """(JAX params, port model) with the same weights."""
    jcfg = jax_llama.LlamaConfig(dtype=jnp.float32, attention="reference",
                                 **KW)
    cfg = llama.LlamaConfig(dtype=torch.float32, attention="reference",
                            remat=False, **KW)
    tree = jax.tree.map(np.asarray,
                        jax_llama.init_params(jax.random.PRNGKey(seed), jcfg))
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, model


@pytest.fixture(scope="module")
def tiny():
    return _pair(0)


def _engine(tiny, **kw):
    cfg, model = tiny[2], tiny[3]
    opts = dict(ENGINE_KW, max_new_tokens=8)
    opts.update(kw)
    return InferenceEngine(model, cfg, EngineConfig(**opts), family="tiny")


@pytest.fixture
def engine(tiny):
    eng = _engine(tiny)
    yield eng
    eng.close()


def _port_generate(tiny, prompt, n=8):
    cfg = tiny[2]
    toks, _ = gen.generate(tiny[3], np.asarray([prompt]),
                           np.asarray([len(prompt)]), cfg, max_new_tokens=n)
    return toks[0].tolist()


def _jax_generate(tiny, prompt, n=8, params=None):
    jcfg = tiny[0]
    toks, _ = jax_gen.generate(params or tiny[1], jnp.asarray([prompt]),
                               jnp.asarray([len(prompt)]), jcfg,
                               max_new_tokens=n, temperature=0.0)
    return np.asarray(toks)[0].tolist()


def test_engine_matches_generate_greedy(tiny, engine):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 128, size=n).tolist() for n in (5, 8, 11)]
    streams = [engine.submit(p, max_new_tokens=8) for p in prompts]
    outs = [list(s) for s in streams]
    assert [s.finish_reason for s in streams] == ["length"] * 3
    for prompt, out in zip(prompts, outs):
        assert out == _port_generate(tiny, prompt) == _jax_generate(tiny, prompt)
    stats = engine.stats()
    assert stats["tokens_emitted"] == 24 and stats["requests_done"] == 3
    assert sum(r["steps"] for r in stats["decode_by_batch"].values()) == \
        stats["steps"]
    assert stats["prefill_tokens"] == 8 * stats["prefill_chunks"]


def test_prefix_hit_parity_with_generate(tiny):
    eng = _engine(tiny, prefix_cache=True)
    try:
        rng = np.random.default_rng(21)
        base = rng.integers(1, 128, size=20).tolist()
        prompts = [base, list(base),
                   base[:16] + rng.integers(1, 128, size=5).tolist()]
        outs = []
        for prompt in prompts:
            stream = eng.submit(prompt, max_new_tokens=8)
            outs.append(list(stream))
            assert stream.finish_reason == "length"
        stats = eng.stats()
        assert stats["prefix_misses"] >= 1
        assert stats["prefix_hits"] == 2
        assert stats["prefix_tokens_saved"] == 32
        for prompt, out in zip(prompts, outs):
            assert out == _jax_generate(tiny, prompt)
    finally:
        eng.close()


def test_midprefill_row_not_corrupted_by_interleaved_decode(tiny):
    """While a request chunk-prefills, its table is built but its row is
    not yet alive: the interleaved decode over the full slot batch must
    not scatter that row's junk into the request's pages."""
    eng = _engine(tiny, prefix_cache=False)
    try:
        busy = eng.submit([9, 9, 9, 9], max_new_tokens=30)
        assert isinstance(next(busy), int)
        prompt = np.random.default_rng(5).integers(1, 128, size=20).tolist()
        out = list(eng.submit(prompt, max_new_tokens=8))
        busy.cancel()
        list(busy)
        assert out == _jax_generate(tiny, prompt)
    finally:
        eng.close()


def test_engine_eos_stops_row(tiny, engine):
    prompt = [3, 14, 15, 9]
    ref = _port_generate(tiny, prompt)
    stream = engine.submit(prompt, max_new_tokens=8, eos_token=ref[2])
    out = list(stream)
    assert stream.finish_reason == "stop"
    assert out == ref[:ref.index(ref[2]) + 1]


def test_slot_reuse_and_fifo_admission(engine):
    """Both slots busy; a long-prompt request queued ahead of short ones
    gets its first token first, and it reuses a vacated slot. The order
    is read from the engine's own record of each request's first token
    (stamped by its step thread as it emits the token), not from the
    consumers' clocks: a consumer thread can be scheduled late."""
    busy = [engine.submit([1 + i, 2, 3, 4], max_new_tokens=12)
            for i in range(2)]
    long_req = engine.submit(list(range(1, 21)), max_new_tokens=4)
    shorts = [engine.submit([40 + i, 41, 42, 43], max_new_tokens=4)
              for i in range(2)]
    streams = {"b0": busy[0], "b1": busy[1], "long": long_req,
               "s0": shorts[0], "s1": shorts[1]}
    got = {}

    def consume(tag, stream):
        got[tag] = list(stream)

    threads = [threading.Thread(target=consume, args=item, daemon=True)
               for item in streams.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert {tag for tag, out in got.items() if out} == set(streams)
    first_token_at = {tag: s._req.first_token_ts
                      for tag, s in streams.items()}
    assert first_token_at["long"] < min(first_token_at["s0"],
                                        first_token_at["s1"])
    assert long_req._req.slot in (busy[0]._req.slot, busy[1]._req.slot)
    stats = engine.stats()
    assert (stats["slots_used"], stats["waiting"]) == (0, 0)


def _wait_for(predicate, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _gate_decode(monkeypatch, eng):
    """Meter the engine's decode steps: `steps["left"]` None runs them
    freely, a count lets that many more run, 0 holds every decode
    (admission and prefill go on). A stream then stays running, or
    queued, for as long as the test needs it to, however the threads
    are scheduled."""
    steps = {"left": None}
    decode = eng._decode

    def gated():
        if steps["left"] is None:
            return decode()
        if steps["left"] <= 0:
            return False
        steps["left"] -= 1
        return decode()

    monkeypatch.setattr(eng, "_decode", gated)
    return steps


def test_cancel_during_decode_during_prefill_and_while_waiting(
        engine, monkeypatch):
    # Under load the test thread can lose the CPU between a stream's
    # first token and its cancel, or before it sees both busy streams
    # admitted, for as long as the tiny model takes to decode them all:
    # the engine then finished a stream the test meant to cancel
    # running or waiting. The decode is metered where that matters.
    steps = _gate_decode(monkeypatch, engine)
    steps["left"] = 1  # the first token, then hold
    stream = engine.submit([7, 7, 7, 7], max_new_tokens=32)
    assert isinstance(next(stream), int)
    stream.cancel()
    rest = list(stream)
    assert stream.finish_reason == "cancelled" and 1 + len(rest) < 32
    assert _wait_for(lambda: engine.stats()["slots_used"] == 0)
    steps["left"] = None
    # Cancels landing in the prefill window free the slot exactly once.
    for attempt in range(5):
        stream = engine.submit(list(range(1, 21)), max_new_tokens=4)
        time.sleep(0.002 * attempt)
        stream.cancel()
        list(stream)
        assert stream.finish_reason in ("cancelled", "length")
    steps["left"] = 0  # the busy streams hold both slots
    busy = [engine.submit([1, 2, 3, 4], max_new_tokens=24) for _ in range(2)]
    queued = engine.submit([9, 9, 9, 9], max_new_tokens=4)
    assert _wait_for(lambda: engine.stats()["slots_used"] == 2)
    queued.cancel()
    assert list(queued) == [] and queued.finish_reason == "cancelled"
    for s in busy:
        s.cancel()
        list(s)
    steps["left"] = None
    assert len(list(engine.submit([2, 4, 6, 8], max_new_tokens=4))) == 4
    assert engine.stats()["dead"] is False


def test_overload_and_pool_oom_shed(tiny, monkeypatch):
    eng = _engine(tiny, max_waiting=1, kv_blocks=7, max_len=64)
    # The two busy streams must hold both slots through the submits below
    # however fast the tiny model decodes (a 20-token stream can finish
    # between them on an idle CPU, or while a loaded one starves the test
    # thread): the engine admits and prefills them, and decodes nothing.
    monkeypatch.setattr(eng, "_decode", lambda: False)
    try:
        # 29-token prompt + 24 budget: 7 blocks, the pool holds 6.
        with pytest.raises(EngineOverloaded):
            eng.submit(list(range(1, 30)), max_new_tokens=24)
        busy = []
        for n in range(2):
            busy.append(eng.submit([1 + n, 2, 3, 4], max_new_tokens=20))
            assert _wait_for(lambda: eng.stats()["slots_used"] == n + 1)
        eng.submit([5, 5, 5, 5])  # fills the 1-deep waiting queue
        with pytest.raises(EngineOverloaded):
            eng.submit([6, 6, 6, 6])
        for s in busy:
            s.cancel()
        assert eng.stats()["dead"] is False
    finally:
        eng.close()


def test_block_starved_admission_waits_then_serves(tiny):
    eng = _engine(tiny, kv_blocks=7, prefix_cache=False)
    try:
        # Each needs 4 of the 6 usable blocks: the second waits.
        first = eng.submit(list(range(1, 17)), max_new_tokens=16)
        second = eng.submit(list(range(101, 117)), max_new_tokens=16)
        assert len(list(first)) == len(list(second)) == 16
        stats = eng.stats()
        assert not stats["dead"] and stats["kv_blocks_used"] == 0
        assert stats["kv_block_len"] == 8 and stats["kv_blocks_total"] == 6
    finally:
        eng.close()


def test_engine_death_fails_every_stream(tiny):
    eng = _engine(tiny)
    live = eng.submit([1, 2, 3, 4])
    assert len(list(live)) == 8
    busy = eng.submit([3, 3, 3], max_new_tokens=30)
    assert isinstance(next(busy), int)
    eng.cfg = None  # corrupt what the loop's next step reads
    doomed = eng.submit([5, 6, 7, 8])
    for stream in (busy, doomed):
        with pytest.raises(EngineDead):
            list(stream)
    assert _wait_for(lambda: eng.stats()["dead"])
    with pytest.raises(EngineDead):
        eng.submit([1, 2, 3])
    eng.close()


def test_weight_push_mid_decode_token_exact(tiny):
    """A push lands while a stream decodes: it finishes token-exact on
    the old weights, a stream admitted after the push is token-exact on
    the new ones, both decode through the mixed-generation window, and
    the old generation is dropped once its last request retires."""
    new = _pair(99)
    eng = _engine(tiny, max_new_tokens=16)
    try:
        prompt = np.random.default_rng(3).integers(1, 128, size=6).tolist()
        stream_old = eng.submit(prompt, max_new_tokens=16)
        it = iter(stream_old)
        out_old = [next(it), next(it)]
        assert eng.update_weights(new[3]) == 1
        stream_new = eng.submit(prompt, max_new_tokens=16)
        out_old.extend(it)
        out_new = list(stream_new)
        assert stream_old.finish_reason == stream_new.finish_reason == "length"
        assert out_old == _jax_generate(tiny, prompt, 16)
        assert out_new == _jax_generate(new, prompt, 16, params=new[1])
        stats = eng.stats()
        assert (stats["weight_version"], stats["weight_gens"],
                stats["requests_done"]) == (1, 1, 2)
        assert eng.update_weights(tiny[3], version=5) == 5
        with pytest.raises(ValueError):
            eng.update_weights(new[3], version=5)
    finally:
        eng.close()


class LinearPolicy(BatchProgram):
    buckets = (4, 8, 16)

    def run(self, params, inputs, generator):
        logits = params(inputs)
        u = torch.rand(logits.shape, generator=generator)
        return {"actions": torch.argmax(logits - torch.log(-torch.log(u)), -1),
                "values": logits.sum(-1)}


def test_policy_requests_batch_into_one_forward(monkeypatch):
    torch.manual_seed(0)
    policy = torch.nn.Linear(4, 3)
    eng = InferenceEngine(policy, None, EngineConfig(), family="policy",
                          program=LinearPolicy())
    # Nothing is served until all 12 requests are pending, however slowly
    # their threads start (on a loaded CPU each could be served alone):
    # then they must share fewer than 12 forwards.
    release = threading.Event()
    serve = eng._policy_step
    monkeypatch.setattr(eng, "_policy_step",
                        lambda: release.is_set() and serve())
    try:
        results = {}
        # Each worker reports its submit done; the wait below is for all
        # 12, however slowly the threads are scheduled (no clock bound
        # but a generous guard against a hang).
        submitted = [threading.Event() for _ in range(12)]

        def worker(i, rows):
            obs = np.full((rows, 4), float(i), np.float32)
            ticket = eng.submit_policy(obs)
            submitted[i].set()
            results[i] = (obs, ticket.result(timeout=60))

        threads = [threading.Thread(target=worker, args=(i, 1 + i % 3))
                   for i in range(12)]
        for t in threads:
            t.start()
        rows = sum(1 + i % 3 for i in range(12))
        assert all(e.wait(timeout=120) for e in submitted)
        assert eng.stats()["policy_pending_rows"] == rows
        release.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 12
        with torch.no_grad():
            for obs, out in results.values():
                want = policy(torch.from_numpy(obs)).sum(-1).numpy()
                np.testing.assert_allclose(out["values"], want, rtol=1e-6)
                assert out["actions"].shape == (len(obs),)
        stats = eng.stats()
        assert stats["policy_rows_served"] == sum(1 + i % 3 for i in range(12))
        assert stats["policy_steps"] < 12
        with pytest.raises(ValueError):
            eng.submit_policy(np.zeros((17, 4), np.float32))

        def boom(params, inputs, generator):
            raise RuntimeError("injected program failure")

        eng._program.run = boom
        with pytest.raises(EngineDead):
            eng.submit_policy(np.zeros((2, 4), np.float32)).result(timeout=30)
        assert _wait_for(lambda: eng.stats()["dead"])
        with pytest.raises(EngineDead):
            eng.submit_policy(np.zeros((1, 4), np.float32))
    finally:
        eng.close()
