"""The port's LLM deployment (`ray_tpu_torch.llm.serving`) on the CPU,
held to the JAX package's (`ray_tpu.llm.serving`):

* the same greedy token streams from one local random-init HF
  checkpoint, on the engine path and on the kill switch, with a prompt
  that is not a bucket multiple and one that hits the prefix cache;
* mirrors of the serving tests of `tests/test_llm_engine.py` and of
  every test of `tests/test_llm_serving.py`, with the same assertions;
* `build_llm_app` over the port's runtime, whose tokens over the
  handle and over HTTP equal the port's `generate`, and whose engine
  frees the slot of an abandoned HTTP stream;
* the same `serve_engine_*` series and tag keys from both engines for
  the same traffic.

Deployments run on the port's runtime (`ray_tpu_torch.init`) with
`device="cpu"`; a replica asked for the card on a process without one
fails its request."""

import http.client
import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
import ray_tpu_torch.serve as serve
from ray_tpu.llm import serving as jax_serving
from ray_tpu_torch.llm import EngineConfig, InferenceEngine, serving
from ray_tpu_torch.llm.serving import LLMServer, build_llm_app, build_model
from ray_tpu_torch.models import generate as gen

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

ENGINE_KW = dict(slots=2, max_len=48, prefill_chunk=8)
TINY = {
    "vocab_size": 128, "dim": 64, "n_layers": 2, "n_heads": 4,
    "n_kv_heads": 2, "intermediate": 128, "max_seq_len": 128,
    "dtype": "float32",
}
TINY_SPEC = {"kind": "init", "seed": 0, "config": TINY}


def _tokens(chunks):
    """A served stream's chunks -> token ids (one decimal id each)."""
    out = []
    for chunk in chunks:
        text = chunk.decode() if isinstance(chunk, bytes) else chunk
        assert text.endswith(" ") and text[:-1].isdigit(), text
        out.append(int(text))
    return out


def _generate(model, cfg, prompt, max_new):
    out, _ = gen.generate(model, torch.tensor([prompt]),
                          torch.tensor([len(prompt)]), cfg,
                          max_new_tokens=max_new)
    return out[0].tolist()


def _close_engines(server):
    wrapper = getattr(server, "__serve_multiplex_get_engine")
    for engine in wrapper.models().values():
        engine.close()


@pytest.fixture(scope="module")
def hf_ckpt(tmp_path_factory):
    """A tiny f32 GQA Llama, random init, saved as a local checkpoint."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(3)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False,
        attn_implementation="eager",
    )).eval()
    path = tmp_path_factory.mktemp("hf") / "tiny_gqa"
    hf.save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def cluster():
    """The port's runtime, shared by the module's deployment tests;
    no worker may crash at startup."""
    rt.init(num_cpus=4)
    try:
        yield rt
        assert rt.api._session.daemon._spawn_crash_total == 0
    finally:
        rt.shutdown()


@pytest.fixture
def app_session(cluster):
    yield cluster
    serve.shutdown()


# ---------------------------------------------------------------------
# the port's LLMServer against the JAX package's, from one checkpoint
# ---------------------------------------------------------------------

@pytest.mark.parametrize("engine_enabled", [True, False],
                         ids=["engine", "kill_switch"])
def test_llm_server_streams_equal_the_jax_package(hf_ckpt, engine_enabled):
    rng = np.random.default_rng(5)
    system = rng.integers(1, 128, 19).tolist()
    prompts = [
        [3, 99, 41, 7, 58],  # 5 tokens: not a bucket multiple
        system + [11, 12],
        system + [13, 14, 15],  # shares 2 full blocks of 8: a prefix hit
        rng.integers(1, 128, 16).tolist(),  # exactly two buckets
    ]
    spec = {"kind": "hf", "path": hf_ckpt}
    engine = dict(max_new_tokens=8, **ENGINE_KW)
    ours = LLMServer({"tiny": spec}, engine=engine,
                     engine_enabled=engine_enabled, device="cpu")
    theirs = jax_serving.LLMServer({"tiny": spec}, engine=engine,
                                   engine_enabled=engine_enabled)
    for prompt in prompts:
        request = {"prompt": prompt, "max_new_tokens": 8}
        got = _tokens(ours(request))
        want = _tokens(theirs(request))
        assert len(got) == 8
        assert got == want, (prompt, got, want)
    if engine_enabled:
        assert ours.engine_stats()["tiny"]["prefix_hits"] >= 1
        for server in (ours, theirs):
            _close_engines(server)


def test_replica_asked_for_the_card_without_one_fails():
    """No fallback hides the card: a server on "cuda" in a process that
    sees none raises on its first request, and the app asks one card
    per replica."""
    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA device")
    server = LLMServer({"tiny": TINY_SPEC}, engine=dict(ENGINE_KW))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(server({"prompt": [1, 2, 3]}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(TINY_SPEC)
    on_card = build_llm_app({"tiny": TINY_SPEC})
    assert on_card.deployment.ray_actor_options == {"num_gpus": 1}
    assert on_card.kwargs["device"] == "cuda"
    on_cpu = build_llm_app({"tiny": TINY_SPEC}, device="cpu")
    assert on_cpu.deployment.ray_actor_options == {}


def test_build_model_is_a_function_of_the_seed():
    a, cfg = build_model(TINY_SPEC, device="cpu")
    b, _ = build_model(dict(TINY_SPEC), device="cpu")
    c, _ = build_model(dict(TINY_SPEC, seed=1), device="cpu")
    assert cfg.dtype == torch.float32 and cfg.attention == "reference"
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if not name.endswith("norm"):
            assert not torch.equal(x, z), name


# ---------------------------------------------------------------------
# mirrors of tests/test_llm_engine.py's serving tests
# ---------------------------------------------------------------------

def test_fallback_padding_is_exact():
    """Kill-switch fallback (per-request generate_stream over a
    BUCKET-padded prompt) must emit the same greedy tokens as
    generate() on the unpadded prompt: generate_stream decodes from
    each row's TRUE length, so padding never enters attention."""
    model, cfg = build_model(TINY_SPEC, device="cpu")
    server = LLMServer(
        {"tiny": TINY_SPEC},
        engine=dict(max_new_tokens=8, **ENGINE_KW),
        engine_enabled=False,
        device="cpu",
    )
    prompt = [3, 99, 41, 7, 58]  # 5 tokens: NOT a bucket multiple
    out = [
        int(chunk)
        for chunk in b"".join(
            server({"prompt": prompt, "max_new_tokens": 8})
        ).split()
    ]
    assert out == _generate(model, cfg, prompt, 8)


def test_multiplex_swap_blocks_only_affected_family(monkeypatch):
    """Loading family B (slow) must not stall family A's decode loop:
    A's tokens keep arriving DURING B's load window. B's load lasts
    until A has delivered a token inside it (or 30 s)."""
    model, cfg = build_model(TINY_SPEC, device="cpu")
    spec_a = {"kind": "init", "seed": 0, "config": None}
    spec_b = {"kind": "init", "seed": 1, "config": None}

    load_window = {}
    a_started = threading.Event()
    a_during_load = threading.Event()

    def slow_build_model(spec, device="cuda"):
        if spec is spec_b:
            load_window["start"] = time.perf_counter()
            a_during_load.wait(timeout=30)  # a slow swap
            load_window["end"] = time.perf_counter()
        return model, cfg

    monkeypatch.setattr(serving, "build_model", slow_build_model)
    server = LLMServer(
        {"a": spec_a, "b": spec_b},
        engine=dict(max_new_tokens=40, **ENGINE_KW),
        device="cpu",
    )
    a_times = []
    b_done = threading.Event()

    def consume_a():
        for _chunk in server({"prompt": [1, 2, 3], "model": "a",
                              "max_new_tokens": 40}):
            a_times.append(time.perf_counter())
            a_started.set()
            if "start" in load_window:
                a_during_load.set()

    def consume_b():
        list(server({"prompt": [4, 5, 6], "model": "b",
                     "max_new_tokens": 4}))
        b_done.set()

    ta = threading.Thread(target=consume_a, daemon=True)
    ta.start()
    assert a_started.wait(timeout=60)  # family A is decoding
    tb = threading.Thread(target=consume_b, daemon=True)
    tb.start()
    ta.join(timeout=60)
    assert b_done.wait(timeout=60)
    during_load = [
        t for t in a_times
        if load_window["start"] <= t <= load_window["end"]
    ]
    assert during_load, (
        "family A produced no tokens while family B loaded - the "
        "swap blocked the wrong family"
    )


@pytest.mark.timeout(240)
def test_replica_death_fails_inflight_stream(app_session):
    rt_ = app_session
    try:
        handle = serve.run(
            build_llm_app(
                {"tiny": TINY_SPEC},
                # Big per-slot capacity: the in-flight stream must
                # still be decoding (900-token budget, seconds of
                # work) when the replica dies.
                engine={
                    "slots": 2, "max_len": 1024,
                    "prefill_chunk": 8, "max_new_tokens": 900,
                },
                max_ongoing_requests=8,
                device="cpu",
            ),
            name="llm-chaos",
            route_prefix=None,
        )
        warm = handle.options(stream=True).remote(
            {"prompt": [1, 2, 3], "max_new_tokens": 2}
        )
        assert len(list(warm)) == 2
        stream = handle.options(stream=True).remote(
            {"prompt": [5, 6, 7], "max_new_tokens": 900}
        )
        first = next(stream)
        assert first  # stream is live
        controller = rt_.get_actor(
            "SERVE_CONTROLLER", namespace="serve"
        )
        replicas = rt_.get(
            controller.get_replicas.remote("llm-chaos", "llm"),
            timeout=30,
        )
        assert replicas
        rt_.kill(replicas[0]["actor"])
        outcome = None
        deadline = time.time() + 120
        try:
            while time.time() < deadline:
                next(stream)
        except StopIteration:
            outcome = "clean_stop"
        except BaseException as e:  # noqa: BLE001 - the assertion
            outcome = repr(e)
        # The dead replica must surface as an ERROR within the
        # deadline - not a hang, and not a well-formed early stop
        # that hides the truncation.
        assert outcome not in (None, "clean_stop"), outcome
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------
# mirrors of tests/test_llm_serving.py
# ---------------------------------------------------------------------

def test_llm_deployment_with_batching(app_session):
    @serve.deployment
    class LlamaService:
        def __init__(self):
            import torch as torch_

            from ray_tpu_torch.models.llama import LlamaConfig, init_params

            self.cfg = LlamaConfig(
                vocab_size=128,
                dim=64,
                n_layers=2,
                n_heads=4,
                n_kv_heads=4,
                intermediate=128,
                max_seq_len=64,
                dtype=torch_.float32,
                attention="reference",
            )
            self.params = init_params(
                self.cfg, torch_.Generator().manual_seed(0), device="cpu")

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        def complete(self, prompts):
            """prompts: list of token-id lists (equal length); one
            generate serves the whole batch."""
            import torch as torch_

            from ray_tpu_torch.models.generate import generate

            batch = torch_.tensor(prompts)
            lengths = torch_.full((len(prompts),), batch.shape[1])
            out, out_lengths = generate(
                self.params,
                batch,
                lengths,
                self.cfg,
                max_new_tokens=6,
                temperature=0.0,
            )
            return [
                row[:n].tolist()
                for row, n in zip(out, out_lengths.tolist())
            ]

    try:
        handle = serve.run(
            LlamaService.bind(), name="llm", route_prefix=None
        )
        prompts = [[1 + i, 7, 12, 5] for i in range(6)]
        responses = [handle.complete.remote(p) for p in prompts]
        results = [r.result(timeout=120) for r in responses]
        assert len(results) == 6
        for tokens in results:
            assert len(tokens) == 6
            assert all(0 <= t < 128 for t in tokens)
        # Determinism: same prompt, same greedy completion.
        again = handle.complete.remote(prompts[0]).result(timeout=120)
        assert again == results[0]
    finally:
        serve.shutdown()


def _tiny_mha():
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig(
        vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
        intermediate=128, max_seq_len=64, dtype=torch.float32,
        attention="reference",
    )
    return init_params(cfg, torch.Generator().manual_seed(0),
                       device="cpu"), cfg


def test_llm_token_streaming(cluster):
    """Token streaming: an engine actor decodes with generate_stream
    and yields each step through a streaming generator - the consumer
    receives tokens while decoding is still running (transport:
    num_returns='streaming' + models/generate.generate_stream)."""

    @rt.remote
    class Engine:
        def __init__(self):
            from ray_tpu_torch.models.llama import LlamaConfig, init_params

            self.cfg = LlamaConfig(
                vocab_size=128, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=4, intermediate=128, max_seq_len=64,
                dtype=torch.float32, attention="reference",
            )
            self.params = init_params(
                self.cfg, torch.Generator().manual_seed(0), device="cpu")

        def stream(self, prompt, max_new_tokens):
            from ray_tpu_torch.models.generate import generate_stream

            batch = torch.tensor([prompt])
            lengths = torch.tensor([len(prompt)])
            for step_tokens in generate_stream(
                self.params, batch, lengths, self.cfg,
                max_new_tokens=max_new_tokens, temperature=0.0,
            ):
                yield int(step_tokens[0])

    engine = Engine.remote()
    stream = engine.stream.options(num_returns="streaming").remote(
        [1, 7, 12, 5], 6
    )
    tokens = [rt.get(r, timeout=60) for r in stream]
    assert len(tokens) == 6
    assert all(0 <= t < 128 for t in tokens)

    # Greedy decode must match the batch path token-for-token.
    params, cfg = _tiny_mha()
    assert tokens == _generate(params, cfg, [1, 7, 12, 5], 6)
    rt.kill(engine)


def test_serve_converted_hf_checkpoint(app_session, tmp_path):
    """The full user story: an HF Llama checkpoint converts, deploys
    behind Serve, and the served greedy tokens are IDENTICAL to
    transformers.generate on the same weights."""
    pytest.importorskip("transformers")
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(9)
    hf = LlamaForCausalLM(HFConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, max_position_embeddings=64,
        tie_word_embeddings=False, attn_implementation="eager",
    ))
    hf.eval()
    ckpt = str(tmp_path / "tiny_llama")
    hf.save_pretrained(ckpt)

    prompt = np.random.default_rng(9).integers(
        1, 128, (1, 10), dtype=np.int64
    )
    with torch.no_grad():
        expected = hf.generate(
            torch.from_numpy(prompt), max_new_tokens=6,
            do_sample=False, pad_token_id=0, eos_token_id=None,
        )[:, prompt.shape[1]:].numpy().tolist()

    @serve.deployment
    class Checkpoint:
        def __init__(self, path):
            from ray_tpu_torch.models.hf_convert import load_hf_llama

            self.params, self.cfg = load_hf_llama(path, device="cpu")

        def complete(self, tokens):
            import torch as torch_

            from ray_tpu_torch.models.generate import generate

            batch = torch_.tensor([tokens])
            out, _ = generate(
                self.params, batch,
                torch_.full((1,), batch.shape[1]),
                self.cfg, max_new_tokens=6, temperature=0.0,
            )
            return out[0].tolist()

    try:
        handle = serve.run(
            Checkpoint.bind(ckpt), name="hf-llm", route_prefix=None
        )
        served = handle.complete.remote(
            prompt[0].tolist()
        ).result(timeout=120)
        assert [served] == expected
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------
# build_llm_app over the port's runtime
# ---------------------------------------------------------------------

def _post_stream(port, body, route="/llm"):
    """POST `body` and read the chunked response to its end."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.headers.get("Transfer-Encoding") == "chunked"
        return resp.read().decode()


@pytest.mark.parametrize("engine_enabled", [True, False],
                         ids=["engine", "kill_switch"])
def test_llm_app_over_handle_and_http_equals_generate(app_session,
                                                      engine_enabled):
    model, cfg = build_model(TINY_SPEC, device="cpu")
    rng = np.random.default_rng(7)
    system = rng.integers(0, 128, 16).tolist()
    prompts = [system + [5, 6, 7], system + [9], [4, 8, 15, 16, 23]]
    try:
        serve.run(
            build_llm_app({"tiny": TINY_SPEC},
                          engine=dict(max_new_tokens=8, **ENGINE_KW),
                          engine_enabled=engine_enabled, device="cpu"),
            name="llm-app", route_prefix="/llm")
        port = serve.start(http_port=0, per_node=False)
        handle = serve.get_app_handle("llm-app")
        for prompt in prompts:
            want = _generate(model, cfg, prompt, 8)
            body = {"prompt": prompt, "max_new_tokens": 8}
            over_handle = _tokens(handle.options(stream=True).remote(body))
            assert over_handle == want, (prompt, over_handle, want)
            text = _post_stream(port, body)
            assert [int(t) for t in text.split()] == want
            assert text == "".join(f"{t} " for t in want)
        stats = handle.engine_stats.remote().result(timeout=30)
        if engine_enabled:
            assert stats["tiny"]["prefix_hits"] >= 1, stats
            assert stats["tiny"]["requests_done"] == 2 * len(prompts)
        else:
            assert stats == {}
    finally:
        serve.shutdown()


def test_abandoned_http_stream_frees_its_engine_slot(app_session):
    """A client that drops its HTTP stream mid-decode: the proxy closes
    the replica's generator, the engine cancels the request and frees
    its slot long before its budget is spent, and a later request is
    served."""
    budget = 4000
    try:
        serve.run(
            build_llm_app({"tiny": TINY_SPEC},
                          engine={"slots": 2, "max_len": 4096,
                                  "prefill_chunk": 8,
                                  "max_new_tokens": budget},
                          device="cpu"),
            name="llm-cancel", route_prefix="/llm")
        port = serve.start(http_port=0, per_node=False)
        handle = serve.get_app_handle("llm-cancel")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/llm", body=json.dumps(
            {"prompt": [1, 2, 3], "max_new_tokens": budget}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        first = resp.read(2)
        assert first  # the stream is live
        busy = handle.engine_stats.remote().result(timeout=30)["tiny"]
        assert busy["slots_used"] == 1, busy
        conn.close()  # abandoned mid-decode
        deadline = time.time() + 60
        stats = busy
        while time.time() < deadline and stats["slots_used"]:
            stats = handle.engine_stats.remote().result(timeout=30)["tiny"]
        assert stats["slots_used"] == 0, stats
        assert stats["requests_done"] == 1
        assert stats["tokens_emitted"] < budget, stats
        text = _post_stream(port, {"prompt": [4, 5], "max_new_tokens": 3})
        assert len(text.split()) == 3
    finally:
        serve.shutdown()


# ---------------------------------------------------------------------
# observability: the same series from both engines
# ---------------------------------------------------------------------

class _Records:
    """Stands in for a package's metric buffer: keeps every record."""

    def __init__(self):
        self.records = []

    def push(self, record):
        self.records.append(record)

    def series(self):
        """{serve_engine_* name: (kind, sorted tag keys)}."""
        out = {}
        for kind, name, _value, tags, *_ in self.records:
            if name.startswith("serve_engine_"):
                keys = tuple(sorted(k for k, _ in tags))
                assert out.setdefault(name, (kind, keys)) == (kind, keys)
        return out


def _traffic(engine, update):
    """A prefix hit, a cancel, a weight push and plain requests."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, 128, 16).tolist()
    streams = [engine.submit(system + [1, 2]),
               engine.submit(rng.integers(0, 128, 5).tolist())]
    for stream in streams:
        list(stream)
    list(engine.submit(system + [3]))
    doomed = engine.submit([7, 7, 7], max_new_tokens=30)
    next(doomed)
    doomed.cancel()
    list(doomed)
    update()
    list(engine.submit([9, 9]))


def test_engines_emit_the_same_serve_engine_series(monkeypatch):
    import ray_tpu.serve.observability as jax_obs
    import ray_tpu.util.metrics as jax_metrics
    from ray_tpu.llm import EngineConfig as JaxEngineConfig
    from ray_tpu.llm import InferenceEngine as JaxEngine
    from ray_tpu.models import llama as jax_llama
    from ray_tpu_torch.serve import observability as obs
    from ray_tpu_torch.util import metrics

    emitted = {}
    for name, obs_mod, metrics_mod in (("port", obs, metrics),
                                       ("jax", jax_obs, jax_metrics)):
        emitted[name] = _Records()
        monkeypatch.setattr(obs_mod, "_metrics", {})
        monkeypatch.setattr(metrics_mod._Buffer, "get",
                            staticmethod(lambda r=emitted[name]: r))
    tags = dict(family="tiny", app="app", deployment="llm")
    kw = dict(max_new_tokens=6, **ENGINE_KW)

    model, cfg = build_model(TINY_SPEC, device="cpu")
    engine = InferenceEngine(model, cfg, EngineConfig(**kw), **tags)
    try:
        _traffic(engine, lambda: engine.update_weights(model))
    finally:
        engine.close()
    jcfg = jax_llama.LlamaConfig(**dict(TINY, dtype=jnp.float32,
                                        attention="reference"))
    params = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    jengine = JaxEngine(params, jcfg, JaxEngineConfig(**kw), **tags)
    try:
        _traffic(jengine, lambda: jengine.update_weights(params))
    finally:
        jengine.close()
    port, theirs = emitted["port"].series(), emitted["jax"].series()
    assert port == theirs
    for name in ("serve_engine_decode_step_ms", "serve_engine_ttft_ms",
                 "serve_engine_prefill_chunk_ms",
                 "serve_engine_prefix_hits_total",
                 "serve_engine_prefix_misses_total",
                 "serve_engine_requests_total", "serve_engine_slots_used",
                 "serve_engine_weight_version"):
        assert name in port, sorted(port)
    assert {"app", "deployment", "family"} <= set(
        port["serve_engine_decode_step_ms"][1])
    reasons = {dict(tags)["outcome"] for _, name, _, tags, *_ in
               emitted["port"].records
               if name == "serve_engine_requests_total"}
    assert reasons == {"length", "cancelled"}
