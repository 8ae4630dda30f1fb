"""The port's decoupled RL dataflow on the CPU, mirroring
`tests/test_rl_dataflow.py`: the rollout-queue gates and the weight
store (the copies beside their JAX-package originals), the engine's
policy batch path (`PolicyProgram` held to the JAX package's on the
same weights), drainless weight pushes (token-exact in-flight streams,
in process and through the object store into an engine actor), and
chaos: a killed env runner never stalls the queue, a dead engine fails
fast with EngineDead, never a hang. Every learner and engine here runs
on the CPU (`device="cpu"`); the runners sample on the host, as the
reference's do."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.llm.engine import EngineConfig as JaxEngineConfig
from ray_tpu.llm.engine import InferenceEngine as JaxInferenceEngine
from ray_tpu.models import generate as jax_gen
from ray_tpu.models import llama as jax_llama
from ray_tpu.rl import dataflow as jax_dataflow
from ray_tpu.rl import models as jax_models
from ray_tpu.rl import rollout_queue as jax_rollout_queue
from ray_tpu.rl import weight_sync as jax_weight_sync
from ray_tpu_torch.llm import EngineConfig, EngineDead, InferenceEngine
from ray_tpu_torch.models import generate as gen
from ray_tpu_torch.models import llama
from ray_tpu_torch.rl import DQNConfig, PPOConfig
from ray_tpu_torch.rl import dataflow, models, rollout_queue, weight_sync

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

#: The policy forward: the same f32 products on both sides.
FWD_TOL = 1e-6

QUEUES = {"port": (rollout_queue, weight_sync),
          "jax": (jax_rollout_queue, jax_weight_sync)}
impls = pytest.mark.parametrize("impl", sorted(QUEUES))


@pytest.fixture
def rt_port():
    """A fresh session of the port's runtime per test."""
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def _wait_for(predicate, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


# ---------------------------------------------------------------------
# rollout queue gates (pure bookkeeping, no cluster)
# ---------------------------------------------------------------------

@impls
def test_rollout_queue_capacity_backpressure(impl):
    q = QUEUES[impl][0].RolloutQueue(capacity=2, max_weight_lag=4)
    meta = {"weight_version": 0, "env_steps": 8}
    assert q.put({"ref": ["a"]}, meta) == "ok"
    assert q.put({"ref": ["b"]}, meta) == "ok"
    assert q.put({"ref": ["c"]}, meta) == "full"  # learner behind
    assert q.depth() == 2
    got = q.get_batch(8)
    assert [f["item"]["ref"][0] for f in got] == ["a", "b"]  # FIFO
    assert q.put({"ref": ["c"]}, meta) == "ok"
    stats = q.stats()
    assert stats["rejected_full"] == 1
    assert stats["puts"] == 3
    assert stats["env_steps_in"] == 24


@impls
def test_rollout_queue_weight_lag_gates(impl):
    """A put too far behind the learner version is refused ("throttle"),
    and a fragment that aged while queued is dropped at get."""
    q = QUEUES[impl][0].RolloutQueue(capacity=8, max_weight_lag=1)
    assert q.put({"ref": ["v0"]}, {"weight_version": 0}) == "ok"
    q.set_learner_version(2)
    assert q.put({"ref": ["v0b"]}, {"weight_version": 0}) == "throttle"
    assert q.put({"ref": ["v2"]}, {"weight_version": 2}) == "ok"
    got = q.get_batch(8)
    assert [f["item"]["ref"][0] for f in got] == ["v2"]
    stats = q.stats()
    assert stats["dropped_stale"] == 1
    assert stats["rejected_stale"] == 1
    # Learner version is monotonic: a late lower set is a no-op.
    assert q.set_learner_version(1) == 2


@impls
def test_weight_store_versioning(impl):
    store = QUEUES[impl][1].WeightStore()
    assert store.latest_version() == 0
    assert store.get() == (0, None)
    assert store.publish(["ref1"], 1) == 1
    assert store.publish(["stale"], 1) == 1  # late retry ignored
    assert store.publish(["ref2"], 3) == 3
    version, item = store.get()
    assert (version, item) == (3, ["ref2"])
    assert store.stats()["publishes"] == 2


# ---------------------------------------------------------------------
# engine policy path (in-process, no cluster)
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def policy_tree():
    return jax.device_get(jax_models.init_policy_params(
        jax.random.PRNGKey(0), 4, 2))


def _policy_engine(tree, obs_size=4, **cfg_kw):
    return InferenceEngine(
        models.load_jax_policy_params(tree, device="cpu"),
        None,
        EngineConfig(**cfg_kw),
        family="rl-test",
        program=dataflow.PolicyProgram(obs_size),
    )


def test_policy_requests_batch_into_one_forward(policy_tree, monkeypatch):
    """Ragged concurrent submits coalesce: 12 threads' rows come back
    row-exact (each ticket gets its slice) in far fewer program steps
    than requests. Nothing is served until all 12 are pending, however
    slowly their threads start."""
    eng = _policy_engine(policy_tree)
    release = threading.Event()
    serve = eng._policy_step
    monkeypatch.setattr(eng, "_policy_step",
                        lambda: release.is_set() and serve())
    try:
        results = {}

        def worker(i, rows):
            obs = np.full((rows, 4), float(i), np.float32)
            ticket = eng.submit_policy(obs)
            results[i] = (obs, ticket.result(timeout=60))

        threads = [
            threading.Thread(target=worker, args=(i, 1 + i % 3))
            for i in range(12)
        ]
        for t in threads:
            t.start()
        rows = sum(1 + i % 3 for i in range(12))
        assert _wait_for(
            lambda: eng.stats()["policy_pending_rows"] == rows, 60)
        release.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 12
        for i, (obs, out) in results.items():
            n = len(obs)
            assert out["actions"].shape == (n,)
            assert out["logp"].shape == (n,)
            assert out["values"].shape == (n,)
            assert np.isfinite(out["logp"]).all()
            _, want = jax_models.apply_policy(policy_tree, obs)
            np.testing.assert_allclose(out["values"], np.asarray(want),
                                       rtol=FWD_TOL, atol=FWD_TOL)
        stats = eng.stats()
        assert stats["policy_rows_served"] == rows
        assert stats["policy_steps"] < 12  # batching happened
        assert sum(k * v for k, v in
                   stats["policy_requests_per_step"].items()) == 12
    finally:
        eng.close()


def test_policy_reply_matches_local_program_and_the_jax_program(
        policy_tree):
    """Engine-served and runner-local inference run the same batch
    program: identical params + obs -> identical deterministic heads, and
    those of the JAX package's program on the same weights."""
    eng = _policy_engine(policy_tree)
    try:
        obs = np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4)
        ticket = eng.submit_policy(obs)
        out = ticket.result(timeout=30)
        assert ticket.version == 0
        program = dataflow.PolicyProgram(4)
        local = program.run(models.load_jax_policy_params(policy_tree, "cpu"),
                            torch.from_numpy(obs), torch.Generator())
        np.testing.assert_array_equal(out["greedy"],
                                      local["greedy"].numpy())
        np.testing.assert_allclose(out["values"], local["values"].numpy(),
                                   rtol=FWD_TOL)
        ref = jax_dataflow.PolicyProgram(4).run(
            policy_tree, obs, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(out["greedy"], np.asarray(ref["greedy"]))
        np.testing.assert_allclose(out["values"], np.asarray(ref["values"]),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        # The sampled head: each action's logp is log_softmax at it.
        logits, _ = models.apply_policy(policy_tree, obs)
        want = torch.log_softmax(logits, -1).numpy()[
            np.arange(2), out["actions"]]
        np.testing.assert_allclose(out["logp"], want, rtol=FWD_TOL,
                                   atol=FWD_TOL)
    finally:
        eng.close()


def test_engine_death_fails_policy_requests_fast(policy_tree):
    """Pending policy tickets get EngineDead when the loop dies, within
    seconds, and later submits are refused."""
    eng = _policy_engine(policy_tree)

    def boom(params, inputs, generator):
        raise RuntimeError("injected program failure")

    eng._program.run = boom
    ticket = eng.submit_policy(np.zeros((2, 4), np.float32))
    t0 = time.monotonic()
    with pytest.raises((EngineDead, RuntimeError)):
        ticket.result(timeout=30)
    assert time.monotonic() - t0 < 10  # fast, not a timeout crawl
    assert _wait_for(lambda: eng.stats()["dead"], 10)
    with pytest.raises(EngineDead):
        eng.submit_policy(np.zeros((1, 4), np.float32))


def test_policy_path_serves_through_weight_pushes(policy_tree):
    """Continuous submits from a side thread while weights are pushed
    repeatedly: every ticket succeeds and observed versions are
    monotonic."""
    eng = _policy_engine(policy_tree)
    try:
        errors = []
        versions = []
        stop = threading.Event()

        def submitter():
            while not stop.is_set():
                try:
                    ticket = eng.submit_policy(np.zeros((2, 4), np.float32))
                    ticket.result(timeout=30)
                    versions.append(ticket.version)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    return

        thread = threading.Thread(target=submitter)
        thread.start()
        for v in range(1, 4):
            eng.update_weights(
                models.load_jax_policy_params(jax.device_get(
                    jax_models.init_policy_params(jax.random.PRNGKey(v), 4,
                                                  2)), "cpu"),
                version=v,
            )
            # Wait until a ticket is served at >= v before the next push,
            # so every generation demonstrably served traffic.
            assert _wait_for(lambda: bool(errors) or (
                bool(versions) and versions[-1] >= v))
        stop.set()
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert not errors, errors
        assert versions, "no policy requests served"
        assert versions == sorted(versions)  # monotonic
        assert versions[-1] >= 1  # pushes actually took effect
    finally:
        eng.close()


def test_policy_engine_actor_serves_the_learners_weights(policy_tree):
    """`PolicyEngineActor` (its body, in process, on the CPU) takes the
    learner's tree at start and on every push, and replies with the
    version that computed each answer."""
    actor = dataflow.PolicyEngineActor(policy_tree, 4, device="cpu")
    try:
        obs = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
        out = actor.act(obs)
        _, want = jax_models.apply_policy(policy_tree, obs)
        np.testing.assert_allclose(out["values"], np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        assert out["weight_version"] == 0
        other = jax.device_get(jax_models.init_policy_params(
            jax.random.PRNGKey(9), 4, 2))
        assert actor.update_weights(other, version=3) == 3
        out = actor.act(obs)
        _, want = jax_models.apply_policy(other, obs)
        np.testing.assert_allclose(out["values"], np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        assert out["weight_version"] == 3
        assert actor.stats()["weight_version"] == 3
    finally:
        actor.die()


# ---------------------------------------------------------------------
# drainless weight sync on the LLM path
# ---------------------------------------------------------------------

KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
          intermediate=128, max_seq_len=128)


@pytest.fixture(scope="module")
def tiny_llm():
    """(JAX config, old and new JAX params, port config, old and new port
    models): the same two weight sets on both sides."""
    jcfg = jax_llama.LlamaConfig(dtype=jnp.float32, attention="reference",
                                 **KW)
    cfg = llama.LlamaConfig(dtype=torch.float32, attention="reference",
                            remat=False, **KW)
    out = [jcfg]
    models_ = []
    for seed in (0, 99):
        tree = jax.tree.map(np.asarray, jax_llama.init_params(
            jax.random.PRNGKey(seed), jcfg))
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict(llama.load_jax_params(tree, cfg))
        out.append(jax.tree.map(jnp.asarray, tree))
        models_.append(model)
    return (*out, cfg, *models_)


def test_weight_push_mid_decode_token_exact(tiny_llm):
    """A push lands while a stream decodes: the in-flight stream finishes
    token-exact on the old weights, a stream admitted after the push is
    token-exact on the new ones (the port's `generate` and the JAX
    package's), both decode through the mixed-generation window, and the
    old generation is dropped once its last request retires."""
    jcfg, j_old, j_new, cfg, p_old, p_new = tiny_llm
    eng = InferenceEngine(
        p_old, cfg,
        EngineConfig(slots=2, max_len=48, prefill_chunk=8,
                     max_new_tokens=16),
        family="drainless",
    )
    try:
        rng = np.random.default_rng(3)
        prompt = rng.integers(1, 128, size=6).tolist()
        stream_old = eng.submit(prompt, max_new_tokens=16)
        it = iter(stream_old)
        out_old = [next(it), next(it)]  # provably mid-decode
        assert eng.update_weights(p_new) == 1
        stream_new = eng.submit(prompt, max_new_tokens=16)
        out_old.extend(it)  # finishes while stream_new decodes
        out_new = list(stream_new)
        assert stream_old.finish_reason == "length"  # no error/shed
        assert stream_new.finish_reason == "length"

        def ref(model, params):
            toks, _ = gen.generate(model, np.asarray([prompt]),
                                   np.asarray([len(prompt)]), cfg,
                                   max_new_tokens=16)
            jtoks, _ = jax_gen.generate(
                params, jnp.asarray([prompt], jnp.int32),
                jnp.asarray([len(prompt)], jnp.int32), jcfg,
                max_new_tokens=16, temperature=0.0)
            assert toks[0].tolist() == np.asarray(jtoks)[0].tolist()
            return toks[0].tolist()

        assert out_old == ref(p_old, j_old)  # token-exact on OLD weights
        assert out_new == ref(p_new, j_new)  # next admission on NEW
        stats = eng.stats()
        assert stats["weight_version"] == 1
        assert stats["weight_gens"] == 1  # old generation dropped
        assert stats["requests_done"] == 2
    finally:
        eng.close()


def test_weight_push_rejects_stale_version(tiny_llm):
    _, _, _, cfg, p_old, p_new = tiny_llm
    eng = InferenceEngine(
        p_old, cfg, EngineConfig(slots=1, max_len=48, prefill_chunk=8),
        family="ver",
    )
    try:
        assert eng.update_weights(p_new, version=5) == 5
        with pytest.raises(ValueError):
            eng.update_weights(p_old, version=5)
    finally:
        eng.close()
    # The JAX package's engine refuses the same push.
    jcfg, j_old, j_new = tiny_llm[:3]
    jeng = JaxInferenceEngine(
        j_old, jcfg, JaxEngineConfig(slots=1, max_len=48, prefill_chunk=8),
        family="ver")
    try:
        assert jeng.update_weights(j_new, version=5) == 5
        with pytest.raises(ValueError):
            jeng.update_weights(j_old, version=5)
    finally:
        jeng.close()


def test_push_weights_through_the_store_into_an_engine_actor():
    """`chip_smoke.py` (i4) at a tiny f32 width on the CPU: an engine in
    an actor decodes 8 streams from weights A, `push_weights` sends B's
    state dict through the object store mid-decode (A still pinned when
    B is installed), 8 streams admitted after it decode on B; every old
    stream's tokens equal `generate` on A, every new one's on B, and the
    engine ends on one generation."""
    import chip_smoke

    cfg = llama.LlamaConfig(dtype=torch.float32, remat=False,
                            **dict(KW, max_seq_len=1024))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 128, size=8).tolist() for _ in range(8)]
    new_prompts = [rng.integers(1, 128, size=8).tolist() for _ in range(8)]
    a, b, outs_old, outs_new, record = chip_smoke.rl_push_run(
        torch, llama, cfg, torch.device("cpu"), prompts, new_prompts,
        old_budget=600, new_budget=16, store_bytes=256 << 20)
    assert record["push_bytes"] == sum(
        t.numel() * 4 for t in b.state_dict().values())
    assert record["at_push"]["weight_gens"] == 2
    assert record["weight_gens_after"] == 1

    def generate(model, ps, n):
        toks, _ = gen.generate(model, np.asarray(ps),
                               np.asarray([len(p) for p in ps]), cfg,
                               max_new_tokens=n)
        return toks.tolist()

    want_old = generate(a, prompts, max(len(o) for o in outs_old))
    for out, want in zip(outs_old, want_old):
        assert out == want[:len(out)]
    assert outs_new == generate(b, new_prompts, 16)
    assert outs_new != generate(a, new_prompts, 16)


# ---------------------------------------------------------------------
# live dataflow chaos (the port's runtime)
# ---------------------------------------------------------------------

def _small_flow(policy, **kw):
    knobs = dict(queue_capacity=8, max_weight_lag=4)
    knobs.update(kw)
    return (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(
            num_env_runners=2,
            num_envs_per_env_runner=4,
            rollout_fragment_length=8,
        )
        .dataflow(policy=policy, **knobs)
        .learners(device="cpu")
        .debugging(seed=0)
        .build()
    )


def test_runner_kill_mid_rollout_queue_keeps_flowing(rt_port):
    """rt.kill of an env runner mid-rollout costs its fragment(s), never
    the flow: updates keep landing, the slot is respawned and re-synced,
    and the fleet is back to full strength."""
    algo = _small_flow("local")
    try:
        algo.train()
        before = algo.flow.stats()["fragments_by_runner"].get(0, 0)
        rt.kill(algo.flow.runner_handle(0))
        for _ in range(3):  # flows THROUGH the death + restore
            result = algo.train()
        stats = algo.flow.stats()
        assert stats["runner_failures"] >= 1
        assert stats["fragments_dropped"] >= 1
        assert result["weight_version"] == 4  # every update landed
        # The respawned slot produces fragments again (shown by output,
        # bounded by a few more updates).
        deadline = time.monotonic() + 60
        while (
            algo.flow.stats()["fragments_by_runner"].get(0, 0) <= before
            and time.monotonic() < deadline
        ):
            algo.train()
        assert (
            algo.flow.stats()["fragments_by_runner"].get(0, 0) > before
        ), algo.flow.stats()
    finally:
        algo.stop()


def test_engine_actor_death_fails_fast(rt_port):
    """The policy engine's step loop dying surfaces as EngineDead at the
    driver within the call timeout, never a hang."""
    algo = _small_flow("engine")
    try:
        algo.train()
        rt.get(algo.flow._engine.die.remote(), timeout=30)
        t0 = time.monotonic()
        with pytest.raises(EngineDead):
            algo.train()
        assert time.monotonic() - t0 < 90  # fast, never a hang
    finally:
        algo.stop()


def test_queue_backpressure_throttles_runners_live(rt_port):
    """With no learner consuming, runner puts hit the capacity gate
    ("full" waits) and depth never exceeds the bound."""
    algo = _small_flow("local")
    try:
        flow = algo.flow
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            flow._pump()
            time.sleep(0.05)
            stats = flow.queue_stats()
            if stats["rejected_full"] > 0:
                break
        stats = flow.queue_stats()
        assert stats["rejected_full"] > 0
        assert stats["depth"] <= stats["capacity"]
        algo.train()  # the learner drains it and training proceeds
    finally:
        algo.stop()


def test_decoupled_ppo_engine_mode_trains(rt_port):
    """Engine-served policy inference end to end: iterations train,
    versions advance, the engine serves rows from the runners, and
    weight pushes land drainlessly."""
    algo = _small_flow("engine")
    try:
        for _ in range(2):
            result = algo.train()
        assert np.isfinite(result["episode_return_mean"])
        assert result["weight_version"] == 2
        engine_stats = algo.flow.engine_stats()
        assert engine_stats["policy_rows_served"] > 0
        assert engine_stats["weight_version"] == 2
        assert not engine_stats["dead"]
        stats = algo.flow.stats()
        assert stats["fragments_ok"] >= 2
        assert stats["runner_failures"] == 0
    finally:
        algo.stop()


def test_sync_interval_beyond_lag_bound_never_deadlocks(rt_port):
    """With sync_interval_updates > max_weight_lag + 1 the staleness
    gates compare against the last published version, so the flow does
    not deadlock."""
    algo = _small_flow("local", max_weight_lag=1, sync_interval_updates=5)
    try:
        for _ in range(3):  # crosses non-publish updates
            result = algo.train()
        assert result["weight_version"] == 3
        stats = algo.flow.queue_stats()
        assert stats["gets"] > 0
    finally:
        algo.stop()


def test_decoupled_dqn_trains(rt_port):
    cfg = DQNConfig().environment("CartPole-v1").debugging(seed=0)
    cfg.rollout_length = 8
    cfg.num_envs = 4
    cfg.learning_starts = 32
    cfg.num_updates_per_iteration = 4
    algo = cfg.learners(device="cpu").dataflow(
        policy="local", num_env_runners=2, queue_capacity=8
    ).build()
    try:
        r1 = algo.train()
        r2 = algo.train()
        assert r2["num_updates"] > r1["num_updates"] or (
            r2["num_updates"] >= 4
        )
        assert r2["epsilon"] < 1.0
        assert np.isfinite(r2["td_loss"])
    finally:
        algo.stop()


def test_decoupled_ppo_save_restore(rt_port, tmp_path):
    algo = _small_flow("local")
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
    finally:
        algo.stop()
    algo2 = _small_flow("local")
    try:
        algo2.restore(path)
        assert algo2.iteration == 1
        result = algo2.train()
        assert result["training_iteration"] == 2
    finally:
        algo2.stop()


@pytest.mark.slow
def test_decoupled_ppo_learns_cartpole(rt_port):
    """Near-on-policy settings (lag bound 2, shallow queue) clear the same
    CartPole bar as synchronous PPO."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .dataflow(policy="local", queue_capacity=4, max_weight_lag=2)
        .learners(device="cpu")
        .debugging(seed=0)
        .build()
    )
    try:
        best = 0.0
        for _ in range(30):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best >= 100.0:
                break
        assert best >= 100.0, f"decoupled PPO plateaued at {best}"
    finally:
        algo.stop()
