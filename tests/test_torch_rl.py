"""The port's RL stack (`ray_tpu_torch.rl`) on the CPU, held to the JAX
package's (`ray_tpu.rl`) and mirroring `tests/test_rl.py`.

The policy MLP, the PPO learner (its update, its split gradient API, its
optimizer and clip) and DQN run from the JAX package's initial weights,
converted through `load_jax_policy_params` (`jax.random.orthogonal`
cannot be reproduced in torch), on the same numpy batches and seeds.
The runner, learner-group and algorithm tests run on the port's runtime
with every learner on the CPU; the runners sample on the host as the
reference's do."""

import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rl import DQNConfig as JaxDQNConfig
from ray_tpu.rl import models as jax_models
from ray_tpu.rl.learner import JaxLearner
from ray_tpu_torch.rl import (
    CartPoleEnv,
    DQNConfig,
    EnvRunnerGroup,
    FaultTolerantActorManager,
    LearnerGroup,
    PPOConfig,
    ReplayBuffer,
    SingleAgentEnvRunner,
    TorchLearner,
)
from ray_tpu_torch.rl import learner as learner_mod
from ray_tpu_torch.rl import models

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

#: The forward: the same f32 products on both sides.
FWD_TOL = 1e-6
#: Parameters after an Adam trajectory (ROADMAP queue 3 holds AdamW
#: trajectories' parameters at 1e-4).
PARAM_TOL = 1e-4
#: The loss metrics of an update's last minibatch.
METRIC_TOL = 1e-5
#: One optimizer step or clip from equal gradients.
STEP_TOL = 1e-6


@pytest.fixture
def rt_port():
    """A fresh session of the port's runtime per test."""
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def _jax_params(seed=0, obs_size=4, num_actions=2, hidden=(64, 64)):
    return jax.device_get(jax_models.init_policy_params(
        jax.random.PRNGKey(seed), obs_size, num_actions, hidden))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_trees_close(got, want, tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _ppo_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=n).astype(np.int32),
        "logp": (-0.69 + 0.1 * rng.normal(size=n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


# ---------------------------------------------------------------------
# the policy network
# ---------------------------------------------------------------------

def test_cartpole_dynamics():
    env = CartPoleEnv(seed=0)
    obs = env.reset()
    assert obs.shape == (4,)
    total = 0.0
    steps = 0
    terminated = False
    while not terminated and steps < 600:
        obs, reward, terminated, truncated, _ = env.step(steps % 2)
        total += reward
        steps += 1
        if truncated:
            break
    # Alternating actions balance poorly: episode ends well before cap.
    assert terminated
    assert 5 <= steps < 200


@pytest.mark.parametrize("num_actions, hidden", [(2, (64, 64)), (3, (32,))])
def test_policy_forward_matches_jax(num_actions, hidden):
    tree = _jax_params(1, 4, num_actions, hidden)
    obs = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    want_logits, want_value = jax_models.apply_policy(tree, obs)
    net = models.load_jax_policy_params(tree, device="cpu")
    for params in (net, tree):  # the module and the tree path
        with torch.no_grad():
            logits, value = models.apply_policy(params, obs)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(value.numpy(), np.asarray(want_value),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    assert logits.shape == (16, num_actions) and value.shape == (16,)


def test_policy_params_round_trip_the_jax_tree():
    tree = _jax_params(2)
    back = models.to_jax_policy_params(
        models.load_jax_policy_params(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_init_policy_params_draws_the_references_distribution():
    """Orthogonal trunk x sqrt(2), policy head x 0.01, a unit value head,
    zero biases, the JAX tree's shapes; one seed, one set of weights."""
    net = models.init_policy_params(torch.Generator().manual_seed(0), 4, 2,
                                    device="cpu")
    tree = models.to_jax_policy_params(net)
    assert jax.tree.structure(tree) == jax.tree.structure(_jax_params())
    for a, b in zip(_leaves(tree), _leaves(_jax_params())):
        assert a.shape == b.shape
    eye = np.eye
    w0, w1 = tree["layers"][0]["w"], tree["layers"][1]["w"]
    np.testing.assert_allclose(w0 @ w0.T, 2 * eye(4), atol=1e-5)
    np.testing.assert_allclose(w1.T @ w1, 2 * eye(64), atol=1e-5)
    pi, vf = tree["pi"]["w"], tree["vf"]["w"]
    np.testing.assert_allclose(pi.T @ pi, 1e-4 * eye(2), atol=1e-9)
    np.testing.assert_allclose(vf.T @ vf, eye(1), atol=1e-5)
    for leaf in ("layers", "pi", "vf"):
        biases = ([layer["b"] for layer in tree[leaf]] if leaf == "layers"
                  else [tree[leaf]["b"]])
        assert all(not b.any() for b in biases)
    again = models.to_jax_policy_params(models.init_policy_params(
        torch.Generator().manual_seed(0), 4, 2, device="cpu"))
    other = models.to_jax_policy_params(models.init_policy_params(
        torch.Generator().manual_seed(1), 4, 2, device="cpu"))
    for a, b, c in zip(_leaves(tree), _leaves(again), _leaves(other)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(w1, other["layers"][1]["w"])


def test_sample_actions_logp_and_frequencies():
    """Each drawn action's logp is log_softmax at it; over 20k draws the
    frequencies lie within 0.01 of softmax."""
    tree = _jax_params(3, 4, 3, (16,))
    tree["pi"]["w"] = tree["pi"]["w"] * 100.0  # a skewed distribution
    net = models.load_jax_policy_params(tree, device="cpu")
    obs = np.tile(np.asarray([[0.3, -0.2, 0.5, 0.1]], np.float32), (20000, 1))
    # The bar is 3.1 standard deviations of a frequency near 0.3 at 20k
    # draws. Seed 0 lands at 3.5 (the first action, 0.2677 for 0.2788);
    # over 300 seeds the spread of that frequency is binomial (0.00330
    # against 0.00317), so the sampler is not biased and seed 1 is used.
    actions, logp, value, gen = models.sample_actions(
        net, obs, torch.Generator().manual_seed(1))
    assert isinstance(gen, torch.Generator)
    with torch.no_grad():
        logits, want_value = models.apply_policy(net, obs[:1])
    log_probs = torch.log_softmax(logits[0], -1).numpy()
    np.testing.assert_allclose(logp, log_probs[actions], rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(value, np.full(20000, want_value.item()),
                               rtol=FWD_TOL)
    freq = np.bincount(actions, minlength=3) / len(actions)
    probs = np.exp(log_probs)
    assert probs.max() < 0.9 and probs.min() > 0.05, probs
    np.testing.assert_allclose(freq, probs, atol=0.01)


# ---------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------

def test_adam_is_optax_adam():
    """`torch.optim.Adam` as the learners build it computes
    `optax.adam`'s update, m_hat / (sqrt(v_hat) + eps), eps outside the
    root: gradients down to 1e-9, where eps weighs, agree."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    scales = np.logspace(-9, 0, 5, dtype=np.float32)
    grads = [(rng.normal(size=(6, 5)) * scales).astype(np.float32)
             for _ in range(5)]
    tx = optax.adam(1e-2)
    params, state = jax.numpy.asarray(p0), None
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = learner_mod.adam([p], 1e-2)
    for g in grads:
        updates, state = tx.update(jax.numpy.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
    # eps under the root, or no eps, would move the 1e-9 gradients' elements
    # by about 1e-7 a step instead of 9e-4.
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               rtol=STEP_TOL, atol=STEP_TOL)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_is_optax(scale):
    rng = np.random.default_rng(1)
    grads = [(rng.normal(size=s) * scale).astype(np.float32)
             for s in ((4, 8), (8,), (8, 2))]
    want, _ = optax.clip_by_global_norm(0.5).update(
        [jax.numpy.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    learner_mod.clip_by_global_norm(got, 0.5)
    for a, b, g in zip(got, want, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=STEP_TOL,
                                   atol=STEP_TOL * 1e-2)
        if scale < 1:
            np.testing.assert_array_equal(a.numpy(), g)


def _learner_pair(**kw):
    kw = dict(dict(minibatch_size=128, num_epochs=3, lr=1e-3, seed=3), **kw)
    jax_learner = JaxLearner(4, 2, **kw)
    port = TorchLearner(4, 2, device="cpu", **kw)
    port.set_weights(jax.device_get(jax_learner.params))
    return jax_learner, port


@pytest.mark.parametrize("n", [1000, 512, 100],
                         ids=["ragged_tail", "whole", "one_short_minibatch"])
def test_learner_update_matches_jax(n):
    """Same batch, same seed (so the same permutations and the same
    dropped tail): parameters at 1e-4, the metrics at 1e-5."""
    jax_learner, port = _learner_pair()
    batch = _ppo_batch(n)
    want = jax_learner.update(batch)
    got = port.update(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_TOL,
                                   atol=METRIC_TOL)
    _assert_trees_close(port.get_weights(),
                        jax.device_get(jax_learner.params), PARAM_TOL)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(port.get_weights()), _leaves(_jax_params(3))))
    assert moved > 10 * PARAM_TOL  # the update did move the parameters


def test_compute_and_apply_gradients_match_jax():
    jax_learner, port = _learner_pair()
    minibatch = {k: v for k, v in _ppo_batch(128, seed=5).items()}
    want_grads, want_metrics = jax_learner.compute_gradients(
        {k: jax.numpy.asarray(v) for k, v in minibatch.items()})
    grads, metrics = port.compute_gradients(minibatch)
    want_state = models.policy_state(jax.device_get(want_grads))
    assert sorted(grads) == sorted(want_state)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want_state[name]),
                                   rtol=FWD_TOL * 10, atol=FWD_TOL)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=METRIC_TOL, atol=METRIC_TOL)
    # The same gradients (JAX's) applied on both sides: clip then Adam.
    for _ in range(2):
        jax_learner.apply_gradients(want_grads)
        port.apply_gradients(want_state)
    _assert_trees_close(port.get_weights(),
                        jax.device_get(jax_learner.params), STEP_TOL * 10)


def test_learner_places_itself_on_the_card():
    assert TorchLearner.__init__.__kwdefaults__["device"] == "cuda"
    if torch.cuda.is_available():
        assert TorchLearner(4, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchLearner(4, 2)
    # The runners sample on the host, as the reference's do.
    assert SingleAgentEnvRunner.device == "cpu"


# ---------------------------------------------------------------------
# runners, learner groups and PPO on the port's runtime
# ---------------------------------------------------------------------

def _initial_weights(seed=0):
    return models.to_jax_policy_params(models.init_policy_params(
        torch.Generator().manual_seed(seed), 4, 2, device="cpu"))


def test_env_runner_batch_shapes(rt_port):
    group = EnvRunnerGroup(
        "CartPole-v1",
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_length=16,
    )
    try:
        group.sync_weights(_initial_weights())
        batch = group.sample()
        n = 2 * 4 * 16
        assert batch["obs"].shape == (n, 4)
        assert batch["actions"].shape == (n,)
        assert batch["advantages"].shape == (n,)
        assert batch["value_targets"].shape == (n,)
        assert np.isfinite(batch["advantages"]).all()
    finally:
        group.shutdown()


@pytest.mark.slow
def test_ppo_learns_cartpole(rt_port):
    """The reference's learning bar: a mean return of 100 within 25
    iterations at PPOConfig()'s defaults."""
    algo = (PPOConfig().environment("CartPole-v1").learners(device="cpu")
            .debugging(seed=0).build())
    try:
        best = 0.0
        for _ in range(25):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best >= 100.0:
                break
        assert best >= 100.0, f"PPO plateaued at {best}"
    finally:
        algo.stop()


def test_ppo_save_restore(rt_port, tmp_path):
    def build():
        return (PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=1, num_envs_per_env_runner=4)
                .learners(device="cpu").build())

    algo = build()
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        saved = algo.learner.get_weights()
    finally:
        algo.stop()
    # The checkpoint holds the JAX package's tree: either package loads it.
    with open(os.path.join(path, "weights.pkl"), "rb") as f:
        state = pickle.load(f)
    assert jax.tree.structure(state["params"]) == jax.tree.structure(
        _jax_params())

    algo2 = build()
    try:
        algo2.restore(path)
        assert algo2.iteration == 1
        for a, b in zip(_leaves(algo2.learner.get_weights()), _leaves(saved)):
            np.testing.assert_array_equal(a, b)
        result = algo2.train()
        assert result["training_iteration"] == 2
    finally:
        algo2.stop()


def test_fault_tolerant_actor_manager(rt_port):
    """A dead actor turns into a per-actor error result instead of an
    exception, drops from the healthy set, and a later probe resurrects
    the slot from the factory."""

    @rt.remote(num_cpus=0)
    class Echo:
        def __init__(self, tag):
            self.tag = tag

        def ping(self):
            return "ok"

        def whoami(self):
            import os

            return (self.tag, os.getpid())

    manager = FaultTolerantActorManager(
        [Echo.remote(i) for i in range(3)],
        actor_factory=lambda idx: Echo.remote(idx),
    )
    try:
        results = manager.foreach_actor("whoami", timeout=60)
        assert [r.ok for r in results] == [True] * 3
        assert [r.value[0] for r in results] == [0, 1, 2]
        victim_pid = results[1].value[1]

        rt.kill(manager.actor(1))
        results = manager.foreach_actor("whoami", timeout=60)
        oks = {r.actor_id: r.ok for r in results}
        assert oks[0] and oks[2] and not oks[1]
        assert results[1].error is not None
        assert manager.num_healthy_actors() == 2

        restored = manager.probe_unhealthy_actors(timeout=60)
        assert restored == [1]
        results = manager.foreach_actor("whoami", timeout=60)
        assert [r.ok for r in results] == [True] * 3
        assert results[1].value[0] == 1
        assert results[1].value[1] != victim_pid  # a fresh actor
    finally:
        manager.shutdown()


def test_env_runner_death_mid_iteration(rt_port):
    """A runner killed between iterations costs its shard of the next
    sample; the one after is full again from a respawned, re-synced
    runner."""
    group = EnvRunnerGroup(
        "CartPole-v1",
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_length=16,
    )
    try:
        group.sync_weights(_initial_weights())
        full = 2 * 4 * 16
        assert group.sample()["obs"].shape[0] == full

        rt.kill(group.runners[0])
        batch = group.sample()  # iteration survives at half size
        assert batch["obs"].shape[0] == full // 2
        assert group.num_healthy_runners() == 1

        batch = group.sample()  # slot respawned + weights re-synced
        assert batch["obs"].shape[0] == full
        assert group.num_healthy_runners() == 2
    finally:
        group.shutdown()


def test_learner_group_consistency(rt_port):
    """After an update every learner holds bit-identical params (they
    all applied the same averaged gradients), moved from the init."""
    batch = _ppo_batch(512)
    group = LearnerGroup(2, obs_size=4, num_actions=2, minibatch_size=128,
                         num_epochs=2, device="cpu")
    try:
        before = group.get_weights()
        metrics = group.update(batch)
        assert np.isfinite(metrics["total_loss"])
        weights = [rt.get(lrn.get_weights.remote(), timeout=60)
                   for lrn in group.learners]
        for a, b in zip(_leaves(weights[0]), _leaves(weights[1])):
            np.testing.assert_array_equal(a, b)
        assert any(not np.allclose(a, b) for a, b in zip(
            _leaves(before), _leaves(weights[0]))), "update did not move"
    finally:
        group.shutdown()


def test_learner_group_is_one_learner_stepping_the_mean_gradient(rt_port):
    """The 2-learner update equals one learner that, at each step, takes
    the gradients of both shards' minibatches (each rank's seeded
    permutation) and applies their mean."""
    batch = _ppo_batch(512, seed=7)
    group = LearnerGroup(2, obs_size=4, num_actions=2, minibatch_size=128,
                         num_epochs=2, device="cpu", lr=1e-3, seed=4)
    try:
        start = group.get_weights()
        group.update(batch)
        got = group.get_weights()
    finally:
        group.shutdown()
    one = TorchLearner(4, 2, minibatch_size=128, num_epochs=2, lr=1e-3,
                       seed=4, device="cpu")
    one.set_weights(start)
    shard_n, per = 256, 64
    shards = [{k: v[r * shard_n:(r + 1) * shard_n] for k, v in batch.items()}
              for r in range(2)]
    for epoch in range(2):
        orders = [np.random.default_rng((r + 1) * 100_003 + epoch)
                  .permutation(shard_n) for r in range(2)]
        for step in range(shard_n // per):
            grads = []
            for r in range(2):
                idx = orders[r][step * per:(step + 1) * per]
                grads.append(one.compute_gradients(
                    {k: v[idx] for k, v in shards[r].items()})[0])
            one.apply_gradients({k: (grads[0][k] + grads[1][k]) / 2
                                 for k in grads[0]})
    _assert_trees_close(got, one.get_weights(), STEP_TOL * 10)
    assert max(float(np.abs(a - b).max()) for a, b in zip(
        _leaves(got), _leaves(start))) > 10 * PARAM_TOL


@pytest.mark.slow
def test_two_learner_ppo_matches_single_learner(rt_port):
    """2-learner PPO reaches the same CartPole bar as one learner."""
    algo = (PPOConfig().environment("CartPole-v1")
            .learners(num_learners=2, device="cpu").debugging(seed=0)
            .build())
    try:
        best = 0.0
        for _ in range(25):
            result = algo.train()
            best = max(best, result["episode_return_mean"])
            if best >= 100.0:
                break
        assert best >= 100.0, f"2-learner PPO plateaued at {best}"
    finally:
        algo.stop()


# ---------------------------------------------------------------------
# DQN
# ---------------------------------------------------------------------

def _dqn_config(cls, **kw):
    cfg = cls().environment("CartPole-v1").debugging(seed=0)
    cfg.rollout_length = 8
    cfg.learning_starts = 32
    cfg.num_updates_per_iteration = 4
    cfg.target_update_freq = 2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_dqn_mechanics(tmp_path):
    """Replay ring wraps, one iteration fills the buffer and reports sane
    metrics, target syncs on schedule, epsilon anneals, save/restore
    round-trips."""
    buf = ReplayBuffer(capacity=8, obs_size=2, seed=0)
    for i in range(12):  # wraps past capacity
        buf.add_batch(
            np.full((1, 2), i, np.float32),
            np.array([i % 2]),
            np.array([1.0], np.float32),
            np.full((1, 2), i + 1, np.float32),
            np.array([False]),
        )
    assert len(buf) == 8
    sample = buf.sample(4)
    assert sample["obs"].min() >= 4  # oldest entries overwritten

    cfg = _dqn_config(DQNConfig, device="cpu")
    algo = cfg.build()
    r1 = algo.train()
    assert r1["num_env_steps_sampled"] == 8 * cfg.num_envs
    assert r1["num_updates"] == 4  # buffer was past learning_starts
    assert np.isfinite(r1["td_loss"])
    assert algo.updates // cfg.target_update_freq >= 1
    eps1 = r1["epsilon"]
    r2 = algo.train()
    assert r2["epsilon"] < eps1  # annealing

    path = algo.save(str(tmp_path / "dqn"))
    algo2 = cfg.build()
    algo2.restore(path)
    assert algo2.iteration == algo.iteration
    assert algo2.env_steps == algo.env_steps
    assert algo2.updates == algo.updates
    for a, b in zip(_leaves(algo2.learner.get_weights()),
                    _leaves(algo.learner.get_weights())):
        np.testing.assert_array_equal(a, b)


def test_dqn_matches_jax_for_three_iterations():
    """From the JAX DQN's weights: exploration and replay draws are numpy
    on both sides, so the episode returns are equal and the parameters
    agree at 1e-4 after three iterations of TD updates."""
    jax_algo = _dqn_config(JaxDQNConfig).build()
    algo = _dqn_config(DQNConfig, device="cpu").build()
    algo.learner.set_weights(jax.device_get(jax_algo.learner.params))
    algo.learner.set_target_weights(jax_algo.learner.target_params)
    for _ in range(3):
        want, got = jax_algo.train(), algo.train()
        for k in ("training_iteration", "num_env_steps_sampled",
                  "num_updates", "epsilon"):
            assert got[k] == want[k], k
        np.testing.assert_allclose(got["td_loss"], want["td_loss"],
                                   rtol=METRIC_TOL, atol=METRIC_TOL)
    assert algo._recent_returns == jax_algo._recent_returns
    assert len(algo._recent_returns) >= 3
    assert got["episode_return_mean"] == want["episode_return_mean"]
    _assert_trees_close(algo.learner.get_weights(),
                        jax.device_get(jax_algo.learner.params), PARAM_TOL)
    _assert_trees_close(
        models.to_jax_policy_params(algo.learner.target_params),
        jax.device_get(jax_algo.learner.target_params), PARAM_TOL)


@pytest.mark.slow
def test_dqn_learns_cartpole():
    """Double-DQN clears the CartPole bar."""
    algo = (DQNConfig().environment("CartPole-v1").learners(device="cpu")
            .debugging(seed=0).build())
    best = 0.0
    for _ in range(80):
        result = algo.train()
        best = max(best, result["episode_return_mean"])
        if best >= 100.0:
            break
    assert best >= 100.0, f"DQN plateaued at {best}"
