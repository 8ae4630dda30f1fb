"""DQN algorithm (PyTorch port of `ray_tpu/rl/dqn.py`).

Reference: rllib/algorithms/dqn/ — dqn.py (Algorithm.training_step:
sample -> replay buffer -> minibatch TD updates -> periodic target-net
sync) + dqn_rainbow_learner.py (Huber TD loss against a frozen target
network) + utils/replay_buffers/. The Q-function is the policy
stack's MLP (models.py; its `pi` head), the TD update one eager step on
the learner's device ("cuda" unless the caller asks for the CPU), and
the replay buffer preallocated numpy rings (no per-transition Python
objects), as in the reference. The TD loss is `optax.huber_loss` with
delta 1 (`F.huber_loss` computes the same), the optimizer
`optax.adam` (`learner.adam`). The TD update and the Q forward are the
compile-watch programs `rl.dqn.td_update` and `rl.dqn.q_values`, the
JAX package's names.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .env import VectorEnv, make_env


class ReplayBuffer:
    """Uniform-sampling ring buffer (reference:
    utils/replay_buffers/replay_buffer.py, storage_unit=timesteps)."""

    def __init__(self, capacity: int, obs_size: int, seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_size), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.next_obs = np.zeros((capacity, obs_size), np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(
        self, obs, actions, rewards, next_obs, dones
    ) -> None:
        for i in range(len(actions)):
            j = self._next
            self.obs[j] = obs[i]
            self.actions[j] = actions[i]
            self.rewards[j] = rewards[i]
            self.next_obs[j] = next_obs[i]
            self.dones[j] = float(dones[i])
            self._next = (self._next + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "dones": self.dones[idx],
        }


class DQNLearner:
    """The gradient half of DQN — replay buffer + double-DQN TD update
    + target sync — extracted (ISSUE 13) so the synchronous
    `DQN` loop and the decoupled dataflow train through ONE
    implementation. Satisfies the RLDataflow learner contract:
    `update(batch)` ingests a transition batch and takes the
    configured TD steps; `get_weights()/set_weights()` move the
    online net."""

    #: RLDataflow contract: batches land in the HOST-side replay
    #: ring (minibatches upload separately in td_steps), so the
    #: driver's device-prefetch stage must pass them through as-is.
    host_ingest = True

    def __init__(
        self,
        obs_size: int,
        num_actions: int,
        *,
        lr: float = 5e-4,
        gamma: float = 0.99,
        hidden: Tuple[int, ...] = (64, 64),
        double_q: bool = True,
        buffer_capacity: int = 50_000,
        train_batch_size: int = 64,
        updates_per_batch: int = 128,
        target_update_freq: int = 100,
        learning_starts: int = 1_000,
        seed: int = 0,
        device: Any = "cuda",
    ):
        import copy

        import torch

        from .learner import adam, resolve_device
        from .models import init_policy_params

        self.device = resolve_device(device)
        self.gamma = gamma
        self.double_q = double_q
        self.train_batch_size = train_batch_size
        self.updates_per_batch = updates_per_batch
        self.target_update_freq = target_update_freq
        self.learning_starts = learning_starts
        # The pi head doubles as the Q head (A outputs); vf unused.
        self.params = init_policy_params(
            torch.Generator().manual_seed(seed), obs_size, num_actions,
            hidden, device=self.device,
        )
        # The frozen target net: a copy of the online net, synced by
        # value every target_update_freq updates.
        self.target_params = copy.deepcopy(self.params).requires_grad_(
            False
        )
        self.optimizer = adam(self.params.parameters(), lr)
        self.buffer = ReplayBuffer(
            buffer_capacity, obs_size, seed=seed
        )
        self.updates = 0
        from .._private import compile_watch

        self._update_jit = compile_watch.instrument(
            "rl.dqn.td_update", self._td_update
        )
        self._q_jit = compile_watch.instrument(
            "rl.dqn.q_values", self._q_values
        )

    # -- Q function ----------------------------------------------------
    @staticmethod
    def _q_values(params, obs):
        from .models import apply_policy

        q, _ = apply_policy(params, obs)
        return q

    def q_values(self, obs):
        """Q values of the online net for a host batch of observations,
        as numpy (the acting side's forward)."""
        import torch

        with torch.no_grad():
            return self._q_jit(self.params, obs).cpu().numpy()

    def _td_update(self, batch):
        import torch
        import torch.nn.functional as F

        q = self._q_values(self.params, batch["obs"])
        q_taken = q.gather(1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            q_next_target = self._q_values(
                self.target_params, batch["next_obs"]
            )
            if self.double_q:
                # Double-DQN: online net picks, target net evaluates
                # (reference: dqn_rainbow_learner.py double_q branch).
                q_next_online = self._q_values(
                    self.params, batch["next_obs"]
                )
                best = torch.argmax(q_next_online, dim=1)
            else:
                best = torch.argmax(q_next_target, dim=1)
            next_value = q_next_target.gather(1, best[:, None])[:, 0]
            td_target = batch["rewards"] + self.gamma * next_value * (
                1.0 - batch["dones"]
            )
        loss = F.huber_loss(q_taken, td_target, delta=1.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    # -- training ------------------------------------------------------
    def ingest(self, batch: Dict[str, np.ndarray]) -> int:
        """Append one transition batch (obs/actions/rewards/next_obs/
        dones arrays) to the replay ring."""
        self.buffer.add_batch(
            np.asarray(batch["obs"]),
            np.asarray(batch["actions"]),
            np.asarray(batch["rewards"]),
            np.asarray(batch["next_obs"]),
            np.asarray(batch["dones"]),
        )
        return len(self.buffer)

    def td_steps(self, n: int) -> float:
        """`n` sampled TD minibatch updates + scheduled target syncs;
        returns the last loss (nan while below learning_starts)."""
        import torch

        loss = float("nan")
        if len(self.buffer) < self.learning_starts:
            return loss
        for _ in range(n):
            batch = self.buffer.sample(self.train_batch_size)
            device_batch = {
                k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()
            }
            device_batch["actions"] = device_batch["actions"].long()
            loss = self._update_jit(device_batch)
            self.updates += 1
            if self.updates % self.target_update_freq == 0:
                self.target_params.load_state_dict(
                    self.params.state_dict()
                )
        return float(loss)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """RLDataflow contract: one queue batch in, the configured TD
        steps out."""
        self.ingest(batch)
        loss = self.td_steps(self.updates_per_batch)
        return {"td_loss": loss, "num_updates": float(self.updates)}

    def get_weights(self):
        """The online net as the JAX package's tree of numpy arrays."""
        from .models import to_jax_policy_params

        return to_jax_policy_params(self.params)

    def set_weights(self, params) -> None:
        """Load the online net from a tree (numpy or tensors), a state
        dict or a `PolicyNet`; the target net and optimizer state are
        kept, as the reference keeps them."""
        from .models import load_jax_policy_params

        self.params.load_state_dict(
            load_jax_policy_params(params, "cpu").state_dict()
        )

    def set_target_weights(self, params) -> None:
        """Load the target net as `set_weights` loads the online one."""
        from .models import load_jax_policy_params

        self.target_params.load_state_dict(
            load_jax_policy_params(params, "cpu").state_dict()
        )


class DQNConfig:
    """Fluent builder (reference: DQNConfig(AlgorithmConfig))."""

    def __init__(self):
        self.env_spec: Any = "CartPole-v1"
        self.num_envs = 8
        self.rollout_length = 64  # vector steps per train() iteration
        self.gamma = 0.99
        self.lr = 5e-4
        self.buffer_capacity = 50_000
        self.train_batch_size = 64
        self.num_updates_per_iteration = 128
        self.learning_starts = 1_000  # transitions before updates
        # Updates between target syncs. Too-frequent syncing collapses
        # CartPole (measured: freq 8 plateaus at return ~10; freq 100
        # reaches 130+ by ~30k steps).
        self.target_update_freq = 100
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 8_000  # transitions to anneal over
        self.hidden = (64, 64)
        self.seed = 0
        self.double_q = True
        self.device = "cuda"
        # Decoupled dataflow (ISSUE 13): off = the synchronous
        # act -> buffer -> update loop below.
        self.dataflow_enabled = False
        self.dataflow_policy = "local"
        self.num_env_runners = 2
        self.queue_capacity: Optional[int] = None
        self.max_weight_lag: Optional[int] = None
        self.sync_interval_updates: Optional[int] = None

    def environment(self, env) -> "DQNConfig":
        self.env_spec = env
        return self

    def env_runners(
        self,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
    ) -> "DQNConfig":
        if num_envs_per_env_runner is not None:
            self.num_envs = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_length = rollout_fragment_length
        return self

    def training(
        self,
        lr: Optional[float] = None,
        gamma: Optional[float] = None,
        train_batch_size: Optional[int] = None,
        target_network_update_freq: Optional[int] = None,
        num_steps_sampled_before_learning_starts: Optional[int] = None,
        double_q: Optional[bool] = None,
    ) -> "DQNConfig":
        for name, value in (
            ("lr", lr),
            ("gamma", gamma),
            ("train_batch_size", train_batch_size),
            ("target_update_freq", target_network_update_freq),
            ("learning_starts", num_steps_sampled_before_learning_starts),
            ("double_q", double_q),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def debugging(self, seed: Optional[int] = None) -> "DQNConfig":
        if seed is not None:
            self.seed = seed
        return self

    def learners(self, *, device: Optional[str] = None) -> "DQNConfig":
        """`device` ("cuda", the default, or "cpu") places the learner
        and the policy engine, as PPOConfig.learners does."""
        if device is not None:
            self.device = device
        return self

    def dataflow(
        self,
        enabled: bool = True,
        *,
        policy: Optional[str] = None,
        num_env_runners: Optional[int] = None,
        queue_capacity: Optional[int] = None,
        max_weight_lag: Optional[int] = None,
        sync_interval_updates: Optional[int] = None,
    ) -> "DQNConfig":
        """Switch `build()` to the decoupled dataflow: runner actors
        stream transition fragments through the rollout queue into
        this learner's replay buffer while TD updates run — DQN is
        replay-based, so staleness tolerance is native and
        `max_weight_lag` simply bounds how old the BEHAVIOR policy
        may be. Same knob semantics as PPOConfig.dataflow()."""
        self.dataflow_enabled = bool(enabled)
        if policy is not None:
            self.dataflow_policy = policy
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if queue_capacity is not None:
            self.queue_capacity = queue_capacity
        if max_weight_lag is not None:
            self.max_weight_lag = max_weight_lag
        if sync_interval_updates is not None:
            self.sync_interval_updates = sync_interval_updates
        return self

    def build(self):
        if self.dataflow_enabled:
            return DecoupledDQN(self)
        return DQN(self)


class DQN:
    """(reference: dqn.py DQN(Algorithm) — train()/save/restore)."""

    def __init__(self, config: DQNConfig):
        self.config = config
        probe = make_env(config.env_spec, seed=0)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        # REWIRED (ISSUE 13): the gradient half lives in DQNLearner —
        # the same object the decoupled dataflow trains through.
        self.learner = DQNLearner(
            self.obs_size,
            self.num_actions,
            lr=config.lr,
            gamma=config.gamma,
            hidden=config.hidden,
            double_q=config.double_q,
            buffer_capacity=config.buffer_capacity,
            train_batch_size=config.train_batch_size,
            updates_per_batch=config.num_updates_per_iteration,
            target_update_freq=config.target_update_freq,
            learning_starts=config.learning_starts,
            seed=config.seed,
            device=config.device,
        )
        self.vec = VectorEnv(
            lambda s: make_env(config.env_spec, seed=s),
            config.num_envs,
            seed=config.seed,
        )
        self._obs = self.vec.reset()
        self._rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.env_steps = 0
        self._ep_returns = np.zeros(config.num_envs)
        self._recent_returns: list = []

    # -- learner views (kept for compatibility) -----------------------
    @property
    def params(self):
        return self.learner.params

    @property
    def target_params(self):
        return self.learner.target_params

    @property
    def buffer(self) -> ReplayBuffer:
        return self.learner.buffer

    @property
    def updates(self) -> int:
        return self.learner.updates

    # -- acting --------------------------------------------------------
    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.env_steps / cfg.epsilon_decay_steps)
        return cfg.epsilon_initial + frac * (
            cfg.epsilon_final - cfg.epsilon_initial
        )

    def _act(self, obs: np.ndarray) -> np.ndarray:
        eps = self._epsilon()
        greedy = np.argmax(self.learner.q_values(obs), axis=1)
        explore = self._rng.integers(
            0, self.num_actions, size=len(obs)
        )
        coin = self._rng.random(len(obs)) < eps
        return np.where(coin, explore, greedy).astype(np.int32)

    # -- one iteration (reference: DQN.training_step) -----------------
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        for _ in range(cfg.rollout_length):
            actions = self._act(self._obs)
            next_obs, rewards, terminated, truncated = self.vec.step(
                actions
            )
            self.buffer.add_batch(
                self._obs, actions, rewards, next_obs, terminated
            )
            self.env_steps += len(actions)
            self._ep_returns += rewards
            for i in range(len(actions)):
                if terminated[i] or truncated[i]:
                    self._recent_returns.append(
                        float(self._ep_returns[i])
                    )
                    self._ep_returns[i] = 0.0
            self._obs = next_obs
        loss = self.learner.td_steps(cfg.num_updates_per_iteration)
        self.iteration += 1
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (
            float(np.mean(self._recent_returns))
            if self._recent_returns
            else float("nan")
        )
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "num_env_steps_sampled": self.env_steps,
            "num_updates": self.updates,
            "epsilon": self._epsilon(),
            "td_loss": loss,
        }

    # -- checkpointing (reference: Algorithm.save/restore) ------------
    def save(self, path: Optional[str] = None) -> str:
        from .models import to_jax_policy_params

        path = path or tempfile.mkdtemp(prefix="rt_dqn_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "state.pkl"), "wb") as f:
            pickle.dump(
                {
                    "params": self.learner.get_weights(),
                    "target_params": to_jax_policy_params(
                        self.target_params
                    ),
                    "iteration": self.iteration,
                    "env_steps": self.env_steps,
                    "updates": self.updates,
                },
                f,
            )
        return path

    def restore(self, path: str) -> None:
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_weights(state["params"])
        self.learner.set_target_weights(state["target_params"])
        self.iteration = state["iteration"]
        self.env_steps = state["env_steps"]
        self.learner.updates = state["updates"]

    def stop(self) -> None:
        pass


class DecoupledDQN:
    """DQN rewired onto the decoupled dataflow (ISSUE 13): runner
    actors explore with engine-served (or runner-local) Q inference
    and stream transition fragments through the rollout queue into
    the shared DQNLearner's replay buffer; TD updates and target
    syncs run while the fleet keeps sampling. Epsilon anneals on the
    DRIVER's global env-step count and ships with each runner call,
    so exploration scheduling matches the synchronous loop."""

    def __init__(self, config: DQNConfig):
        from .dataflow import DataflowConfig, RLDataflow

        self.config = config
        probe = make_env(config.env_spec, seed=0)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.learner = DQNLearner(
            self.obs_size,
            self.num_actions,
            lr=config.lr,
            gamma=config.gamma,
            hidden=config.hidden,
            double_q=config.double_q,
            buffer_capacity=config.buffer_capacity,
            train_batch_size=config.train_batch_size,
            updates_per_batch=config.num_updates_per_iteration,
            target_update_freq=config.target_update_freq,
            learning_starts=config.learning_starts,
            seed=config.seed,
            device=config.device,
        )

        def epsilon(env_steps: int) -> float:
            frac = min(
                1.0, env_steps / config.epsilon_decay_steps
            )
            return config.epsilon_initial + frac * (
                config.epsilon_final - config.epsilon_initial
            )

        self._epsilon_fn = epsilon
        self.flow = RLDataflow(
            self.learner,
            env_spec=config.env_spec,
            obs_size=self.obs_size,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs,
            rollout_length=config.rollout_length,
            gamma=config.gamma,
            gae_lambda=0.0,  # unused by the dqn fragment path
            seed=config.seed,
            algo="dqn",
            flow=DataflowConfig(
                policy=config.dataflow_policy,
                queue_capacity=config.queue_capacity,
                max_weight_lag=config.max_weight_lag,
                sync_interval_updates=config.sync_interval_updates,
            ),
            epsilon_fn=epsilon,
        )
        self.iteration = 0

    @property
    def env_steps(self) -> int:
        return self.flow._env_steps

    @property
    def updates(self) -> int:
        return self.learner.updates

    def train(self) -> Dict[str, Any]:
        metrics = self.flow.train_update()
        self.iteration += 1
        stats = self.flow.stats()
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": stats["episode_return_mean"],
            "num_env_steps_sampled": stats["env_steps"],
            "num_updates": self.learner.updates,
            "epsilon": self._epsilon_fn(stats["env_steps"]),
            "td_loss": metrics.get("td_loss", float("nan")),
            "weight_version": metrics.get("weight_version", 0),
        }

    def stop(self) -> None:
        self.flow.shutdown()
