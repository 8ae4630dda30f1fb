"""PPO algorithm (PyTorch port of `ray_tpu/rl/ppo.py`).

Reference: rllib/algorithms/ppo/ppo.py:374,400 — Algorithm.train()
runs training_step(): EnvRunnerGroup sample fan-out -> learner update
-> weights broadcast back to runners; config via the fluent
AlgorithmConfig builder (algorithm_config.py).

The learner (and the learner group's actors, and in engine mode the
policy engine) runs on "cuda" unless `.learners(device="cpu")`; the env
runners sample on the host, as the reference's do (env_runner.py).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, Optional

import numpy as np

from .env import make_env
from .env_runner import EnvRunnerGroup
from .learner import TorchLearner


class PPOConfig:
    """Fluent builder (reference: AlgorithmConfig)."""

    def __init__(self):
        self.env_spec: Any = "CartPole-v1"
        self.num_env_runners = 2
        self.num_envs_per_runner = 16
        self.rollout_length = 128
        self.gamma = 0.99
        self.gae_lambda = 0.95
        self.lr = 1e-3
        self.clip_eps = 0.2
        self.vf_coef = 0.5
        self.entropy_coef = 0.01
        self.minibatch_size = 128
        self.num_epochs = 4
        self.hidden = (64, 64)
        self.seed = 0
        self.num_learners = 1
        self.device = "cuda"
        # Decoupled dataflow (ISSUE 13): off = the synchronous
        # sample -> update -> broadcast loop below (kept as the
        # rlbench baseline).
        self.dataflow_enabled = False
        self.dataflow_policy = "local"
        self.queue_capacity: Optional[int] = None
        self.max_weight_lag: Optional[int] = None
        self.sync_interval_updates: Optional[int] = None
        self.updates_per_iteration = 1

    def environment(self, env) -> "PPOConfig":
        self.env_spec = env
        return self

    def env_runners(
        self,
        num_env_runners: Optional[int] = None,
        num_envs_per_env_runner: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
    ) -> "PPOConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_length = rollout_fragment_length
        return self

    def training(
        self,
        lr: Optional[float] = None,
        gamma: Optional[float] = None,
        clip_param: Optional[float] = None,
        entropy_coeff: Optional[float] = None,
        vf_loss_coeff: Optional[float] = None,
        minibatch_size: Optional[int] = None,
        num_epochs: Optional[int] = None,
    ) -> "PPOConfig":
        for name, value in (
            ("lr", lr),
            ("gamma", gamma),
            ("clip_eps", clip_param),
            ("entropy_coef", entropy_coeff),
            ("vf_coef", vf_loss_coeff),
            ("minibatch_size", minibatch_size),
            ("num_epochs", num_epochs),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def learners(
        self,
        num_learners: Optional[int] = None,
        *,
        device: Optional[str] = None,
    ) -> "PPOConfig":
        """Data-parallel learner count (reference:
        AlgorithmConfig.learners(num_learners=...)). 1 = in-process
        TorchLearner; >1 = LearnerGroup actors with per-minibatch
        gradient all-reduce. `device` ("cuda", the default, or "cpu")
        places the learners and the policy engine."""
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.device = device
        return self

    def debugging(self, seed: Optional[int] = None) -> "PPOConfig":
        if seed is not None:
            self.seed = seed
        return self

    def dataflow(
        self,
        enabled: bool = True,
        *,
        policy: Optional[str] = None,
        queue_capacity: Optional[int] = None,
        max_weight_lag: Optional[int] = None,
        sync_interval_updates: Optional[int] = None,
        updates_per_iteration: Optional[int] = None,
    ) -> "PPOConfig":
        """Switch `build()` to the decoupled Sebulba-style dataflow
        (rl/dataflow.py): runner actors stream fragments through the
        bounded rollout queue while the learner trains, with
        drainless versioned weight sync. ``policy="engine"`` serves
        rollout inference from a continuous-batching policy engine
        (the RLHF shape); ``"local"`` keeps inference in the runners
        (classic Sebulba, the apples-to-apples rlbench comparison).
        Unset knobs fall back to the ``rl_*`` runtime config keys."""
        self.dataflow_enabled = bool(enabled)
        if policy is not None:
            self.dataflow_policy = policy
        if queue_capacity is not None:
            self.queue_capacity = queue_capacity
        if max_weight_lag is not None:
            self.max_weight_lag = max_weight_lag
        if sync_interval_updates is not None:
            self.sync_interval_updates = sync_interval_updates
        if updates_per_iteration is not None:
            self.updates_per_iteration = updates_per_iteration
        return self

    def build(self):
        if self.dataflow_enabled:
            return DecoupledPPO(self)
        return PPO(self)


class PPO:
    """(reference: Algorithm(Trainable) — train()/save/restore)."""

    def __init__(self, config: PPOConfig):
        self.config = config
        probe = make_env(config.env_spec, seed=0)
        learner_kwargs = dict(
            obs_size=probe.observation_size,
            num_actions=probe.num_actions,
            lr=config.lr,
            clip_eps=config.clip_eps,
            vf_coef=config.vf_coef,
            entropy_coef=config.entropy_coef,
            minibatch_size=config.minibatch_size,
            num_epochs=config.num_epochs,
            hidden=config.hidden,
            seed=config.seed,
            device=config.device,
        )
        if config.num_learners > 1:
            from .learner_group import LearnerGroup

            self.learner = LearnerGroup(
                config.num_learners, **learner_kwargs
            )
        else:
            self.learner = TorchLearner(**learner_kwargs)
        self.env_runners = EnvRunnerGroup(
            config.env_spec,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            rollout_length=config.rollout_length,
            gamma=config.gamma,
            gae_lambda=config.gae_lambda,
            seed=config.seed,
        )
        self.env_runners.sync_weights(self.learner.get_weights())
        self.iteration = 0
        self._recent_returns: list = []

    def train(self) -> Dict[str, Any]:
        """One iteration (reference: PPO.training_step, ppo.py:400)."""
        batch = self.env_runners.sample()
        episode_returns = batch.pop("episode_returns")
        metrics = self.learner.update(batch)
        self.env_runners.sync_weights(self.learner.get_weights())
        self.iteration += 1
        self._recent_returns.extend(episode_returns.tolist())
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (
            float(np.mean(self._recent_returns))
            if self._recent_returns
            else float("nan")
        )
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "num_env_steps_sampled": len(batch["obs"]),
            **metrics,
        }

    # -- checkpointing (reference: Algorithm.save/restore) ------------
    def save(self, path: Optional[str] = None) -> str:
        path = path or tempfile.mkdtemp(prefix="rt_ppo_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "weights.pkl"), "wb") as f:
            pickle.dump(
                {
                    "params": self.learner.get_weights(),
                    "iteration": self.iteration,
                },
                f,
            )
        return path

    def restore(self, path: str) -> None:
        with open(os.path.join(path, "weights.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_weights(state["params"])
        self.iteration = state["iteration"]
        self.env_runners.sync_weights(self.learner.get_weights())

    def stop(self) -> None:
        self.env_runners.shutdown()
        shutdown = getattr(self.learner, "shutdown", None)
        if shutdown is not None:
            shutdown()


class DecoupledPPO:
    """PPO rewired onto the decoupled dataflow (ISSUE 13): same
    config surface, same `train()` result keys as `PPO`, but rollout
    collection, policy inference and learning run as pipelined stages
    over the rollout queue instead of alternating behind a gather
    barrier. One `train()` = `updates_per_iteration` learner updates,
    each consuming the same row count the synchronous path samples
    per iteration — updates-per-env-step parity is what keeps the
    rlbench comparison honest."""

    def __init__(self, config: PPOConfig):
        from .dataflow import DataflowConfig, RLDataflow

        self.config = config
        probe = make_env(config.env_spec, seed=0)
        self.learner = TorchLearner(
            obs_size=probe.observation_size,
            num_actions=probe.num_actions,
            lr=config.lr,
            clip_eps=config.clip_eps,
            vf_coef=config.vf_coef,
            entropy_coef=config.entropy_coef,
            minibatch_size=config.minibatch_size,
            num_epochs=config.num_epochs,
            hidden=config.hidden,
            seed=config.seed,
            device=config.device,
        )
        self.flow = RLDataflow(
            self.learner,
            env_spec=config.env_spec,
            obs_size=probe.observation_size,
            num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            rollout_length=config.rollout_length,
            gamma=config.gamma,
            gae_lambda=config.gae_lambda,
            seed=config.seed,
            algo="ppo",
            flow=DataflowConfig(
                policy=config.dataflow_policy,
                queue_capacity=config.queue_capacity,
                max_weight_lag=config.max_weight_lag,
                sync_interval_updates=config.sync_interval_updates,
            ),
        )
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        rows = (
            self.config.num_env_runners
            * self.config.num_envs_per_runner
            * self.config.rollout_length
        )
        metrics: Dict[str, Any] = {}
        for _ in range(max(1, self.config.updates_per_iteration)):
            metrics = self.flow.train_update()
        self.iteration += 1
        stats = self.flow.stats()
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": stats["episode_return_mean"],
            "num_env_steps_sampled": rows
            * max(1, self.config.updates_per_iteration),
            "env_steps_total": stats["env_steps"],
            **metrics,
        }

    # -- checkpointing (same format as PPO.save/restore) --------------
    def save(self, path: Optional[str] = None) -> str:
        path = path or tempfile.mkdtemp(prefix="rt_ppo_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "weights.pkl"), "wb") as f:
            pickle.dump(
                {
                    "params": self.learner.get_weights(),
                    "iteration": self.iteration,
                },
                f,
            )
        return path

    def restore(self, path: str) -> None:
        from .weight_sync import push_weights

        with open(os.path.join(path, "weights.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_weights(state["params"])
        self.iteration = state["iteration"]
        # Restored weights must reach the serving side like any
        # learner update: a drainless versioned push.
        self.flow._version += 1
        push_weights(
            self.learner.get_weights(),
            self.flow._version,
            engines=(
                [self.flow._engine]
                if self.flow._engine is not None else []
            ),
            store=self.flow._store,
            queue=self.flow._queue,
        )

    def stop(self) -> None:
        self.flow.shutdown()
