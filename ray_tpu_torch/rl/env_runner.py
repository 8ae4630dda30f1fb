"""Env runners: parallel rollout collection (PyTorch port of
`ray_tpu/rl/env_runner.py`).

Reference: rllib/env/env_runner_group.py:70 + single_agent_env_runner
— a group of actor-hosted runners samples with the current policy and
returns batches; weights broadcast after each learner update. GAE is
computed runner-side at sample time (reference: ConnectorV2
GeneralAdvantageEstimation on the learner pipeline; moved here so the
learner consumes ready minibatches).

Placement: a runner samples on the host CPU (`device="cpu"`), as the
reference's runners do. They ask no accelerator (`num_cpus=1`), and the
runtime hides the cards from such a worker, as the reference's daemon
gives them `JAX_PLATFORMS=cpu`. The learner and the policy engine
(`dataflow.py`) hold the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def compute_gae(
    rew_buf: np.ndarray,  # [T, N]
    val_buf: np.ndarray,  # [T, N]
    done_buf: np.ndarray,  # [T, N] TERMINATIONS only
    last_values: np.ndarray,  # [N] bootstrap values of obs T
    gamma: float,
    lam: float,
) -> np.ndarray:
    """The GAE backward pass, shared by the synchronous runner and
    the decoupled dataflow runner (ISSUE 13: one copy of the math
    both comparison sides must agree on). Bootstraps through
    truncation but not termination — `done_buf` carries terminated
    flags only."""
    T, N = rew_buf.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    for t in reversed(range(T)):
        next_value = val_buf[t + 1] if t + 1 < T else last_values
        nonterminal = 1.0 - done_buf[t].astype(np.float32)
        delta = (
            rew_buf[t]
            + gamma * next_value * nonterminal
            - val_buf[t]
        )
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
    return adv


class SingleAgentEnvRunner:
    """Actor body: vectorized envs + CPU policy inference."""

    #: The reference's placement (module docstring), not a fallback.
    device = "cpu"

    def __init__(
        self,
        env_spec,
        num_envs: int = 8,
        rollout_length: int = 64,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        seed: int = 0,
    ):
        import torch

        from .env import VectorEnv, make_env

        self.vec = VectorEnv(
            lambda s: make_env(env_spec, seed=s), num_envs, seed=seed
        )
        self.rollout_length = rollout_length
        self.gamma = gamma
        self.lam = gae_lambda
        self.params = None
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._obs = self.vec.reset()
        # Per-env accumulators for episode-return reporting.
        self._ep_returns = np.zeros(num_envs)
        self._finished_returns: List[float] = []

    def set_weights(self, params) -> bool:
        from .models import load_jax_policy_params

        self.params = load_jax_policy_params(params, self.device)
        return True

    def ping(self) -> str:
        return "ok"

    def sample(self) -> Dict[str, np.ndarray]:
        from .models import sample_actions

        assert self.params is not None, "set_weights first"
        T, N = self.rollout_length, self.vec.num_envs
        obs_buf = np.zeros((T, N, self._obs.shape[1]), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        for t in range(T):
            actions, logp, values, self._gen = sample_actions(
                self.params, self._obs, self._gen
            )
            obs_buf[t] = self._obs
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = values
            next_obs, rewards, terminated, truncated = self.vec.step(
                actions
            )
            rew_buf[t] = rewards
            # GAE bootstraps through truncation but not termination.
            done_buf[t] = terminated
            self._ep_returns += rewards
            for i in range(N):
                if terminated[i] or truncated[i]:
                    self._finished_returns.append(
                        float(self._ep_returns[i])
                    )
                    self._ep_returns[i] = 0.0
            self._obs = next_obs
        _, _, last_values, self._gen = sample_actions(
            self.params, self._obs, self._gen
        )
        adv = compute_gae(
            rew_buf, val_buf, done_buf, last_values,
            self.gamma, self.lam,
        )
        returns = adv + val_buf
        flat = lambda a: a.reshape(-1, *a.shape[2:])  # noqa: E731
        episode_returns = self._finished_returns
        self._finished_returns = []
        return {
            "obs": flat(obs_buf),
            "actions": flat(act_buf),
            "logp": flat(logp_buf),
            "advantages": flat(adv),
            "value_targets": flat(returns),
            "episode_returns": np.asarray(episode_returns, np.float32),
        }


class EnvRunnerGroup:
    """Fault-tolerant fan-out over runner actors (reference:
    env_runner_group.py sample + weight sync, with
    rllib/utils/actor_manager.py:198 FaultTolerantActorManager
    underneath: a runner dying mid-iteration costs its shard of the
    sample, never the iteration; the dead slot is respawned and
    re-synced on the next sample)."""

    def __init__(
        self,
        env_spec,
        num_env_runners: int = 2,
        num_envs_per_runner: int = 8,
        rollout_length: int = 64,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        seed: int = 0,
    ):
        import ray_tpu_torch as rt

        from .actor_manager import FaultTolerantActorManager

        self._rt = rt
        self._latest_weights_ref = None
        runner_cls = rt.remote(num_cpus=1)(SingleAgentEnvRunner)

        def make_runner(i: int):
            return runner_cls.remote(
                env_spec,
                num_envs_per_runner,
                rollout_length,
                gamma,
                gae_lambda,
                seed + 1000 * i,
            )

        def restore_runner(_idx: int, handle) -> None:
            # A respawned runner holds no policy: re-sync before it
            # samples (reference: restored-worker weight sync).
            if self._latest_weights_ref is not None:
                rt.get(
                    handle.set_weights.remote(
                        self._latest_weights_ref
                    ),
                    timeout=120,
                )

        self.manager = FaultTolerantActorManager(
            [make_runner(i) for i in range(num_env_runners)],
            actor_factory=make_runner,
            on_restore=restore_runner,
        )

    @property
    def runners(self) -> List:
        return [
            self.manager.actor(idx)
            for idx in sorted(self.manager._actors)
        ]

    def num_healthy_runners(self) -> int:
        return self.manager.num_healthy_actors()

    def sync_weights(self, params) -> None:
        """Broadcast weights with ONE concurrent fan-out (the
        manager's rt.wait gather — no serial per-runner round-trips;
        ISSUE 13 satellite). A dead runner never fails the call: its
        slot is pruned from the healthy set and restored-and-resynced
        in the same pass (on_restore pushes this very ref)."""
        self._latest_weights_ref = self._rt.put(params)
        results = self.manager.foreach_actor(
            "set_weights", self._latest_weights_ref, timeout=120
        )
        if any(not r.ok for r in results):
            self.manager.probe_unhealthy_actors()

    def sample(self) -> Dict[str, np.ndarray]:
        # Heal dead slots from previous iterations first, then accept
        # whatever the healthy set returns this round.
        self.manager.probe_unhealthy_actors()
        results = self.manager.foreach_actor("sample", timeout=300)
        batches = self.manager.ok_values(results)
        if not batches:
            raise RuntimeError(
                "all env runners failed this iteration"
            )
        return {
            key: np.concatenate([b[key] for b in batches])
            for key in batches[0]
        }

    def shutdown(self) -> None:
        self.manager.shutdown()
