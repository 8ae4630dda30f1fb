# Copied from ray_tpu/rl/env.py (JAX-free).
"""Environments.

Reference: RLlib consumes Farama-gymnasium envs (rllib/env/). The
framework ships a dependency-free numpy CartPole (standard dynamics,
the classic control benchmark RLlib's smoke tests train on) plus a
vectorized wrapper matching the gymnasium reset/step contract.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class CartPoleEnv:
    """CartPole-v1 dynamics (standard published constants)."""

    observation_size = 4
    num_actions = 2
    max_episode_steps = 500

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5  # half-pole
        self.force_mag = 10.0
        self.tau = 0.02
        self.x_threshold = 2.4
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.state: Optional[np.ndarray] = None
        self._steps = 0

    def reset(self) -> np.ndarray:
        self.state = self._rng.uniform(-0.05, 0.05, size=4).astype(
            np.float32
        )
        self._steps = 0
        return self.state.copy()

    def step(
        self, action: int
    ) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        assert self.state is not None, "call reset() first"
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (
            force + polemass_length * theta_dot**2 * sintheta
        ) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array(
            [x, x_dot, theta, theta_dot], dtype=np.float32
        )
        self._steps += 1
        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold
            or theta > self.theta_threshold
        )
        truncated = self._steps >= self.max_episode_steps
        return self.state.copy(), 1.0, terminated, truncated, {}


class VectorEnv:
    """N independent envs stepped together with auto-reset
    (reference: gymnasium SyncVectorEnv semantics used by
    SingleAgentEnvRunner)."""

    def __init__(self, make_env, num_envs: int, seed: int = 0):
        self.envs = [make_env(seed + i) for i in range(num_envs)]
        self.num_envs = num_envs

    def reset(self) -> np.ndarray:
        return np.stack([env.reset() for env in self.envs])

    def step(self, actions: np.ndarray):
        obs, rewards, terminateds, truncateds = [], [], [], []
        for env, action in zip(self.envs, actions):
            o, r, term, trunc, _ = env.step(int(action))
            if term or trunc:
                o = env.reset()
            obs.append(o)
            rewards.append(r)
            terminateds.append(term)
            truncateds.append(trunc)
        return (
            np.stack(obs),
            np.asarray(rewards, dtype=np.float32),
            np.asarray(terminateds),
            np.asarray(truncateds),
        )


ENV_REGISTRY = {"CartPole-v1": CartPoleEnv}


def make_env(name_or_cls, seed: int = 0):
    if isinstance(name_or_cls, str):
        cls = ENV_REGISTRY[name_or_cls]
    else:
        cls = name_or_cls
    return cls(seed=seed)
