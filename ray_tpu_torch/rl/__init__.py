"""Reinforcement learning of the PyTorch/CUDA port (counterpart of
`ray_tpu/rl`; reference: rllib/ new API stack — EnvRunnerGroup +
Learner + Algorithm), plus the decoupled Sebulba-style dataflow
(dataflow.py / rollout_queue.py / weight_sync.py):
`PPOConfig().dataflow()` / `DQNConfig().dataflow()` switch either
algorithm from the synchronous sample -> update -> broadcast loop onto
pipelined rollout/learner stages with engine-served policy inference
and drainless weight sync. The learners and the policy engine run on
"cuda" unless the caller asks for the CPU; the env runners sample on
the host, as the reference's do. `env`, `actor_manager`,
`rollout_queue` and `weight_sync` are copies of the JAX package's."""

from .actor_manager import CallResult, FaultTolerantActorManager
from .dataflow import (
    DataflowConfig,
    PolicyEngineActor,
    PolicyProgram,
    RLDataflow,
)
from .dqn import DQN, DecoupledDQN, DQNConfig, DQNLearner, ReplayBuffer
from .env import ENV_REGISTRY, CartPoleEnv, VectorEnv, make_env
from .env_runner import EnvRunnerGroup, SingleAgentEnvRunner
from .learner import TorchLearner
from .learner_group import LearnerGroup
from .ppo import PPO, DecoupledPPO, PPOConfig
from .rollout_queue import RolloutQueue
from .weight_sync import WeightStore, push_weights

__all__ = [
    "CartPoleEnv",
    "VectorEnv",
    "ENV_REGISTRY",
    "make_env",
    "SingleAgentEnvRunner",
    "EnvRunnerGroup",
    "FaultTolerantActorManager",
    "CallResult",
    "TorchLearner",
    "LearnerGroup",
    "PPO",
    "PPOConfig",
    "DecoupledPPO",
    "DQN",
    "DQNConfig",
    "DQNLearner",
    "DecoupledDQN",
    "ReplayBuffer",
    "RLDataflow",
    "DataflowConfig",
    "PolicyProgram",
    "PolicyEngineActor",
    "RolloutQueue",
    "WeightStore",
    "push_weights",
]
