"""Policy/value network (PyTorch port of `ray_tpu/rl/models.py`).

Reference: rllib/core/rl_module/ - an RLModule owns the neural nets for
the action distribution and the value function. The JAX package keeps
the MLP as a parameter tree plus a pure `apply_policy`; here it is a
`PolicyNet` module with the same tree, named the same way
(`layers[i].{w,b}`, `pi.{w,b}`, `vf.{w,b}`), its weights stored
`[fan_in, fan_out]` as JAX's are, so `x @ w + b` reads the same.

Weights travel between processes (learner, runners, policy engine,
checkpoints) as the JAX package's tree of numpy arrays
(`to_jax_policy_params`), so a checkpoint of either package loads in
the other and the parity tests hand JAX's initial weights to the port
(`load_jax_policy_params`): `jax.random.orthogonal` cannot be
reproduced in torch, so the port's own init (`init_policy_params`)
draws its orthogonal matrices from an explicit CPU `torch.Generator`.

`sample_actions` runs through the compile-watch program
`rl.sample_actions`, the JAX package's name.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from .._private import compile_watch

__all__ = [
    "PolicyNet",
    "init_policy_params",
    "apply_policy",
    "sample_actions",
    "load_jax_policy_params",
    "to_jax_policy_params",
    "policy_state",
    "to_f32",
]


class Dense(nn.Module):
    """`x @ w + b`, `w` stored [fan_in, fan_out] as in the JAX tree."""

    def __init__(self, fan_in: int, fan_out: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out, device=device))
        self.b = nn.Parameter(torch.zeros(fan_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class PolicyNet(nn.Module):
    """tanh MLP trunk with a policy head (`pi`, one logit per action) and
    a value head (`vf`). DQN reads the `pi` head as its Q values."""

    def __init__(self, obs_size: int, num_actions: int,
                 hidden: Tuple[int, ...] = (64, 64), device: Any = "cuda"):
        super().__init__()
        sizes = (obs_size, *hidden)
        self.layers = nn.ModuleList(
            Dense(fan_in, fan_out, device)
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:]))
        self.pi = Dense(hidden[-1], num_actions, device)
        self.vf = Dense(hidden[-1], 1, device)

    def forward(self, obs: torch.Tensor):
        """obs [B, obs_size] -> (logits [B, A], value [B])."""
        x = obs
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return self.pi(x), self.vf(x)[:, 0]

    @property
    def device(self) -> torch.device:
        return self.pi.w.device


def _orthogonal(generator: torch.Generator, n: int) -> torch.Tensor:
    """An n x n orthogonal matrix drawn uniformly (QR of a Gaussian, the
    signs fixed by R's diagonal), as `jax.random.orthogonal` draws one."""
    a = torch.randn(n, n, generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))).float()


def init_policy_params(generator: torch.Generator, obs_size: int,
                       num_actions: int, hidden: Tuple[int, ...] = (64, 64),
                       device: Any = "cuda") -> PolicyNet:
    """The reference's init: orthogonal trunk layers scaled by sqrt(2), a
    0.01-scaled policy head, a unit value head, zero biases. `generator`
    is a CPU generator, so one seed gives the same weights on any
    device."""
    sizes = (obs_size, *hidden)
    net = PolicyNet(obs_size, num_actions, hidden, device)
    with torch.no_grad():
        for layer, fan_in, fan_out in zip(net.layers, sizes[:-1], sizes[1:]):
            w = _orthogonal(generator, max(fan_in, fan_out))
            layer.w.copy_(w[:fan_in, :fan_out] * np.sqrt(2.0))
        w = _orthogonal(generator, max(hidden[-1], num_actions))
        net.pi.w.copy_(w[:hidden[-1], :num_actions] * 0.01)
        net.vf.w.copy_(_orthogonal(generator, hidden[-1])[:, :1])
    return net


def _policy_device(params) -> torch.device:
    if isinstance(params, nn.Module):
        return next(params.parameters()).device
    return torch.device("cpu")


def to_f32(a, device=None) -> torch.Tensor:
    """`a` as an f32 tensor on `device`; a numpy array is copied (arrays
    read from the object store are read-only views)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def apply_policy(params: Union[PolicyNet, Dict], obs):
    """obs [B, obs_size] -> (logits [B, A], value [B]). `params` is a
    `PolicyNet` or the JAX package's tree (numpy or tensors)."""
    if not isinstance(obs, torch.Tensor):
        obs = to_f32(obs, _policy_device(params))
    if isinstance(params, nn.Module):
        return params(obs)

    def leaf(a):
        return to_f32(a, obs.device)

    x = obs
    for layer in params["layers"]:
        x = torch.tanh(x @ leaf(layer["w"]) + leaf(layer["b"]))
    logits = x @ leaf(params["pi"]["w"]) + leaf(params["pi"]["b"])
    value = (x @ leaf(params["vf"]["w"]) + leaf(params["vf"]["b"]))[:, 0]
    return logits, value


@torch.no_grad()
def _sample(params, obs, generator: torch.Generator):
    logits, value = apply_policy(params, obs)
    actions = torch.multinomial(torch.softmax(logits, -1), 1,
                                generator=generator)
    logp = torch.log_softmax(logits, -1).gather(1, actions)[:, 0]
    return actions[:, 0], logp, value


_sample_prog = compile_watch.instrument("rl.sample_actions", _sample)


def sample_actions(params, obs, generator: torch.Generator):
    """Inference-side sampling used by env runners: (actions, logp,
    value) as numpy, and the generator (advanced in place; returned so
    call sites read as the reference's, which threads its key)."""
    actions, logp, value = _sample_prog(params, obs, generator)
    return (
        actions.cpu().numpy(),
        logp.cpu().numpy(),
        value.cpu().numpy(),
        generator,
    )


def policy_state(params) -> Dict[str, Any]:
    """`PolicyNet` state-dict names -> leaves, from a `PolicyNet`, a state
    dict or the JAX package's tree (its leaves as they are)."""
    if isinstance(params, nn.Module):
        return dict(params.state_dict())
    if "layers" not in params:
        return dict(params)
    state = {}
    for i, layer in enumerate(params["layers"]):
        state[f"layers.{i}.w"] = layer["w"]
        state[f"layers.{i}.b"] = layer["b"]
    for head in ("pi", "vf"):
        state[f"{head}.w"] = params[head]["w"]
        state[f"{head}.b"] = params[head]["b"]
    return state


def load_jax_policy_params(np_tree, device: Any = "cuda") -> PolicyNet:
    """A `PolicyNet` on `device` holding the weights of the JAX package's
    tree (leaves numpy arrays or tensors; a state dict or a `PolicyNet`
    is taken too)."""
    state = {k: to_f32(v).cpu() for k, v in policy_state(np_tree).items()}
    n_layers = sum(1 for k in state if k.endswith(".w")) - 2
    hidden = tuple(state[f"layers.{i}.w"].shape[1] for i in range(n_layers))
    obs_size, num_actions = (state["layers.0.w"].shape[0],
                             state["pi.w"].shape[1])
    net = PolicyNet(obs_size, num_actions, hidden, device)
    net.load_state_dict(state)
    return net


def to_jax_policy_params(params) -> Dict[str, Any]:
    """Inverse of `load_jax_policy_params`: the JAX package's tree of f32
    numpy arrays (each a copy)."""
    state = {k: to_f32(v).detach().cpu().numpy().copy()
             for k, v in policy_state(params).items()}
    n_layers = sum(1 for k in state if k.endswith(".w")) - 2
    return {
        "layers": [{"w": state[f"layers.{i}.w"], "b": state[f"layers.{i}.b"]}
                   for i in range(n_layers)],
        "pi": {"w": state["pi.w"], "b": state["pi.b"]},
        "vf": {"w": state["vf.w"], "b": state["vf.b"]},
    }
