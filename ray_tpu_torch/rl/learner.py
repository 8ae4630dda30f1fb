"""TorchLearner: the gradient-update half of the algorithm (PyTorch port
of `ray_tpu/rl/learner.py`'s `JaxLearner`).

Reference: rllib/core/learner/ - TorchLearner wraps DDP around
compute_gradients/apply_gradients (torch_learner.py:171,192) and
LearnerGroup fans batches across learner actors (learner_group.py:81,
167). Here one learner holds the policy on one device ("cuda" unless the
caller asks for the CPU) and runs the PPO update eagerly; several
learners exchange gradients through `LearnerGroup`.

The update is the JAX learner's, term for term, so the two agree on one
batch and seed: the same `np.random.default_rng(seed)` permutation per
epoch with the ragged tail dropped; the advantages normalised by their
population std (`jnp.std`); gradients clipped by their global norm as
`optax.clip_by_global_norm` does (scaled by max_norm / norm only when
norm >= max_norm; `torch.nn.utils.clip_grad_norm_` adds 1e-6 to the
norm, so the clip is written out); then `torch.optim.Adam` with
eps 1e-8, which computes `optax.adam`'s update, m_hat / (sqrt(v_hat) +
eps) with eps_root 0 (held to `optax.adam` in
`tests/test_torch_rl.py`).

Compile watch: the minibatch update, the gradient computation and the
gradient application are the programs `rl.ppo.minibatch_update`,
`rl.ppo.compute_gradients` and `rl.ppo.apply_gradients`, the JAX
learner's names.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._private import compile_watch
from .models import (
    apply_policy,
    init_policy_params,
    load_jax_policy_params,
    to_f32,
    to_jax_policy_params,
)

_BATCH_KEYS = ("obs", "actions", "logp", "advantages", "value_targets")


def resolve_device(device: Any) -> torch.device:
    """`device` as a torch.device; "cuda" must see a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for and no CUDA device is visible; "
            "pass device='cpu' to run on the CPU")
    return device


def adam(params, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm(grads, max_norm: float) -> None:
    """`optax.clip_by_global_norm(max_norm)` in place: every gradient
    scaled by max_norm / norm when the global norm reaches max_norm
    (no epsilon; no host sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)


class TorchLearner:
    def __init__(
        self,
        obs_size: int,
        num_actions: int,
        *,
        lr: float = 3e-4,
        clip_eps: float = 0.2,
        vf_coef: float = 0.5,
        entropy_coef: float = 0.01,
        minibatch_size: int = 256,
        num_epochs: int = 4,
        max_grad_norm: float = 0.5,
        hidden: Tuple[int, ...] = (64, 64),
        seed: int = 0,
        device: Any = "cuda",
    ):
        self.device = resolve_device(device)
        self.params = init_policy_params(
            torch.Generator().manual_seed(seed), obs_size, num_actions,
            hidden, device=self.device)
        self.optimizer = adam(self.params.parameters(), lr)
        self.max_grad_norm = max_grad_norm
        self.clip_eps = clip_eps
        self.vf_coef = vf_coef
        self.entropy_coef = entropy_coef
        self.minibatch_size = minibatch_size
        self.num_epochs = num_epochs
        self._rng = np.random.default_rng(seed)
        self._update_jit = compile_watch.instrument(
            "rl.ppo.minibatch_update", self._minibatch_update)
        # Split-phase entry points for the multi-learner path
        # (learner_group.py): gradients computed per shard, applied
        # identically everywhere after averaging.
        self._grad_jit = compile_watch.instrument(
            "rl.ppo.compute_gradients", self._gradients)
        self._apply_jit = compile_watch.instrument(
            "rl.ppo.apply_gradients", self._step)

    # -- PPO loss (reference: ppo_torch_learner compute_loss) ---------
    def _loss(self, batch: Dict[str, torch.Tensor]):
        logits, values = apply_policy(self.params, batch["obs"])
        logp_all = F.log_softmax(logits, -1)
        logp = logp_all.gather(1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - self.clip_eps,
                              1 + self.clip_eps) * adv
        policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
        vf_loss = torch.mean((values - batch["value_targets"]) ** 2)
        entropy = -torch.mean(
            torch.sum(F.softmax(logits, -1) * logp_all, 1))
        total = (policy_loss + self.vf_coef * vf_loss
                 - self.entropy_coef * entropy)
        return total, {
            "policy_loss": policy_loss.detach(),
            "vf_loss": vf_loss.detach(),
            "entropy": entropy.detach(),
        }

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k in _BATCH_KEYS:
            v = batch[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))
            v = v.to(self.device)
            out[k] = v.long() if k == "actions" else v.float()
        return out

    def _step(self, grads) -> None:
        params = list(self.params.parameters())
        for p, g in zip(params, grads):
            p.grad = g
        clip_by_global_norm(grads, self.max_grad_norm)
        self.optimizer.step()
        for p in params:
            p.grad = None

    def _minibatch_update(self, minibatch: Dict[str, torch.Tensor]):
        """One minibatch's loss, gradients and optimizer step: the
        metrics as 0-d tensors."""
        loss, metrics = self._loss(minibatch)
        params = [p for _, p in self.params.named_parameters()]
        self._step(list(torch.autograd.grad(loss, params)))
        return dict(metrics, total_loss=loss.detach())

    def _gradients(self, minibatch: Dict[str, torch.Tensor]):
        loss, metrics = self._loss(minibatch)
        names, params = zip(*self.params.named_parameters())
        grads = torch.autograd.grad(loss, params)
        return dict(zip(names, grads)), dict(metrics,
                                             total_loss=loss.detach())

    # -- split-phase API (multi-learner) ------------------------------
    def compute_gradients(self, minibatch) -> Tuple[Dict, Dict]:
        """Gradients of the PPO loss on one minibatch, by parameter name
        (`PolicyNet` state-dict names), and its metrics as 0-d tensors;
        params unchanged."""
        return self._grad_jit(self.to_device(minibatch))

    def apply_gradients(self, grads) -> None:
        """One optimizer step (global-norm clip, then Adam) from gradients
        by parameter name (tensors or numpy arrays)."""
        self._apply_jit([to_f32(grads[name], self.device).clone()
                         for name, _ in self.params.named_parameters()])

    # -- public --------------------------------------------------------
    def update(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """Epochs of shuffled minibatch SGD over one sample batch
        (reference: ppo.py training_step's learner update)."""
        n = len(batch["obs"])
        device_batch = self.to_device(batch)
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(self.num_epochs):
            perm = torch.from_numpy(self._rng.permutation(n)).to(
                self.device)
            for start in range(0, n, self.minibatch_size):
                idx = perm[start:start + self.minibatch_size]
                if len(idx) < self.minibatch_size and start > 0:
                    continue  # drop the ragged tail, as the reference
                minibatch = {k: v[idx] for k, v in device_batch.items()}
                metrics = self._update_jit(minibatch)
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self) -> Dict[str, Any]:
        """The JAX package's tree of numpy arrays."""
        return to_jax_policy_params(self.params)

    def set_weights(self, params) -> None:
        """Load a tree (numpy or tensors), a state dict or a `PolicyNet`;
        the optimizer state is kept, as the reference keeps it."""
        loaded = load_jax_policy_params(params, device="cpu")
        with torch.no_grad():
            for p, v in zip(self.params.parameters(), loaded.parameters()):
                p.copy_(v)
