"""Single-device training step (PyTorch port of
`ray_tpu/train/train_step.py`).

`default_optimizer` reproduces the JAX package's optax chain
(`clip_by_global_norm` then `adamw` under a warmup-cosine schedule)
step for step: the schedule is read at the update count before it is
incremented, so the first update is exactly zero; the clip divides by
the global norm with no epsilon; the moments keep the parameter dtype.
Updates are applied in place (the counterpart of buffer donation).
The mesh, sharding and device prefetch belong to later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """Step count, the model (its parameters) and the optimizer state."""

    step: int
    params: nn.Module
    opt_state: Dict[str, Any]


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from `init_value` to
    `peak_value` over `warmup_steps`, then cosine down to `end_value` at
    `decay_steps` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """Global-norm clip, then AdamW (optax `scale_by_adam`,
    `add_decayed_weights`, `scale_by_learning_rate`) on every parameter,
    norms included."""

    def __init__(self, schedule: Callable[[int], float], b1: float,
                 b2: float, eps: float, weight_decay: float,
                 grad_clip: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict[str, Any], grad_norm: torch.Tensor) -> None:
        """Update `params` and `state` in place. `grad_norm` is the
        global norm of `grads`."""
        clip = grad_norm >= self.grad_clip
        count = state["count"] + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        lr = self.schedule(state["count"])
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = torch.where(clip, g / grad_norm.to(g.dtype) * self.grad_clip, g)
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = update + self.weight_decay * p
            p.add_(update * -lr)
        state["count"] = count


def default_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamW:
    """AdamW + warmup-cosine schedule + global-norm clipping, as the
    JAX package's `default_optimizer`."""
    warmup_steps = min(warmup_steps, max(1, total_steps // 10))
    schedule = warmup_cosine_decay(
        init_value=0.0,
        peak_value=learning_rate,
        warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=learning_rate * 0.1,
    )
    return AdamW(schedule, b1=b1, b2=b2, eps=1e-8,
                 weight_decay=weight_decay, grad_clip=grad_clip)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def make_train_step(loss_fn: Callable[..., torch.Tensor], optimizer: AdamW,
                    *, device="cuda"):
    """Build (init_fn, step_fn).

    loss_fn(model, tokens, targets) -> scalar loss.
    init_fn(model) -> TrainState with the model on `device`.
    step_fn(state, tokens, targets) -> (state, metrics): one step,
    updating the parameters in place; metrics {"loss", "grad_norm"}
    stay on the device (grad_norm of the gradients before clipping).
    """
    device = torch.device(device)

    def init_fn(model: nn.Module) -> TrainState:
        model = model.to(device)
        params = list(model.parameters())
        return TrainState(step=0, params=model,
                          opt_state=optimizer.init(params))

    def step_fn(state: TrainState, tokens, targets):
        model = state.params
        tokens = torch.as_tensor(tokens, device=device)
        targets = torch.as_tensor(targets, device=device)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss = loss_fn(model, tokens, targets)
        loss.backward()
        grads = [p.grad for p in params]
        gnorm = global_norm(grads)
        optimizer.apply(params, grads, state.opt_state, gnorm)
        for p in params:
            p.grad = None
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return init_fn, step_fn
