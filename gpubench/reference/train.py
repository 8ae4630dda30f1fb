"""The plain reference of the training cells: the first steps of next-token
training from the benchmark's weights, on the benchmark's batches, with
the optimizer the mix states (optax's chain: clip by global norm, then
AdamW under a warmup-cosine schedule read at the update count before it
is incremented).

Storage is as the configuration states it: parameters and AdamW's
moments in the parameters' dtype (bfloat16), each rounded once a step;
everything is computed in `matmul`'s precision and otherwise in f32.
Gradients wait in the parameters' dtype until the global norm is known.
The forward keeps each layer's input and the backward runs one layer at
a time, recomputing its forward, so a 7B model fits beside its state.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from .. import weights
from . import model as ref


def learning_rate(opt: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule from 0 to the peak, down to a
    tenth of it, as the mix's optimizer states it."""
    peak = opt["learning_rate"]
    warmup = min(opt["warmup_steps"], max(1, opt["total_steps"] // 10))
    decay = max(opt["total_steps"], warmup + 1)
    if count < warmup:
        return peak * count / warmup
    c = min(count - warmup, decay - warmup)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / (decay - warmup)))
    return peak * (0.9 * cosine + 0.1)


def _layer_f32(p: Dict[str, torch.Tensor], a: dict, i: int, grad: bool):
    return {leaf: p[f"layers.{i}.{leaf}"].float().requires_grad_(grad)
            for leaf in weights.layer_shapes(a)}


def loss_and_grads(p, tokens, targets, a: dict, mm, dtype):
    """Mean next-token cross-entropy over the targets >= 0, and every
    leaf's gradient (stored in `dtype`)."""
    b, t = tokens.shape
    cos, sin = ref.rope_tables(t, a["head_dim"], a["rope_theta"], tokens.device)
    x = p["embed"][tokens].float()
    saved = []
    with torch.no_grad():
        for i in range(a["layers"]):
            saved.append(x)
            x = ref.layer(x, _layer_f32(p, a, i, False), cos, sin, a, mm)
    grads = {}
    x = x.requires_grad_()
    fn = p["final_norm"].float().requires_grad_()
    hw = p["head"].float().requires_grad_()
    with torch.enable_grad():
        logits = ref.head(x, fn, hw, a, mm)
        keep = targets >= 0
        loss = F.cross_entropy(logits[keep], targets[keep])
        loss.backward()
    del logits
    grads["final_norm"], grads["head"] = fn.grad.to(dtype), hw.grad.to(dtype)
    dx = x.grad
    for i in reversed(range(a["layers"])):
        xin = saved[i].requires_grad_()
        w = _layer_f32(p, a, i, True)
        with torch.enable_grad():
            ref.layer(xin, w, cos, sin, a, mm).backward(dx)
        for leaf, wt in w.items():
            grads[f"layers.{i}.{leaf}"] = wt.grad.to(dtype)
        dx = xin.grad
        saved[i] = None
    emb = torch.zeros(p["embed"].shape, dtype=torch.float32, device=dx.device)
    emb.index_add_(0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    grads["embed"] = emb.to(dtype)
    return loss.item(), grads


def _norm(t: torch.Tensor) -> float:
    return torch.linalg.vector_norm(t, dtype=torch.float32).item()


def follow(a: dict, seed: int, batch: Callable[[int], tuple], steps: int,
           opt: dict, device, precision: str = "f32",
           state_device=None) -> dict:
    """Train `steps` steps from the benchmark's weights for `seed`, on
    `batch(k)` = (tokens, targets) of step k. Returns each step's loss,
    each leaf's first gradient as the optimizer gets it (after the
    clip), its unclipped norm, and each leaf's change after `steps`.
    `state_device` keeps the moments elsewhere (the host) when the card
    cannot hold them beside the step."""
    mm = ref.PRECISIONS[precision]
    p = dict(weights.all_weights(a, seed, device))
    dtype = p["embed"].dtype
    store = state_device or device
    m = {n: torch.zeros(x.shape, dtype=dtype, device=store) for n, x in p.items()}
    v = {n: torch.zeros(x.shape, dtype=dtype, device=store) for n, x in p.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses: List[float] = []
    first, raw = {}, {}
    for step in range(1, steps + 1):
        tokens, targets = batch(step)
        loss, g = loss_and_grads(p, tokens, targets, a, mm, dtype)
        losses.append(loss)
        norms = {n: _norm(x) for n, x in g.items()}
        gnorm = math.sqrt(sum(x * x for x in norms.values()))
        clip = opt["grad_clip"] / gnorm if gnorm >= opt["grad_clip"] else 1.0
        if step == 1:
            raw = norms
            first = {n: x * clip for n, x in norms.items()}
        lr = learning_rate(opt, step - 1)
        bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        for n in p:
            gi = g.pop(n).float() * clip
            mi = (b1 * m[n].to(device).float() + (1 - b1) * gi).to(dtype)
            vi = (b2 * v[n].to(device).float() + (1 - b2) * gi * gi).to(dtype)
            pf = p[n].float()
            upd = (mi.float() / bc1) / (torch.sqrt(vi.float() / bc2) + eps) + wd * pf
            p[n].copy_((pf - lr * upd).to(dtype))
            m[n].copy_(mi)
            v[n].copy_(vi)
        del g
    change = change_norms(p, a, seed, device)
    return {"losses": losses, "first_grad": first, "raw_grad": raw,
            "change": change}


def change_norms(p: Dict[str, torch.Tensor], a: dict, seed: int, device
                 ) -> Dict[str, float]:
    """Each leaf's distance from the benchmark's weights for `seed`,
    made again one group at a time."""
    out = {}
    for name, p0 in weights.all_weights(a, seed, device):
        out[name] = _norm(p[name].float() - p0.float())
    return out
