"""Mixture of experts with expert parallelism (PyTorch port of
`ray_tpu/ops/moe.py`).

Top-k routing with the Switch/GShard load-balancing loss; capacity-based
dispatch, where the (token, choice) pairs past an expert's capacity drop
to the residual path; a dense reference in which every expert runs on
every token; and the expert-parallel FFN, whose experts are sharded over
an `ep` process group and reached by two all_to_alls. The dense FFN
also runs with its experts sharded on their `mlp` dim over a `tp`
process group, as GSPMD shards them under the JAX package's
`make_train_step`.

Where the JAX package builds one-hot dispatch and combine tensors
[tokens, experts, capacity] and contracts them, the port scatters and
gathers rows by index: the same outputs, aux loss and dropped tokens.
The dispatch order is the JAX code's, token-major: (token 0, choice 0),
(token 0, choice 1), (token 1, choice 0), ... take their expert's buffer
positions in that order, so at capacity the later tokens' choices drop.
(A comment in the JAX source calls the order "choice-major"; its code
is token-major.) The GELU is the tanh approximation, `jax.nn.gelu`'s
default.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.collective import Group, all_to_all, allreduce, axis_size


def init_moe_params(num_experts: int, d_model: int, d_ff: int,
                    generator: Optional[torch.Generator] = None,
                    dtype=torch.float32, device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Router [d, E] and expert weights w_in [E, d, f], w_out [E, f, d],
    normal * 1/sqrt(fan_in), drawn from `generator`."""

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device)
        return (x * (1.0 / math.sqrt(fan_in))).to(dtype)

    return {
        "router": normal((d_model, num_experts), d_model),
        "w_in": normal((num_experts, d_model, d_ff), d_model),
        "w_out": normal((num_experts, d_ff, d_model), d_ff),
    }


def top_k_router(logits: torch.Tensor, k: int,
                 batch_groups: Sequence[Group] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[tokens, experts] -> (gates [t, k], indices [t, k], aux_loss).

    aux_loss is the Switch/GShard load-balancing loss: the fraction of
    tokens whose FIRST choice is each expert, times the mean router
    probability of that expert, summed and scaled by the number of
    experts. With `batch_groups` (the process groups a batch is split
    over in equal shards) both means are the whole batch's, as JAX's
    GSPMD takes them over a batch sharded on the data axes."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, indices = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    num_experts = logits.shape[-1]
    assign = torch.bincount(indices[:, 0], minlength=num_experts).float() \
        / logits.shape[0]
    importance = probs.mean(dim=0)
    for group in batch_groups:
        assign = allreduce(assign, group, "mean")
        importance = allreduce(importance, group, "mean")
    aux_loss = num_experts * torch.sum(assign * importance)
    return gates, indices, aux_loss


def _dispatch(indices: torch.Tensor, gates: torch.Tensor, num_experts: int,
              capacity: int):
    """The kept (token, choice) pairs, token-major: (token, slot in the
    expert-major buffer [E * capacity], gate) of each."""
    t, k = indices.shape
    flat = indices.reshape(-1)
    onehot = F.one_hot(flat, num_experts)
    position = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    keep = position < capacity
    token = torch.arange(t, device=indices.device).repeat_interleave(k)
    slot = flat * capacity + position
    return token[keep], slot[keep], gates.reshape(-1)[keep]


def _expert_ffn(h: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor):
    """[E, n, d] rows through their expert: gelu(h @ w_in) @ w_out."""
    return F.gelu(torch.bmm(h, w_in), approximate="tanh").bmm(w_out)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, gradient summed over the group backward:
    Megatron's f. Every rank of a tensor-parallel group holds the same
    loss, so an input they share gets its gradient summed over the
    ranks' partial products, not counted once per rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOverGroup(torch.autograd.Function):
    """Sum over the group forward, identity backward: Megatron's g, for
    an output of partial sums that every rank then holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def moe_ffn_dense(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  k: int = 2, batch_groups: Sequence[Group] = (),
                  tp_group: Group = None):
    """Single-device reference, every expert local and run on every
    token. x: [tokens, d] -> (out [tokens, d], aux); `batch_groups` as
    `top_k_router`'s.

    With `tp_group` the experts are tensor-parallel over it, as GSPMD
    shards them on `mlp` under the JAX package's `make_train_step`:
    `w_in` [E, d, f/tp] and `w_out` [E, f/tp, d] are this rank's shards,
    the router and x whole and the same on every rank. Each rank runs
    the expert products on its `mlp` shard (the tanh-GELU is elementwise
    there), and the w_out products' partial sums of the top-k picks are
    summed over the group before the gates weigh them (the pick of the
    sum is the sum of the picks, element for element, at k/E of the
    bytes). Every tp rank holds the same loss, so the sum's backward is
    the identity and x's gradient through the experts is summed over the
    group (Megatron's g and f)."""
    logits = x @ params["router"]
    gates, indices, aux = top_k_router(logits, k, batch_groups)
    num_experts = params["w_in"].shape[0]
    shared = x if tp_group is None else _CopyToGroup.apply(x, tp_group)
    outs = _expert_ffn(shared.expand(num_experts, *x.shape), params["w_in"],
                       params["w_out"])  # [E, t, d]
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    picked = outs[indices, rows]  # [t, k, d]
    if tp_group is not None:
        picked = _SumOverGroup.apply(picked, tp_group)
    return torch.sum(picked * gates[:, :, None].to(x.dtype), dim=1), aux


def moe_ffn_ep(params: Dict[str, torch.Tensor], x: torch.Tensor,
               group: Group = None, *, k: int = 2,
               capacity_factor: float = 2.0):
    """Expert-parallel MoE over the `ep` process group `group`.

    Each rank holds E_local = E / ep experts (`w_in`/`w_out` sharded on
    the expert dim, the router whole) and a token shard x: [t_local, d].
    One all_to_all sends each rank's per-expert buffers to the expert's
    owner, the experts run dense over every source rank's buffers, and a
    second all_to_all returns the outputs. Returns (out, aux), aux being
    this rank's load-balancing loss over its own tokens."""
    ep = axis_size(group)
    e_local = params["w_in"].shape[0]
    num_experts = e_local * ep
    t_local, d = x.shape
    capacity = max(int(math.ceil(k * t_local * capacity_factor
                                 / num_experts)), 1)

    logits = x @ params["router"]
    gates, indices, aux = top_k_router(logits, k)
    token, slot, gate = _dispatch(indices, gates, num_experts, capacity)
    buffers = x.new_zeros(num_experts * capacity, d).index_add(
        0, slot, x[token])
    # [ep, E_local, C, d] by owner -> [ep, E_local, C, d] by source rank.
    buffers = all_to_all(buffers.view(ep, e_local, capacity, d), group,
                         split_axis=0, concat_axis=0)
    h = buffers.transpose(0, 1).reshape(e_local, ep * capacity, d)
    h = _expert_ffn(h, params["w_in"], params["w_out"])
    h = h.view(e_local, ep, capacity, d).transpose(0, 1)
    h = all_to_all(h, group, split_axis=0, concat_axis=0)
    h = h.reshape(num_experts * capacity, d)
    out = x.new_zeros(t_local, d).index_add(
        0, token, h[slot] * gate[:, None].to(h.dtype))
    return out, aux
