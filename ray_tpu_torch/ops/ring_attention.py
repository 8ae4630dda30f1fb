"""Ring and Ulysses attention over a sequence-sharded process group
(PyTorch port of `ray_tpu/ops/ring_attention.py`).

The sequence is sharded contiguously over the `sp` group: rank r holds
positions [r * t_local, (r + 1) * t_local). Ring attention computes
exact attention of the local queries against every rank's keys and
values while the KV shards travel the ring one hop per step, merging
the partial results with the online-softmax rule, in f32. Its backward
is an explicit ring too (`_RingAttention.backward`): the KV shards
travel again, each with its dK/dV accumulators, in the same order on
every rank, and after the last hop every accumulator is home.

Ulysses attention reshards with all_to_all from a sequence shard to a
head shard, attends over the whole sequence locally, and reshards back.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..parallel.collective import (
    Group,
    all_to_all,
    axis_index,
    axis_size,
    send_recv,
)
from .attention import DEFAULT_MASK_VALUE, mha_reference


def _logits(qf, kf, scale, causal, q_pos, k_pos):
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        logits = logits.masked_fill(q_pos[:, None] < k_pos[None, :],
                                    DEFAULT_MASK_VALUE)
    return logits


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, rank = axis_size(group), axis_index(group)
        t = q.shape[2]
        positions = torch.arange(t, device=q.device)
        q_pos = rank * t + positions
        qf = q.float()
        kv = torch.stack([k.float(), v.float()])
        acc = torch.zeros_like(qf)
        m = torch.full_like(qf[..., :1], -math.inf)
        l = torch.zeros_like(qf[..., :1])
        for s in range(n):
            # After s hops this rank holds the shard of rank - s.
            src = (rank - s) % n
            logits = _logits(qf, kv[0], scale, causal, q_pos,
                             src * t + positions)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, kv[1])
            m = m_new
            if s < n - 1:
                kv = send_recv(kv, group)
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out = acc / l_safe
        ctx.save_for_backward(q, k, v, out, m + torch.log(l_safe))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, rank = axis_size(group), axis_index(group)
        t = q.shape[2]
        positions = torch.arange(t, device=q.device)
        q_pos = rank * t + positions
        qf, do = q.float(), grad.float()
        delta = (do * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        kv = torch.stack([k.float(), v.float()])
        dkv = torch.zeros_like(kv)  # the accumulators of the shard held
        for s in range(n):
            src = (rank - s) % n
            logits = _logits(qf, kv[0], scale, causal, q_pos,
                             src * t + positions)
            p = torch.exp(logits - lse)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, kv[1]) - delta)
            dq += torch.einsum("bhqk,bhkd->bhqd", ds, kv[0]) * scale
            dkv[0] += torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
            dkv[1] += torch.einsum("bhqk,bhqd->bhkd", p, do)
            # One hop for the accumulators on every step, the last one
            # bringing each home; the shards themselves need n - 1.
            if s < n - 1:
                kv = send_recv(kv, group)
            dkv = send_recv(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Group, *, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence-sharded ring.

    q/k/v: local shards [batch, heads, t_local, head_dim] (k/v with as
    many heads as q). Returns the local output shard, in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, group, causal, scale)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: Group, *, causal: bool = True,
                      scale: Optional[float] = None,
                      attention_fn: Optional[Callable] = None
                      ) -> torch.Tensor:
    """Ulysses sequence parallelism: all_to_all from the sequence shard
    to a head shard ([b, H, t/n, d] -> [b, H/n, t, d]), attention over
    the whole sequence on the local heads (`mha_reference` unless
    `attention_fn(q, k, v)` is given), all_to_all back. Needs heads
    divisible by the group's size."""
    if attention_fn is None:
        def attention_fn(q, k, v):
            return mha_reference(q, k, v, causal=causal, scale=scale)

    def to_heads(x):
        return all_to_all(x, group, split_axis=1, concat_axis=2)

    out = attention_fn(to_heads(q), to_heads(k), to_heads(v))
    return all_to_all(out, group, split_axis=2, concat_axis=1)
