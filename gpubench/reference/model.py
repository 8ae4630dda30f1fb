"""The plain reference of the decoder the configurations describe
(Mistral and Qwen3 as their `config.json` and modeling code define
them): f32 arithmetic, TF32 off, no kernels, no cache, no batching of
requests, written from the architecture and not from the program.

A pre-norm decoder layer: RMSNorm (eps from the config, in f32), q, k
and v projections, Qwen3's per-head RMSNorm on q and k, rotary position
embedding on the two halves of each head (rotate_half, inverse
frequencies theta^(-2i/d)), causal softmax attention with each KV head
shared by heads/kv_heads query heads, the output projection and a
residual add, RMSNorm, the SwiGLU MLP down(silu(gate(h)) * up(h)) and a
residual add. A final RMSNorm and the untied head give the logits.

`matmul` is where precision enters: `f32` multiplies in float32; the
control `fp8` rounds each product's operands to float8 (e4m3 forward,
e5m2 for the gradients flowing back) with a per-tensor scale, as fp8
training and serving do, and accumulates in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _quant(x: torch.Tensor, fmt) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (x / scale).to(fmt).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _quant(a, torch.float8_e4m3fn), _quant(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _quant(g, torch.float8_e5m2)
        ga = gq @ bq.transpose(-1, -2)
        if bq.dim() == 2:
            gb = aq.reshape(-1, aq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        else:
            gb = aq.transpose(-1, -2) @ gq
        return ga, gb


def f32(a, b):
    return a @ b


def fp8(a, b):
    return _Fp8Matmul.apply(a, b)


PRECISIONS: Dict[str, Callable] = {"f32": f32, "fp8": fp8}

#: Bytes of attention scores one chunk of heads may hold.
ATTENTION_CHUNK_BYTES = 1 << 30


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(t: int, head_dim: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, device=device,
                                       dtype=torch.float64) / head_dim)
    angles = torch.arange(t, device=device, dtype=torch.float64)[:, None] * inv
    return torch.cos(angles).float(), torch.sin(angles).float()


def rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention_chunk(q, k, v, mm):
    t = q.shape[-2]
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
    return mm(p, v)


def attention(q, k, v, mm):
    """Causal attention over [b, heads, t, d] queries and [b, kv_heads,
    t, d] keys and values, a few heads at a time (recomputed in the
    backward) so that the scores fit."""
    b, h, t, _ = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    step = max(1, min(h, ATTENTION_CHUNK_BYTES // (3 * 4 * b * t * t)))
    outs = []
    for h0 in range(0, h, step):
        args = (q[:, h0:h0 + step], k[:, h0:h0 + step], v[:, h0:h0 + step], mm)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attention_chunk, *args, use_reentrant=False))
        else:
            outs.append(_attention_chunk(*args))
    return torch.cat(outs, dim=1)


def layer(x, w: Dict[str, torch.Tensor], cos, sin, a: dict, mm):
    """One decoder layer on x [b, t, dim] with f32 weights `w` (the
    benchmark's leaf names, [out, in] matrices)."""
    b, t, _ = x.shape
    hd = a["head_dim"]
    h = rms_norm(x, w["attn_norm"], a["eps"])
    q = mm(h, w["q"].T).view(b, t, a["heads"], hd).transpose(1, 2)
    k = mm(h, w["k"].T).view(b, t, a["kv_heads"], hd).transpose(1, 2)
    v = mm(h, w["v"].T).view(b, t, a["kv_heads"], hd).transpose(1, 2)
    if a["qk_norm"]:
        q = rms_norm(q, w["q_norm"], a["eps"])
        k = rms_norm(k, w["k_norm"], a["eps"])
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    o = attention(q, k, v, mm).transpose(1, 2).reshape(b, t, -1)
    x = x + mm(o, w["o"].T)
    h = rms_norm(x, w["mlp_norm"], a["eps"])
    return x + mm(F.silu(mm(h, w["gate"].T)) * mm(h, w["up"].T), w["down"].T)


def head(x, final_norm, head_w, a: dict, mm):
    return mm(rms_norm(x, final_norm, a["eps"]), head_w.T)
