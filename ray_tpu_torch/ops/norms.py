"""Normalization and positional-embedding ops (PyTorch port of
`ray_tpu/ops/norms.py`).

Plain tensor code: each is an elementwise chain or a row reduction,
moves few bytes next to the matrix products around it, and has no
kernel of its own in the JAX package either."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in f32 accumulation, cast back to the input dtype.
    `offset` supports the Gemma convention of scaling by (1 + w)."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    scale = weight.float()
    if offset:
        scale = scale + offset
    return (normed * scale).to(dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0, scaling=None,
                     device=None) -> torch.Tensor:
    """Per-dimension RoPE inverse frequencies [head_dim // 2], f32,
    optionally rescaled. `scaling` is None or
    `(kind, factor, low_freq_factor, high_freq_factor, original_max)`
    with kind "linear" (every frequency divided by `factor`) or
    "llama3" (Llama-3.1's piecewise scheme)."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = 1.0 / (theta ** exponents)
    if scaling is None:
        return freqs
    kind, factor, low_ff, high_ff, orig_max = scaling
    if kind == "linear":
        return freqs / factor
    if kind == "llama3":
        low_wavelen = orig_max / low_ff
        high_wavelen = orig_max / high_ff
        wavelen = 2.0 * math.pi / freqs
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        smoothed = (1.0 - smooth) * freqs / factor + smooth * freqs
        return torch.where(
            wavelen > low_wavelen,
            freqs / factor,
            torch.where(wavelen < high_wavelen, freqs, smoothed),
        )
    raise ValueError(f"unknown rope scaling kind {kind!r}")


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10000.0, scaling=None):
    """Rotary tables: (cos, sin), each [*positions.shape, head_dim // 2]
    in f32."""
    freqs = rope_frequencies(head_dim, theta, scaling, device=positions.device)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE on [batch, heads, seq, head_dim], computed in f32,
    given (cos, sin) of shape [batch, seq, head_dim // 2] (or
    broadcastable)."""
    dtype = x.dtype
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    if cos.dim() == 3:
        cos = cos[:, None, :, :]
        sin = sin[:, None, :, :]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(dtype)


def swiglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """SwiGLU activation: silu(gate) * x."""
    return F.silu(gate) * x
