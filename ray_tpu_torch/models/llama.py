"""Llama-family decoder (PyTorch port of `ray_tpu/models/llama.py`).

Layout against the JAX package: the layers are an `nn.ModuleList` of
`LlamaLayer`s, where the JAX package stacks them on a leading axis
under `lax.scan`; the projections are `nn.Linear` ([out, in] weights,
the transpose of the JAX [in, out] leaves); `remat=True` with policy
"full" wraps each layer in `torch.utils.checkpoint`, as `jax.checkpoint`
does. Attention goes through the flash kernels (`ops/attention.py`).
`load_jax_params` maps the JAX parameter tree onto this model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention, mha_reference, repeat_kv
from ..ops.norms import apply_rotary, rms_norm, rotary_embedding, swiglu


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    intermediate: int = 11008
    rope_theta: float = 10000.0
    max_seq_len: int = 4096
    dtype: Any = torch.bfloat16
    attention: str = "flash"  # flash | reference | ring (not ported yet)
    remat: bool = True
    #: "full" recomputes the whole layer in backward. "dots" and
    #: "dots_flash" are not ported yet (ROADMAP queue 1).
    remat_policy: str = "full"
    #: >0 turns every FFN into a routed MoE (not ported yet).
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    #: RMSNorm epsilon (HF rms_norm_eps; Llama-2 ships 1e-5).
    norm_eps: float = 1e-6
    #: Attention QKV projection biases (Qwen2-family; Llama has none).
    attn_bias: bool = False
    #: None, or (kind, factor, low_freq_factor, high_freq_factor,
    #: original_max) with kind "linear" or "llama3".
    rope_scaling: Any = None
    #: Per-head dimension when it is NOT dim // n_heads. 0 = derived.
    custom_head_dim: int = 0
    #: GLU gate activation: "silu", "gelu_tanh" or "gelu_exact".
    act: str = "silu"
    #: RMSNorm scales by (1 + w) instead of w (Gemma).
    norm_offset: bool = False
    #: Multiply the embedding output by sqrt(dim) (Gemma).
    embed_scale: bool = False
    #: Per-head RMSNorm on q and k before RoPE (Qwen3 family).
    qk_norm: bool = False

    @property
    def head_dim(self) -> int:
        return self.custom_head_dim or self.dim // self.n_heads

    def num_params(self) -> int:
        embed = self.vocab_size * self.dim
        if self.moe_experts:
            ffn = self.dim * self.moe_experts + (
                2 * self.moe_experts * self.dim * self.intermediate
            )
        else:
            ffn = 3 * self.dim * self.intermediate
        per_layer = (
            self.dim * self.n_heads * self.head_dim
            + 2 * self.dim * self.n_kv_heads * self.head_dim
            + self.n_heads * self.head_dim * self.dim
            + ffn
            + 2 * self.dim
        )
        if self.attn_bias:
            per_layer += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        if self.qk_norm:
            per_layer += 2 * self.head_dim
        return embed * 2 + self.n_layers * per_layer + self.dim

    # ---- presets ----
    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
            intermediate=128, max_seq_len=128, dtype=torch.float32, **kw
        )

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        """Llama-2-7B (BASELINE.json configs)."""
        return LlamaConfig(**kw)

    @staticmethod
    def gemma_2b(**kw) -> "LlamaConfig":
        """Gemma-1 2B geometry: GeGLU, (1+w) norms, sqrt(dim) embed
        scale, head_dim decoupled from dim/n_heads."""
        return LlamaConfig(
            vocab_size=256000, dim=2048, n_layers=18, n_heads=8,
            n_kv_heads=1, intermediate=16384, custom_head_dim=256,
            act="gelu_tanh", norm_offset=True, embed_scale=True,
            **kw
        )

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, intermediate=14336, rope_theta=500000.0,
            max_seq_len=8192, **kw
        )

    @staticmethod
    def bench_410m(**kw) -> "LlamaConfig":
        """GPT-medium-scale config for single-chip benchmarking, with
        head_dim 128 (8 heads)."""
        return LlamaConfig(
            vocab_size=32000, dim=1024, n_layers=24, n_heads=8,
            n_kv_heads=8, intermediate=2816, max_seq_len=2048, **kw
        )


def _check_ported(cfg: LlamaConfig) -> None:
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "moe_experts > 0: MoE is not ported yet (ROADMAP queue 1, "
            "parallelism slice)")
    if cfg.attention == "ring":
        raise NotImplementedError(
            "attention='ring': ring/Ulysses attention is not ported yet "
            "(ROADMAP queue 1, parallelism slice)")
    if cfg.attention not in ("flash", "reference"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r}: selective remat is not "
            "ported yet (ROADMAP queue 1, remat dots/dots_flash)")


def model_norm(cfg: LlamaConfig, x, weight):
    """RMSNorm with the family's scale convention (Gemma scales by 1+w;
    Llama-family by w)."""
    return rms_norm(
        x, weight, eps=cfg.norm_eps, offset=1.0 if cfg.norm_offset else 0.0
    )


def model_glu(cfg: LlamaConfig, x, gate):
    """GLU with the family's gate activation: act(gate) * x."""
    if cfg.act == "silu":
        return swiglu(x, gate)
    if cfg.act == "gelu_tanh":
        return F.gelu(gate, approximate="tanh") * x
    if cfg.act == "gelu_exact":
        return F.gelu(gate, approximate="none") * x
    raise ValueError(f"unknown activation {cfg.act!r}")


def embed_tokens(cfg: LlamaConfig, model: "Llama", tokens):
    """Embedding lookup (+ Gemma's sqrt(dim) normalizer, applied in the
    embedding dtype)."""
    x = model.embed.weight[tokens].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.dim), dtype=cfg.dtype,
                             device=x.device)
    return x


def project_qkv(cfg: LlamaConfig, h, layer: "LlamaLayer"):
    """QKV projection (+ Qwen2-family biases) and head split:
    h [b, t, dim] -> each of q/k/v [b, heads, t, head_dim]."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    q, k, v = layer.wq(h), layer.wk(h), layer.wv(h)
    q = q.reshape(b, t, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, t, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, t, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        # Qwen3: per-head RMSNorm over head_dim, before RoPE.
        q = rms_norm(q, layer.q_norm, eps=cfg.norm_eps)
        k = rms_norm(k, layer.k_norm, eps=cfg.norm_eps)
    return q, k, v


def _attention(cfg: LlamaConfig, q, k, v):
    k = repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    v = repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)
    if cfg.attention == "flash":
        return flash_attention(q, k, v, causal=True)
    return mha_reference(q, k, v, causal=True)


def _layer(cfg: LlamaConfig, x, layer: "LlamaLayer", cos, sin):
    """One decoder block. x: [batch, seq, dim]."""
    b, t, _ = x.shape
    h = model_norm(cfg, x, layer.attn_norm)
    q, k, v = project_qkv(cfg, h, layer)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    attn = _attention(cfg, q, k, v)
    attn = attn.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.head_dim)
    x = x + layer.wo(attn)
    h = model_norm(cfg, x, layer.mlp_norm)
    return x + layer.w2(model_glu(cfg, layer.w1(h), layer.w3(h)))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, dt = cfg.head_dim, cfg.dtype
        kw = dict(device=device, dtype=dt)
        self.wq = nn.Linear(cfg.dim, cfg.n_heads * hd, bias=cfg.attn_bias, **kw)
        self.wk = nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=cfg.attn_bias, **kw)
        self.wv = nn.Linear(cfg.dim, cfg.n_kv_heads * hd, bias=cfg.attn_bias, **kw)
        self.wo = nn.Linear(cfg.n_heads * hd, cfg.dim, bias=False, **kw)
        self.attn_norm = nn.Parameter(torch.ones(cfg.dim, **kw))
        self.mlp_norm = nn.Parameter(torch.ones(cfg.dim, **kw))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, **kw))
            self.k_norm = nn.Parameter(torch.ones(hd, **kw))
        self.w1 = nn.Linear(cfg.dim, cfg.intermediate, bias=False, **kw)
        self.w3 = nn.Linear(cfg.dim, cfg.intermediate, bias=False, **kw)
        self.w2 = nn.Linear(cfg.intermediate, cfg.dim, bias=False, **kw)

    def forward(self, x, cos, sin):
        return _layer(self.cfg, x, self, cos, sin)


class Llama(nn.Module):
    """The decoder; `forward(tokens)` returns f32 logits."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        kw = dict(device=device, dtype=cfg.dtype)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device=device) for _ in range(cfg.n_layers)
        )
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, **kw))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw)

    def forward(self, tokens, positions=None):
        return forward(self, tokens, positions=positions)


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Llama:
    """Random initialization on `device`, drawn from `generator`:
    normal * 1/sqrt(fan_in) for matrices, ones for norms, zeros for
    biases (as `ray_tpu.models.llama.init_params`, not its numbers)."""
    model = Llama(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                fan_in = p.shape[1]  # [out, in] and [vocab, dim] alike
                noise = torch.randn(p.shape, generator=generator,
                                    device=p.device, dtype=torch.float32)
                p.copy_(noise * (1.0 / math.sqrt(fan_in)))
    return model


def forward_and_aux(model: Llama, tokens, *, positions=None) -> tuple:
    """Token ids [batch, seq] -> (logits [batch, seq, vocab] f32, aux),
    aux being the MoE load-balancing loss (0: dense models only)."""
    cfg = model.cfg
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, device=tokens.device).expand(b, t)
    x = embed_tokens(cfg, model, tokens)
    cos, sin = rotary_embedding(
        positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling
    )
    for layer in model.layers:
        if cfg.remat:
            # Recomputes the layer, flash forward kernel included, in
            # backward: HBM holds one layer's activations at a time.
            x = checkpoint(layer, x, cos, sin, use_reentrant=False)
        else:
            x = layer(x, cos, sin)
    x = model_norm(cfg, x, model.final_norm)
    logits = model.lm_head(x).float()
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def forward(model: Llama, tokens, *, positions=None):
    """Token ids [batch, seq] -> logits [batch, seq, vocab] (f32)."""
    return forward_and_aux(model, tokens, positions=positions)[0]


def masked_xent(logits, targets) -> tuple:
    """Masked next-token cross-entropy pieces: (sum_nll, token_count).
    `targets` < 0 are masked out. logsumexp minus gather: the full
    [*, vocab] log-probability tensor is never formed."""
    mask = (targets >= 0).float()
    safe_targets = targets.clamp(min=0)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe_targets[..., None])[..., 0]
    return torch.sum((lse - tgt) * mask), torch.sum(mask)


def loss_fn(model: Llama, tokens, targets, *, positions=None):
    """Mean next-token cross-entropy (+ weighted MoE aux loss).
    `targets` < 0 are masked out."""
    logits, aux = forward_and_aux(model, tokens, positions=positions)
    nll_sum, count = masked_xent(logits, targets)
    xent = nll_sum / torch.clamp(count, min=1.0)
    return xent + model.cfg.moe_aux_weight * aux


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token (fwd+bwd), standard 6N + attention term;
    for MoE, N counts only the parameters a token activates."""
    n = cfg.num_params()
    if cfg.moe_experts:
        inactive = (cfg.moe_experts - cfg.moe_top_k) * 2 * (
            cfg.dim * cfg.intermediate
        )
        n -= cfg.n_layers * max(inactive, 0)
    attn_width = cfg.n_heads * cfg.head_dim
    attn = 12 * cfg.n_layers * attn_width * seq_len
    return 6.0 * n + attn / 2  # causal factor 1/2 on the attn term


# ---------------------------------------------------------------------------
# parameters of the JAX package
# ---------------------------------------------------------------------------

#: JAX per-layer leaf -> (port parameter, transposed). The JAX package
#: keeps [in, out] matrices; nn.Linear keeps [out, in].
_LAYER_LEAVES = {
    "wq": ("wq.weight", True),
    "wk": ("wk.weight", True),
    "wv": ("wv.weight", True),
    "wo": ("wo.weight", True),
    "w1": ("w1.weight", True),
    "w3": ("w3.weight", True),
    "w2": ("w2.weight", True),
    "attn_norm": ("attn_norm", False),
    "mlp_norm": ("mlp_norm", False),
    "bq": ("wq.bias", False),
    "bk": ("wk.bias", False),
    "bv": ("wv.bias", False),
    "q_norm": ("q_norm", False),
    "k_norm": ("k_norm", False),
}


def load_jax_params(np_tree: Dict[str, Any], cfg: LlamaConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree (`ray_tpu.models.llama.
    init_params` layout, leaves as numpy arrays, layers stacked on axis
    0) as this model's state dict, on the CPU in `cfg.dtype`:
    `Llama(cfg).load_state_dict(load_jax_params(tree, cfg))`."""
    _check_ported(cfg)

    def tensor(a, transpose=False):
        a = np.array(a, dtype=np.float32)  # a writable copy
        if transpose:
            a = np.ascontiguousarray(a.T)
        return torch.from_numpy(a).to(cfg.dtype)

    state = {
        "embed.weight": tensor(np_tree["embed"]),
        "final_norm": tensor(np_tree["final_norm"]),
        "lm_head.weight": tensor(np_tree["lm_head"], transpose=True),
    }
    for leaf, stacked in np_tree["layers"].items():
        name, transpose = _LAYER_LEAVES[leaf]
        for i in range(cfg.n_layers):
            state[f"layers.{i}.{name}"] = tensor(stacked[i], transpose)
    return state


def to_jax_params(state: Dict[str, torch.Tensor], cfg: LlamaConfig
                  ) -> Dict[str, Any]:
    """Inverse of `load_jax_params`: a state dict as the JAX tree of
    f32 numpy arrays, layers stacked on axis 0."""

    def array(x, transpose=False):
        a = np.array(x.detach().float().cpu())  # a copy, never a view
        return a.T if transpose else a

    layers = {}
    for leaf, (name, transpose) in _LAYER_LEAVES.items():
        if f"layers.0.{name}" in state:
            layers[leaf] = np.stack([
                array(state[f"layers.{i}.{name}"], transpose)
                for i in range(cfg.n_layers)
            ])
    return {
        "embed": array(state["embed.weight"]),
        "layers": layers,
        "final_norm": array(state["final_norm"]),
        "lm_head": array(state["lm_head.weight"], transpose=True),
    }
