"""Llama-family decoder (PyTorch port of `ray_tpu/models/llama.py`).

Layout against the JAX package: the layers are an `nn.ModuleList` of
`LlamaLayer`s, where the JAX package stacks them on a leading axis
under `lax.scan`; the projections are `nn.Linear` ([out, in] weights,
the transpose of the JAX [in, out] leaves); `remat=True` wraps each
layer in `torch.utils.checkpoint`, as `jax.checkpoint` wraps the scan
body: policy "full" recomputes the whole layer in backward, "dots" and
"dots_flash" are selective checkpoints (`remat_policy`). Attention goes
through the flash kernels (`ops/attention.py`). `load_jax_params` maps
the JAX parameter tree onto this model; `param_annotations` gives each
parameter's logical axes for the sharded train step.

The head split reads the head count off the projection's output, so a
layer whose projections are tensor-parallel shards (heads / tp of them)
runs unchanged.

A MoE layer (`moe_experts` > 0) keeps the JAX package's expert weights
as they are (router [dim, E], w_in [E, dim, f], w_out [E, f, dim]) in
place of w1/w3/w2, and runs `moe_ffn_ep` over an `ep` process group
when one is given, else `moe_ffn_dense` (over the tp group when
`shard_module` has sharded the experts' `mlp` dim over tp). Attention "ring" runs
`ring_attention` over an `sp` process group when one is given, else the
reference attention, as in the JAX package.

Under `make_train_step` on a mesh with sp > 1 the model holds a sequence
shard (`Llama.seq_group`): its positions are offset by the shard's start
and its attention spans the whole sequence over the group, as GSPMD's
sequence sharding computes it (`_sequence_attention`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import FLASH_FWD, flash_attention, mha_reference, repeat_kv
from ..ops.moe import moe_ffn_dense, moe_ffn_ep
from ..ops.norms import apply_rotary, rms_norm, rotary_embedding, swiglu
from ..ops.ring_attention import ring_attention, ulysses_attention
from ..parallel.sharding import Annotated, annotate


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
    attention: str = "flash"  # flash | reference | ring
    remat: bool = True
    #: "full" recomputes the whole layer in backward; "dots" saves the
    #: matrix products without batch dims (JAX's
    #: dots_with_no_batch_dims_saveable); "dots_flash" also saves the
    #: flash forward's out and lse, so the kernel runs once per step.
    remat_policy: str = "full"
    #: >0 turns every FFN into a top-k-routed MoE with this many
    #: experts (0 = dense SwiGLU).
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


def _check_config(cfg: LlamaConfig) -> None:
    if cfg.attention not in ("flash", "reference", "ring"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"one of {REMAT_POLICIES}")


#: Remat policy -> the ops whose outputs the backward reads from memory
#: instead of recomputing them. `aten.mm`/`aten.addmm` are the matrix
#: products without batch dims (every nn.Linear); attention's batched
#: `bmm` in `mha_reference` is recomputed, as JAX's policy does.
_SAVED_OPS = {
    "full": (),
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "dots_flash": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   FLASH_FWD),
}
REMAT_POLICIES = tuple(_SAVED_OPS)


def _policy_fn(saved, ctx, op, *args, **kwargs):
    if op in saved:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context_fn(policy: str):
    """`context_fn` of `torch.utils.checkpoint` for a selective policy."""
    return functools.partial(
        create_selective_checkpoint_contexts,
        functools.partial(_policy_fn, _SAVED_OPS[policy]))


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
    embedding dtype). Through the module, so a tensor-parallel embedding
    gathers its vocab shards."""
    x = model.embed(tokens).to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.dim), dtype=cfg.dtype,
                             device=x.device)
    return x


def project_qkv(cfg: LlamaConfig, h, layer: "LlamaLayer"):
    """QKV projection (+ Qwen2-family biases) and head split:
    h [b, t, dim] -> each of q/k/v [b, heads, t, head_dim], heads being
    those of this rank's projection shard (all of them without tensor
    parallelism)."""
    b, t, _ = h.shape
    hd = cfg.head_dim
    q, k, v = layer.wq(h), layer.wk(h), layer.wv(h)
    q = q.reshape(b, t, -1, hd).transpose(1, 2)
    k = k.reshape(b, t, -1, hd).transpose(1, 2)
    v = v.reshape(b, t, -1, hd).transpose(1, 2)
    if cfg.qk_norm:
        # Qwen3: per-head RMSNorm over head_dim, before RoPE.
        q = rms_norm(q, layer.q_norm, eps=cfg.norm_eps)
        k = rms_norm(k, layer.k_norm, eps=cfg.norm_eps)
    return q, k, v


def _sequence_attention(cfg: LlamaConfig, q, k, v, group):
    """Causal attention over the whole sequence from this rank's shard
    of it [b, heads, t/sp, d], over the sp process group `group`: the
    counterpart of JAX's attention on a sequence GSPMD shards over sp.

    "flash" and "reference" run Ulysses (`ulysses_attention`): an
    all_to_all to a head shard, the flash op (its kernels on the card)
    or `mha_reference` over the whole sequence on heads/sp heads, an
    all_to_all back. The kernels' causal mask is top-left, so each rank
    must hold whole sequences (t_q = t_k), not its queries against every
    key. "ring" runs `ring_attention`, exact as well. Ulysses needs
    whole heads on each rank: where sp does not divide the local heads
    (heads / tp), "reference" runs the ring, and so does "flash" on CPU
    tensors, where the flash op is its plain version; "flash" on the
    card raises there, the ring's blocks being plain products."""
    sp, heads = dist.get_world_size(group), q.shape[1]
    if cfg.attention == "ring" or heads % sp:
        if cfg.attention == "flash" and q.device.type != "cpu":
            raise ValueError(
                f"sp={sp} does not divide the {heads} local heads: Ulysses "
                "needs whole heads on each rank to run the flash kernels; "
                "choose an sp that divides n_heads / tp, or "
                "attention='ring'")
        return ring_attention(q, k, v, group, causal=True)
    fn = (functools.partial(flash_attention, causal=True)
          if cfg.attention == "flash" else None)
    return ulysses_attention(q, k, v, group, causal=True, attention_fn=fn)


def _attention(cfg: LlamaConfig, q, k, v, sp_group=None, seq_group=None):
    k = repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    v = repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)
    if seq_group is None and cfg.attention == "ring":
        seq_group = sp_group  # make_pp_train_step's ring over sp
    if seq_group is not None:
        return _sequence_attention(cfg, q, k, v, seq_group)
    if cfg.attention == "flash":
        return flash_attention(q, k, v, causal=True)
    return mha_reference(q, k, v, causal=True)


def _layer(cfg: LlamaConfig, x, layer: "LlamaLayer", cos, sin,
           sp_group=None, ep_group=None, batch_groups=(), seq_group=None):
    """One decoder block. x: [batch, seq, dim]. Returns (x, aux), aux
    being the MoE load-balancing loss (0 for dense layers)."""
    b, t, _ = x.shape
    h = model_norm(cfg, x, layer.attn_norm)
    q, k, v = project_qkv(cfg, h, layer)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    attn = _attention(cfg, q, k, v, sp_group, seq_group)
    attn = attn.transpose(1, 2).reshape(b, t, -1)
    x = x + layer.wo(attn)
    h = model_norm(cfg, x, layer.mlp_norm)
    if not cfg.moe_experts:
        x = x + layer.w2(model_glu(cfg, layer.w1(h), layer.w3(h)))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    moe_params = {"router": layer.router, "w_in": layer.w_in,
                  "w_out": layer.w_out}
    flat = h.reshape(b * t, -1)
    if ep_group is not None:
        out, aux = moe_ffn_ep(moe_params, flat, ep_group, k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor)
    else:
        tp_group = None
        if isinstance(layer.w_in, DTensor):
            # Sharded on mlp over the tp mesh (`shard_module`).
            tp_group = layer.w_in.device_mesh.get_group("tp")
            moe_params.update(w_in=layer.w_in.to_local(),
                              w_out=layer.w_out.to_local())
        out, aux = moe_ffn_dense(moe_params, flat, k=cfg.moe_top_k,
                                 batch_groups=batch_groups, tp_group=tp_group)
    return x + out.reshape(b, t, -1), aux


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
        if cfg.moe_experts:
            e, f = cfg.moe_experts, cfg.intermediate
            self.router = nn.Parameter(torch.empty(cfg.dim, e, **kw))
            self.w_in = nn.Parameter(torch.empty(e, cfg.dim, f, **kw))
            self.w_out = nn.Parameter(torch.empty(e, f, cfg.dim, **kw))
        else:
            self.w1 = nn.Linear(cfg.dim, cfg.intermediate, bias=False, **kw)
            self.w3 = nn.Linear(cfg.dim, cfg.intermediate, bias=False, **kw)
            self.w2 = nn.Linear(cfg.intermediate, cfg.dim, bias=False, **kw)

    def forward(self, x, cos, sin, sp_group=None, ep_group=None,
                batch_groups=(), seq_group=None):
        """(x, aux) of `_layer`; `sp_group` and `ep_group` are the
        process groups of ring attention and of the experts, if any,
        `batch_groups` those the batch's tokens are split over, and
        `seq_group` the group the sequence is split over (`Llama`)."""
        cfg = self.cfg
        args = (cfg, x, self, cos, sin, sp_group, ep_group, batch_groups,
                seq_group)
        if not cfg.remat:
            return _layer(*args)
        # Inside the module's forward, so that a sharded layer's gather
        # (FSDP's hooks on this module) wraps the recompute too. "full"
        # keeps one layer's activations in HBM at a time.
        kw = {}
        if cfg.remat_policy != "full":
            kw["context_fn"] = _remat_context_fn(cfg.remat_policy)
        return checkpoint(_layer, *args, use_reentrant=False, **kw)


class Llama(nn.Module):
    """The decoder; `forward(tokens)` returns f32 logits.

    `batch_groups`: the process groups over which the batch is split
    into equal data shards (set by `make_train_step` on a mesh).
    `seq_group`: the sp process group over which each sequence is split
    into equal shards (set by `make_train_step` on a mesh with sp > 1;
    not the ring's `sp_group` of `make_pp_train_step`, which runs only
    "ring" attention over it): the model offsets its positions by its
    shard's start and runs its attention over the whole sequence
    (`_sequence_attention`). A MoE router takes its load-balancing
    statistics over both, so that the aux loss is the whole batch's, as
    JAX computes it."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.batch_groups = ()
        self.seq_group = None
        kw = dict(device=device, dtype=cfg.dtype)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device=device) for _ in range(cfg.n_layers)
        )
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, **kw))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw)

    def forward(self, tokens, positions=None, return_aux=False,
                sp_group=None, ep_group=None):
        """Logits, or (logits, aux) with `return_aux`. The module's own
        call is the way in, so that a sharded model's hooks (FSDP's
        gather of the root's parameters) run."""
        logits, aux = _forward_and_aux(self, tokens, positions, sp_group,
                                       ep_group)
        return (logits, aux) if return_aux else logits


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Llama:
    """Random initialization on `device`, drawn from `generator`:
    normal * 1/sqrt(fan_in) for matrices, ones for norms, zeros for
    biases (as `ray_tpu.models.llama.init_params`, not its numbers). The
    fan-in is dim 1 of a matrix ([out, in], [vocab, dim], and the
    experts' [E, in, out]), dim 0 of the router [dim, E]."""
    model = Llama(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                fan_in = p.shape[0 if name.endswith("router") else 1]
                noise = torch.randn(p.shape, generator=generator,
                                    device=p.device, dtype=torch.float32)
                p.copy_(noise * (1.0 / math.sqrt(fan_in)))
    return model


def forward_and_aux(model: Llama, tokens, *, positions=None, sp_group=None,
                    ep_group=None) -> tuple:
    """Token ids [batch, seq] -> (logits [batch, seq, vocab] f32, aux:
    the MoE load-balancing loss summed over layers, 0 for dense models).

    With sequence parallelism, `tokens` is the local sequence shard,
    `positions` its global positions and `sp_group` the ring's group;
    with expert parallelism, `ep_group` is the experts' group."""
    return model(tokens, positions=positions, return_aux=True,
                 sp_group=sp_group, ep_group=ep_group)


def _forward_and_aux(model: Llama, tokens, positions, sp_group=None,
                     ep_group=None) -> tuple:
    cfg = model.cfg
    b, t = tokens.shape
    seq_group, groups = model.seq_group, model.batch_groups
    if seq_group is not None:
        groups = groups + (seq_group,)
    if positions is None:
        start = dist.get_rank(seq_group) * t if seq_group is not None else 0
        positions = (start + torch.arange(t, device=tokens.device)).expand(b, t)
    x = embed_tokens(cfg, model, tokens)
    cos, sin = rotary_embedding(
        positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling
    )
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x, layer_aux = layer(x, cos, sin, sp_group, ep_group, groups,
                             seq_group)
        aux = aux + layer_aux
    x = model_norm(cfg, x, model.final_norm)
    return model.lm_head(x).float(), aux


def param_annotations(cfg: LlamaConfig) -> Dict[str, Annotated]:
    """Logical axes of every parameter, by state-dict name, in this
    model's layout ([out, in] matrices, [vocab, dim] embedding): the
    JAX package's `param_annotations` with each matrix's two axes
    swapped and the layer axis unstacked."""
    _check_config(cfg)
    layer = {
        "wq.weight": ("heads", "embed"),
        "wk.weight": ("kv_heads", "embed"),
        "wv.weight": ("kv_heads", "embed"),
        "wo.weight": ("embed", "heads"),
        "attn_norm": (None,),
        "mlp_norm": (None,),
    }
    if cfg.moe_experts:
        layer.update({"router": ("embed", None),
                      "w_in": ("expert", "embed", "mlp"),
                      "w_out": ("expert", "mlp", "embed")})
    else:
        layer.update({"w1.weight": ("mlp", "embed"),
                      "w3.weight": ("mlp", "embed"),
                      "w2.weight": ("embed", "mlp")})
    if cfg.attn_bias:
        layer.update({"wq.bias": ("heads",), "wk.bias": ("kv_heads",),
                      "wv.bias": ("kv_heads",)})
    if cfg.qk_norm:
        layer.update({"q_norm": (None,), "k_norm": (None,)})
    out = {
        "embed.weight": annotate("vocab", "embed"),
        "final_norm": annotate(None),
        "lm_head.weight": annotate("vocab", "embed"),
    }
    for i in range(cfg.n_layers):
        for name, axes in layer.items():
            out[f"layers.{i}.{name}"] = annotate(*axes)
    return out


def forward(model: Llama, tokens, *, positions=None, sp_group=None,
            ep_group=None):
    """Token ids [batch, seq] -> logits [batch, seq, vocab] (f32)."""
    return forward_and_aux(model, tokens, positions=positions,
                           sp_group=sp_group, ep_group=ep_group)[0]


def masked_xent(logits, targets) -> tuple:
    """Masked next-token cross-entropy pieces: (sum_nll, token_count).
    `targets` < 0 are masked out. logsumexp minus gather: the full
    [*, vocab] log-probability tensor is never formed. Logits sharded
    over the vocabulary (a DTensor, under tensor parallelism) go through
    `F.cross_entropy`, which `loss_parallel` computes on the shards."""
    mask = (targets >= 0).float()
    if isinstance(logits, DTensor):
        nll = F.cross_entropy(logits.flatten(0, -2),
                              targets.masked_fill(targets < 0, -100).flatten(),
                              ignore_index=-100, reduction="sum")
        return nll.full_tensor(), torch.sum(mask)
    safe_targets = targets.clamp(min=0)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe_targets[..., None])[..., 0]
    return torch.sum((lse - tgt) * mask), torch.sum(mask)


def loss_fn(model: Llama, tokens, targets, *, positions=None, sp_group=None,
            ep_group=None):
    """Mean next-token cross-entropy (+ weighted MoE aux loss).
    `targets` < 0 are masked out."""
    logits, aux = forward_and_aux(model, tokens, positions=positions,
                                  sp_group=sp_group, ep_group=ep_group)
    nll_sum, count = masked_xent(logits, targets)
    xent = nll_sum / torch.clamp(count, min=1.0)
    return xent + model.cfg.moe_aux_weight * aux


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
    "router": ("router", False),
    "w_in": ("w_in", False),
    "w_out": ("w_out", False),
}


def load_jax_params(np_tree: Dict[str, Any], cfg: LlamaConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree (`ray_tpu.models.llama.
    init_params` layout, leaves as numpy arrays, layers stacked on axis
    0) as this model's state dict, on the CPU in `cfg.dtype`:
    `Llama(cfg).load_state_dict(load_jax_params(tree, cfg))`."""
    _check_config(cfg)

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
