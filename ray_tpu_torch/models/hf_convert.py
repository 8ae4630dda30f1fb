"""HuggingFace checkpoint conversion (Llama, Qwen2, Qwen3, Mistral,
Gemma and Phi-3 families); PyTorch port of `ray_tpu/models/hf_convert.py`.

An HF `LlamaForCausalLM`, `Qwen2ForCausalLM`, `Qwen3ForCausalLM`,
`MistralForCausalLM`, `GemmaForCausalLM` or `Phi3ForCausalLM` state dict
becomes the state dict of the port's `Llama`. All six share a skeleton
(RMSNorm, gated MLP, rotate-half RoPE, GQA); Qwen2 adds QKV projection
biases (cfg.attn_bias); Mistral converts only with its sliding window
disabled; Gemma-1 swaps in a GeGLU gate, (1+w) RMSNorms, a sqrt(dim)
embedding scale and a head_dim decoupled from dim/n_heads; Phi-3 fuses
qkv_proj and gate_up_proj, which the converter splits by output-row
ranges; Qwen3 adds per-head RMSNorm on q and k before RoPE
(cfg.qk_norm).

Both sides keep torch's [out, in] layout, so nothing is transposed:
  q/k/v/o_proj.weight       -> layers.i.wq/wk/wv/wo.weight
  gate_proj.weight          -> layers.i.w3.weight  (swiglu(x, gate)
                                                    gates argument 2)
  up_proj.weight            -> layers.i.w1.weight
  down_proj.weight          -> layers.i.w2.weight
  embed_tokens.weight       -> embed.weight
  lm_head.weight            -> lm_head.weight (the embedding if tied)
Checkpoints carrying tensors with no slot here (o_proj biases,
yarn/dynamic rope variants) fail the conversion loudly instead of
converting into a numerically different model.

`transformers` is imported only by `load_hf_llama`, and only for a
path: the port runs where it is not installed.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .llama import Llama, LlamaConfig


def config_from_hf(hf_config) -> LlamaConfig:
    """Map a transformers config onto the port's `LlamaConfig` (f32,
    reference attention, no remat). Raises on HF features this model
    doesn't implement (silent drops would convert cleanly and generate
    subtly wrong logits)."""
    scaling = getattr(hf_config, "rope_scaling", None)
    rope_scaling = None
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type"))
        if kind in (None, "default"):
            pass
        elif kind == "llama3":
            # Llama-3.1+ piecewise frequency scaling.
            rope_scaling = (
                "llama3",
                float(scaling["factor"]),
                float(scaling.get("low_freq_factor", 1.0)),
                float(scaling.get("high_freq_factor", 4.0)),
                int(scaling["original_max_position_embeddings"]),
            )
        elif kind == "linear":
            rope_scaling = (
                "linear", float(scaling["factor"]), 1.0, 4.0, 0
            )
        else:
            raise NotImplementedError(
                f"rope_scaling type {kind!r} is not implemented "
                "(yarn/dynamic/longrope need their own numerics "
                "audit); converting anyway would mis-position every "
                "token"
            )
    model_type = getattr(hf_config, "model_type", "llama")
    if model_type not in (
        "llama", "qwen2", "mistral", "gemma", "phi3", "qwen3"
    ):
        raise NotImplementedError(
            f"model_type={model_type!r}: only the llama, qwen2, "
            "qwen3, mistral, gemma and phi3 families convert; "
            "anything else would need its own numerics audit "
            "(gemma2's logit soft-capping and alternating sliding "
            "windows are NOT implemented - converting one would "
            "silently change its numerics)"
        )
    # Qwen2 gates SWA behind use_sliding_window (default False);
    # Mistral/Phi-3 enable it whenever sliding_window is set AND
    # smaller than the context (a window >= context is a no-op and
    # must not block conversion). An *active* window changes
    # long-context numerics this model doesn't implement.
    window = getattr(hf_config, "sliding_window", None)
    max_pos = getattr(hf_config, "max_position_embeddings", 4096)
    if getattr(hf_config, "use_sliding_window", False) or (
        model_type in ("mistral", "phi3")
        and window is not None
        and window < max_pos
    ):
        raise NotImplementedError(
            "active sliding-window attention is not implemented; "
            "converting would silently change long-context numerics"
        )
    if float(getattr(hf_config, "partial_rotary_factor", 1.0)) != 1.0:
        raise NotImplementedError(
            "partial_rotary_factor != 1.0 (Phi-4-style partial RoPE) "
            "is not implemented; converting would mis-position every "
            "token"
        )
    # Qwen2 carries QKV biases (and only those). Llama's rare
    # attention_bias=True variant ALSO biases o_proj - a layout this
    # model has no slot for. Scoped to llama: a Qwen2 config carrying
    # a (redundant) attention_bias key must not trip it.
    if model_type == "llama" and getattr(
        hf_config, "attention_bias", False
    ):
        raise NotImplementedError(
            "llama attention_bias=True (biases on all four attention "
            "projections incl. o_proj) is unsupported; qwen2-style "
            "QKV-only biases are the supported biased layout"
        )
    act = "silu"
    if model_type == "gemma":
        # transformers' GemmaMLP reads ACT2FN[config.hidden_act]; the
        # separate hidden_activation field is unused by the layer, so
        # a checkpoint where the two disagree is ambiguous and must
        # fail loudly, not silently pick one.
        mapping = {"gelu_pytorch_tanh": "gelu_tanh", "gelu": "gelu_exact"}
        hidden_act = getattr(
            hf_config, "hidden_act", "gelu_pytorch_tanh"
        ) or "gelu_pytorch_tanh"
        legacy = getattr(hf_config, "hidden_activation", None)
        if hidden_act not in mapping:
            raise NotImplementedError(
                f"gemma hidden_act={hidden_act!r} unsupported"
            )
        if legacy is not None and legacy != hidden_act:
            raise NotImplementedError(
                f"gemma config carries conflicting activations "
                f"(hidden_act={hidden_act!r}, "
                f"hidden_activation={legacy!r}); converting would "
                "silently diverge from transformers, which uses "
                "hidden_act only"
            )
        act = mapping[hidden_act]
    head_dim = getattr(hf_config, "head_dim", 0) or 0
    if head_dim and head_dim * hf_config.num_attention_heads == (
        hf_config.hidden_size
    ):
        head_dim = 0  # derived - keep the config canonical
    return LlamaConfig(
        attn_bias=model_type == "qwen2",
        qk_norm=model_type == "qwen3",
        custom_head_dim=head_dim,
        act=act,
        norm_offset=model_type == "gemma",
        embed_scale=model_type == "gemma",
        norm_eps=getattr(hf_config, "rms_norm_eps", 1e-6),
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(
            hf_config, "num_key_value_heads",
            hf_config.num_attention_heads,
        ),
        intermediate=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        max_seq_len=max_pos,
        dtype=torch.float32,
        attention="reference",
        remat=False,
    )


def convert_hf_llama(state_dict: Dict[str, Any], cfg: LlamaConfig
                     ) -> Dict[str, torch.Tensor]:
    """HF causal-LM state dict -> the port's `Llama` state dict, on the
    CPU in `cfg.dtype` (values pass through f32, as in the JAX
    converter)."""
    consumed = set()

    def take(key: str) -> torch.Tensor:
        consumed.add(key)
        return state_dict[key].detach().cpu().float().to(cfg.dtype).clone()

    def split_rows(key: str, boundaries):
        """Split a FUSED projection (Phi-3 qkv_proj / gate_up_proj)
        along its OUTPUT rows at `boundaries`. They must cover the
        matrix exactly - silently dropped rows would convert into a
        numerically wrong model with every shape self-consistent."""
        whole = take(key)
        if whole.shape[0] != boundaries[-1]:
            raise ValueError(
                f"{key}: fused width {whole.shape[0]} != expected "
                f"{boundaries[-1]} from the config's head/intermediate "
                "geometry - refusing to convert a partial split"
            )
        out, lo = [], 0
        for hi in boundaries:
            out.append(whole[lo:hi].clone())
            lo = hi
        return out

    hd = cfg.head_dim
    state: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layers):
        src = f"model.layers.{i}."
        dst = f"layers.{i}."
        if src + "self_attn.qkv_proj.weight" in state_dict:  # Phi-3
            q_rows = cfg.n_heads * hd
            kv_rows = cfg.n_kv_heads * hd
            wq, wk, wv = split_rows(
                src + "self_attn.qkv_proj.weight",
                [q_rows, q_rows + kv_rows, q_rows + 2 * kv_rows],
            )
            # gate_up_proj fuses [gate; up]; the gate goes to w3.
            w3, w1 = split_rows(
                src + "mlp.gate_up_proj.weight",
                [cfg.intermediate, 2 * cfg.intermediate],
            )
        else:
            wq = take(src + "self_attn.q_proj.weight")
            wk = take(src + "self_attn.k_proj.weight")
            wv = take(src + "self_attn.v_proj.weight")
            w3 = take(src + "mlp.gate_proj.weight")
            w1 = take(src + "mlp.up_proj.weight")
        state.update({
            dst + "wq.weight": wq, dst + "wk.weight": wk,
            dst + "wv.weight": wv, dst + "w3.weight": w3,
            dst + "w1.weight": w1,
            dst + "wo.weight": take(src + "self_attn.o_proj.weight"),
            dst + "w2.weight": take(src + "mlp.down_proj.weight"),
            dst + "attn_norm": take(src + "input_layernorm.weight"),
            dst + "mlp_norm": take(src + "post_attention_layernorm.weight"),
        })
        if cfg.attn_bias:  # Qwen2-family QKV biases
            for p in "qkv":
                state[dst + f"w{p}.bias"] = take(
                    src + f"self_attn.{p}_proj.bias")
        if cfg.qk_norm:  # Qwen3 per-head q/k RMSNorm weights
            state[dst + "q_norm"] = take(src + "self_attn.q_norm.weight")
            state[dst + "k_norm"] = take(src + "self_attn.k_norm.weight")
    state["embed.weight"] = take("model.embed_tokens.weight")
    if "lm_head.weight" in state_dict:
        state["lm_head.weight"] = take("lm_head.weight")
    else:  # tied embeddings
        state["lm_head.weight"] = state["embed.weight"].clone()
    state["final_norm"] = take("model.norm.weight")
    # Every weight must be accounted for: a checkpoint with tensors we
    # don't map (attention/MLP biases, adapters) would otherwise
    # convert silently into a numerically different model.
    leftover = [
        k for k in state_dict
        if k not in consumed
        and not k.endswith("rotary_emb.inv_freq")  # derived buffer
    ]
    if leftover:
        raise ValueError(
            f"unconverted checkpoint tensors {leftover[:8]}"
            f"{'...' if len(leftover) > 8 else ''} - this model has no "
            "slot for them (e.g. attention_bias=True is unsupported)"
        )
    return state


def load_hf_llama(model, device="cuda") -> Tuple[Llama, LlamaConfig]:
    """The port's `Llama` on `device` and its config, from a live
    transformers causal LM or a local path loadable by
    `AutoModelForCausalLM` (no model hub access: paths must be local)."""
    if isinstance(model, str):
        from transformers import AutoModelForCausalLM

        model = AutoModelForCausalLM.from_pretrained(model)
    cfg = config_from_hf(model.config)
    ours = Llama(cfg, device=device)
    ours.load_state_dict(convert_hf_llama(model.state_dict(), cfg))
    return ours, cfg
