"""What the drivers take from the program: its model, built from a
configuration's published keys through the port's own converter, with
the benchmark's weights copied in, and the map between the benchmark's
leaf names and the port's parameter names."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

from .. import weights

#: The benchmark's layer leaves -> the port's `LlamaLayer` parameters
#: (the port's SwiGLU is silu(w3 h) * w1 h: w3 is the gate).
LAYER_LEAF = {"q": "wq.weight", "k": "wk.weight", "v": "wv.weight",
              "o": "wo.weight", "gate": "w3.weight", "up": "w1.weight",
              "down": "w2.weight", "attn_norm": "attn_norm",
              "mlp_norm": "mlp_norm", "q_norm": "q_norm", "k_norm": "k_norm"}
GLOBAL_LEAF = {"embed": "embed.weight", "head": "lm_head.weight",
               "final_norm": "final_norm"}


def port_name(leaf: str) -> str:
    if leaf in GLOBAL_LEAF:
        return GLOBAL_LEAF[leaf]
    _, i, name = leaf.split(".", 2)
    return f"layers.{i}.{LAYER_LEAF[name]}"


def bench_name(param: str) -> str:
    inverse = {v: k for k, v in GLOBAL_LEAF.items()}
    if param in inverse:
        return inverse[param]
    _, i, name = param.split(".", 2)
    layer = {v: k for k, v in LAYER_LEAF.items()}
    return f"layers.{i}.{layer[name]}"


def dtype_of(config: dict):
    import torch

    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[config["torch_dtype"]]


def build_model(config: dict, seed: int, device, **overrides):
    """(model, LlamaConfig, arch): the port's `Llama` of `config` in its
    published dtype, on `device`, holding the benchmark's weights for
    `seed`. `overrides` set the port's run options (attention, remat,
    max_seq_len)."""
    import torch

    from ray_tpu_torch.models import hf_convert, llama

    a = weights.arch(config)
    if a["tied"]:
        raise NotImplementedError("a tied head would train as two leaves")
    cfg = hf_convert.config_from_hf(SimpleNamespace(**config))
    cfg = dataclasses.replace(cfg, dtype=dtype_of(config), **overrides)
    model = llama.Llama(cfg, device="meta")
    model.to_empty(device=device)
    params = dict(model.named_parameters())
    if set(params) != {port_name(n) for n in weights.leaf_names(a)}:
        raise ValueError("the port's parameters are not the configuration's")
    with torch.no_grad():
        for name, t in weights.all_weights(a, seed, device, cfg.dtype):
            params[port_name(name)].copy_(t)
    return model, cfg, a
