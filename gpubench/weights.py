"""A configuration's shapes, and its weights made on the device from the
seed.

`arch(config)` reads the published `config.json` keys a configuration
file holds. The weights come in groups, each drawn with one call from a
generator of its own seed: the embedding, the output head, and each
layer's seven matrices at once. So a group can be made again alone, as
the reference and the readings of the parameters' change do, one layer
at a time. Every matrix is [out, in], normal with standard deviation
1/sqrt(in), rounded once to the served type; the norms are ones.

Leaf names are the benchmark's own: `embed`, `head`, `final_norm`, and
`layers.<i>.<leaf>` for the leaves of `LAYER_LEAVES`.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, Tuple

import torch

#: A layer's matrices, in the order they are cut from its draw.
LAYER_MATRICES = ("q", "k", "v", "o", "gate", "up", "down")
NORMS = ("attn_norm", "mlp_norm")
QK_NORMS = ("q_norm", "k_norm")


def arch(config: dict) -> dict:
    """The shapes and constants the harness needs from a configuration
    file's published keys."""
    heads = config["num_attention_heads"]
    head_dim = config.get("head_dim") or config["hidden_size"] // heads
    return {
        "vocab": config["vocab_size"],
        "dim": config["hidden_size"],
        "layers": config["num_hidden_layers"],
        "heads": heads,
        "kv_heads": config.get("num_key_value_heads", heads),
        "head_dim": head_dim,
        "intermediate": config["intermediate_size"],
        "rope_theta": float(config.get("rope_theta", 10000.0)),
        "eps": float(config["rms_norm_eps"]),
        "qk_norm": config["model_type"] == "qwen3",
        "tied": bool(config.get("tie_word_embeddings", False)),
    }


def layer_shapes(a: dict) -> Dict[str, Tuple[int, ...]]:
    d, hd = a["dim"], a["head_dim"]
    shapes = {
        "q": (a["heads"] * hd, d), "k": (a["kv_heads"] * hd, d),
        "v": (a["kv_heads"] * hd, d), "o": (d, a["heads"] * hd),
        "gate": (a["intermediate"], d), "up": (a["intermediate"], d),
        "down": (d, a["intermediate"]),
        "attn_norm": (d,), "mlp_norm": (d,),
    }
    if a["qk_norm"]:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return shapes


def leaf_names(a: dict) -> list:
    """Every leaf, in the benchmark's order."""
    names = ["embed"]
    for i in range(a["layers"]):
        names += [f"layers.{i}.{leaf}" for leaf in layer_shapes(a)]
    return names + ["final_norm", "head"]


def _seed(seed: int, tag: str) -> int:
    digest = hashlib.blake2b(f"{int(seed)}:{tag}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _draw(shapes, seed: int, tag: str, device, dtype) -> Dict[str, torch.Tensor]:
    """One normal draw for all of `shapes` (matrices), cut and scaled by
    1/sqrt(in) each."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, tag))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, start = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat[start:start + n].view(shape).mul_(1.0 / math.sqrt(shape[1]))
        start += n
    return out


def layer_weights(a: dict, seed: int, i: int, device,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Layer `i`'s leaves, by leaf name (views of one buffer)."""
    shapes = layer_shapes(a)
    out = _draw({k: shapes[k] for k in LAYER_MATRICES}, seed, f"layer{i}",
                device, dtype)
    for name in NORMS + (QK_NORMS if a["qk_norm"] else ()):
        out[name] = torch.ones(shapes[name], device=device, dtype=dtype)
    return out


def global_weights(a: dict, seed: int, device,
                   dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """`embed`, `head` and `final_norm`. A tied head is the embedding."""
    shape = (a["vocab"], a["dim"])
    out = _draw({"embed": shape}, seed, "embed", device, dtype)
    out["head"] = (out["embed"] if a["tied"]
                   else _draw({"head": shape}, seed, "head", device, dtype)["head"])
    out["final_norm"] = torch.ones(a["dim"], device=device, dtype=dtype)
    return out


def all_weights(a: dict, seed: int, device, dtype=torch.bfloat16
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(leaf name, tensor) of every leaf, one group at a time."""
    glob = global_weights(a, seed, device, dtype)
    yield "embed", glob["embed"]
    for i in range(a["layers"]):
        for leaf, t in layer_weights(a, seed, i, device, dtype).items():
            yield f"layers.{i}.{leaf}", t
    yield "final_norm", glob["final_norm"]
    yield "head", glob["head"]
