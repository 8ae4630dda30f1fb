"""The benchmark's yardstick: the card's peaks, and the operations and
bytes that each measured piece of work needs, computed from its shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit,
dense rates without sparsity. `bound_s`, `valid_pairs` and `f32_ops_s`
follow the arithmetic the port's kernel table was measured with;
`train_flops_per_token` leaves out the input embedding (a lookup, not a
product) and any recompute, so a step's share of the peak counts only
the work the model needs.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
#: Three TF32 products stand in for one f32 product on the tensor cores.
TF32_TERMS = 3


def valid_pairs(causal: bool, q_len: int, kv_len: int) -> int:
    """Unmasked (query, key) pairs of one head, with the causal mask
    anchored top-left (query r sees keys 0..r): the work this data
    needs."""
    if not causal:
        return q_len * kv_len
    full = min(q_len, kv_len)
    return full * (full + 1) // 2 + max(q_len - kv_len, 0) * kv_len


def f32_ops_s(flops: float) -> float:
    """The least time of `flops` f32 operations: on the CUDA cores, or
    as three TF32 terms on the tensor cores, whichever is less."""
    return min(flops / PEAK_F32_FLOPS, TF32_TERMS * flops / PEAK_TF32_FLOPS)


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least seconds, "operations" or "bytes"): the larger of `flops`
    at `peak` (None: f32 work, `f32_ops_s`) and `nbytes` at the HBM
    rate."""
    ops = f32_ops_s(flops) if peak is None else flops / peak
    mem = nbytes / HBM_BYTES_PER_S
    return max(ops, mem), ("operations" if ops >= mem else "bytes")


def layer_params(arch: dict) -> int:
    """Parameters of one decoder layer: the four attention projections,
    the gated MLP's three matrices, two RMSNorm scales and, with
    qk_norm, the two per-head scales."""
    d, hd = arch["dim"], arch["head_dim"]
    attn = d * hd * (2 * arch["heads"] + 2 * arch["kv_heads"])
    mlp = 3 * d * arch["intermediate"]
    norms = 2 * d + (2 * hd if arch["qk_norm"] else 0)
    return attn + mlp + norms


def matmul_params(arch: dict) -> int:
    """Parameters that a token multiplies: every layer, the final norm
    and the output head. The input embedding is a lookup."""
    return (arch["layers"] * layer_params(arch) + arch["dim"]
            + arch["vocab"] * arch["dim"])


def total_params(arch: dict) -> int:
    embed = 0 if arch["tied"] else arch["vocab"] * arch["dim"]
    return matmul_params(arch) + embed


def train_flops_per_token(arch: dict, seq: int) -> float:
    """Model FLOPs a trained token needs, forward and backward:
    6 x the multiplied parameters, plus causal attention's
    12 x layers x heads x head_dim x seq / 2. No recompute."""
    attn = 12 * arch["layers"] * arch["heads"] * arch["head_dim"] * seq / 2
    return 6.0 * matmul_params(arch) + attn


def flash_fwd_flops(batch: int, heads: int, q_len: int, kv_len: int,
                    head_dim: int, causal: bool = True) -> float:
    """One flash forward launch: S = QK^T and O = PV over the valid
    pairs, 2 operations a multiply-add."""
    return 4.0 * batch * heads * valid_pairs(causal, q_len, kv_len) * head_dim


def flash_bwd_flops(batch: int, heads: int, q_len: int, kv_len: int,
                    head_dim: int, causal: bool = True) -> float:
    """One flash backward op: S again, dP, dV, dK and dQ, five products
    over the valid pairs."""
    return 2.5 * flash_fwd_flops(batch, heads, q_len, kv_len, head_dim,
                                 causal)


def flash_io_bytes(batch: int, heads: int, q_len: int, kv_len: int,
                   head_dim: int, elem: int = 2, backward: bool = False
                   ) -> float:
    """Bytes a flash launch must move at least: Q, K, V and O once (the
    backward adds dO, dQ, dK and dV)."""
    q = batch * heads * q_len * head_dim * elem
    kv = batch * heads * kv_len * head_dim * elem
    return (2 * q + 2 * kv) * (2 if backward else 1)


def decode_weight_bytes(arch: dict, elem: int = 2) -> int:
    """Bytes of weights one decode step reads: every multiplied
    parameter once. The embedding is a lookup of one row a token."""
    return matmul_params(arch) * elem


def kv_bytes_per_token(arch: dict, elem: int = 2) -> int:
    """Cache bytes of one token: K and V of every layer."""
    return 2 * arch["layers"] * arch["kv_heads"] * arch["head_dim"] * elem
