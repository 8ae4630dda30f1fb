"""Ops of the PyTorch/CUDA port (counterpart of `ray_tpu/ops`)."""

from .attention import (
    LAUNCHES,
    flash_attention,
    mha_reference,
    repeat_kv,
    reset_launch_counts,
)
from .moe import init_moe_params, moe_ffn_dense, moe_ffn_ep, top_k_router
from .norms import (
    apply_rotary,
    rms_norm,
    rope_frequencies,
    rotary_embedding,
    swiglu,
)
from .ring_attention import ring_attention, ulysses_attention

__all__ = [
    "LAUNCHES",
    "apply_rotary",
    "flash_attention",
    "init_moe_params",
    "mha_reference",
    "moe_ffn_dense",
    "moe_ffn_ep",
    "repeat_kv",
    "reset_launch_counts",
    "ring_attention",
    "rms_norm",
    "rope_frequencies",
    "rotary_embedding",
    "swiglu",
    "top_k_router",
    "ulysses_attention",
]
