"""Ops of the PyTorch/CUDA port (counterpart of `ray_tpu/ops`)."""

from .attention import (
    LAUNCHES,
    flash_attention,
    mha_reference,
    repeat_kv,
    reset_launch_counts,
)
from .norms import (
    apply_rotary,
    rms_norm,
    rope_frequencies,
    rotary_embedding,
    swiglu,
)

__all__ = [
    "LAUNCHES",
    "apply_rotary",
    "flash_attention",
    "mha_reference",
    "repeat_kv",
    "reset_launch_counts",
    "rms_norm",
    "rope_frequencies",
    "rotary_embedding",
    "swiglu",
]
