"""Models of the PyTorch/CUDA port (counterpart of `ray_tpu/models`)."""

from .llama import (
    Llama,
    LlamaConfig,
    LlamaLayer,
    flops_per_token,
    forward,
    forward_and_aux,
    init_params,
    load_jax_params,
    loss_fn,
    masked_xent,
    to_jax_params,
)

__all__ = [
    "Llama",
    "LlamaConfig",
    "LlamaLayer",
    "flops_per_token",
    "forward",
    "forward_and_aux",
    "init_params",
    "load_jax_params",
    "loss_fn",
    "masked_xent",
    "to_jax_params",
]
