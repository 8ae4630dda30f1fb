"""Models of the PyTorch/CUDA port (counterpart of `ray_tpu/models`).

As in the JAX package, the `generate()` FUNCTION is not re-exported
here: it would shadow the `generate` submodule; import it from there."""

from .generate import (
    decode_step,
    generate_stream,
    init_block_pool,
    init_kv_cache,
    paged_decode_step,
    paged_prefill,
    prefill,
)
from .hf_convert import config_from_hf, convert_hf_llama, load_hf_llama
from .llama import (
    Llama,
    LlamaConfig,
    LlamaLayer,
    forward,
    forward_and_aux,
    init_params,
    load_jax_params,
    loss_fn,
    masked_xent,
    param_annotations,
    to_jax_params,
)

__all__ = [
    "Llama",
    "LlamaConfig",
    "LlamaLayer",
    "config_from_hf",
    "convert_hf_llama",
    "decode_step",
    "forward",
    "forward_and_aux",
    "generate_stream",
    "init_block_pool",
    "init_kv_cache",
    "init_params",
    "load_hf_llama",
    "load_jax_params",
    "loss_fn",
    "masked_xent",
    "paged_decode_step",
    "paged_prefill",
    "param_annotations",
    "prefill",
    "to_jax_params",
]
