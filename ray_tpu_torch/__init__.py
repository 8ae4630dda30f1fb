"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute stack, for
NVIDIA Hopper (H100).

It mirrors `ray_tpu`'s layout (`ops/`, `models/`, `train/`, `llm/`), imports
`torch` and never `jax` or anything under `ray_tpu`; what it needs from
a `ray_tpu` module it keeps as its own copy. Flash attention runs on two
CUDA kernels written for sm_90a (`csrc/`), built with nvcc at first use.
Entry points run on "cuda" unless the caller passes `device="cpu"`.
"""

from . import llm, models, ops, train
from .models import LlamaConfig, init_params, loss_fn
from .ops import flash_attention
from .train import default_optimizer, make_train_step

__all__ = [
    "LlamaConfig",
    "default_optimizer",
    "flash_attention",
    "init_params",
    "llm",
    "loss_fn",
    "make_train_step",
    "models",
    "ops",
    "train",
]
