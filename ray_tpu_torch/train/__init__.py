"""Training of the PyTorch/CUDA port (counterpart of `ray_tpu/train`)."""

from .train_step import TrainState, default_optimizer, make_train_step

__all__ = ["TrainState", "default_optimizer", "make_train_step"]
