"""Runtime internals of the PyTorch/CUDA port."""
