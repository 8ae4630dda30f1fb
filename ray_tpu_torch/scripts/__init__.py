# Copied from ray_tpu/scripts/__init__.py (JAX-free): module names read ray_tpu_torch.
