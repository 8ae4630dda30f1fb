# Copied from ray_tpu/__main__.py (JAX-free): module names read ray_tpu_torch.
from .scripts.cli import main

main()
