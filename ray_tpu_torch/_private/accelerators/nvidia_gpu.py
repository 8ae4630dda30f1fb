# Copied from ray_tpu/_private/accelerators/nvidia_gpu.py (JAX-free), with
# the card count read from CUDA_VISIBLE_DEVICES where it is set, and from
# `nvidia-smi -L` where the driver's /proc entries are missing.
"""NVIDIA GPU manager (reference:
python/ray/_private/accelerators/nvidia_gpu.py). The port's one
accelerator family: it counts the node's cards (the "GPU" resource) and
names CUDA_VISIBLE_DEVICES as the variable that scopes them."""

from __future__ import annotations

import glob
from functools import lru_cache

from .base import AcceleratorManager


class NvidiaGPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return "CUDA_VISIBLE_DEVICES"

    @staticmethod
    @lru_cache()
    def get_current_node_num_accelerators() -> int:
        import os

        override = os.environ.get("RT_NUM_GPUS")
        if override is not None:
            return int(override)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            return len([d for d in visible.split(",") if d.strip()])
        found = len(glob.glob("/proc/driver/nvidia/gpus/*"))
        if found == 0:
            # A container may hide the driver's /proc entries (the H100
            # machine does, and shows more /dev/nvidia<N> files than it
            # has cards); nvidia-smi lists the cards without initialising
            # CUDA in this process, which may fork.
            import subprocess

            try:
                listed = subprocess.run(
                    ["nvidia-smi", "-L"], capture_output=True, text=True,
                    timeout=30).stdout
            except (OSError, subprocess.SubprocessError):
                return 0
            found = sum(1 for line in listed.splitlines()
                        if line.startswith("GPU "))
        return found
