# Copied from ray_tpu/_private/accelerators/base.py (JAX-free): module names read ray_tpu_torch.
"""Accelerator manager interface (reference:
python/ray/_private/accelerators/accelerator.py — the abstract surface
every accelerator family implements)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class AcceleratorManager:
    """Detection + visibility scoping for one accelerator family."""

    @staticmethod
    def get_resource_name() -> str:
        raise NotImplementedError

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        raise NotImplementedError

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        raise NotImplementedError

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        return None

    @classmethod
    def get_current_process_visible_accelerator_ids(
        cls,
    ) -> Optional[List[str]]:
        import os

        raw = os.environ.get(cls.get_visible_accelerator_ids_env_var())
        if raw is None:
            return None
        if raw == "":
            return []
        return raw.split(",")

    @classmethod
    def set_visible_accelerator_ids(
        cls, env: Dict[str, str], ids: List[str]
    ) -> None:
        env[cls.get_visible_accelerator_ids_env_var()] = ",".join(ids)

    @staticmethod
    def get_extra_resources_and_labels(
        num_accelerators: int,
    ) -> Tuple[Dict[str, float], Dict[str, str]]:
        """Family-specific auto-resources (e.g. TPU pod head markers)
        and node labels."""
        return {}, {}
