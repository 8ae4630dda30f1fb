# Copied from ray_tpu/data/__init__.py (JAX-free).
"""Distributed datasets (reference: python/ray/data)."""

from .block import Batch, Block
from .dataset import (
    ActorPoolStrategy,
    DataIterator,
    Dataset,
    GroupedData,
)
from .read_api import (
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    from_torch,
    range,  # noqa: A004 — reference API name
    read_binary_files,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
)

__all__ = [
    "ActorPoolStrategy",
    "Dataset",
    "DataIterator",
    "GroupedData",
    "Block",
    "Batch",
    "range",
    "from_items",
    "from_numpy",
    "from_pandas",
    "from_arrow",
    "from_torch",
    "from_huggingface",
    "read_csv",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
    "read_binary_files",
    "read_tfrecords",
]
