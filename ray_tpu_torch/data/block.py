# Copied from ray_tpu/data/block.py (JAX-free).
"""Block format helpers.

Reference: python/ray/data/block.py — a Dataset is a list of blocks
held in the object store. The reference's canonical block is an Arrow
table; here the canonical block is a **list of dict rows**, with
column-major numpy batches as the exchange format for map_batches /
iter_batches — numpy feeds `jax.numpy.asarray` zero-copy, which is the
TPU-side consumer that matters.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np

try:  # reference's canonical block format; optional here
    import pyarrow as _pa
except ImportError:
    _pa = None
try:
    import pandas as _pd
except ImportError:
    _pd = None

Block = List[dict]
Batch = Dict[str, np.ndarray]


def rows_to_batch(rows: Block) -> Batch:
    """Row-major -> column-major numpy."""
    if not rows:
        return {}
    columns: Dict[str, list] = {k: [] for k in rows[0]}
    for row in rows:
        for key in columns:
            columns[key].append(row[key])
    return {k: np.asarray(v) for k, v in columns.items()}


def batch_to_rows(batch: Any) -> Block:
    """Column-major (dict of arrays/lists) -> rows. Lists of rows pass
    through; scalars broadcast is not supported (match lengths).
    pyarrow Tables and pandas DataFrames returned by a map_batches UDF
    convert too, so `batch_format="pyarrow"/"pandas"` round-trips."""
    if _pa is not None and isinstance(batch, _pa.Table):
        return batch.to_pylist()
    if _pd is not None and isinstance(batch, _pd.DataFrame):
        return batch.to_dict("records")
    if isinstance(batch, list):
        return batch
    if not isinstance(batch, dict):
        raise TypeError(
            f"map_batches must return a dict of columns or a list of "
            f"rows, got {type(batch).__name__}"
        )
    if not batch:
        return []
    lengths = {k: len(v) for k, v in batch.items()}
    n = next(iter(lengths.values()))
    if any(v != n for v in lengths.values()):
        raise ValueError(f"ragged batch columns: {lengths}")
    keys = list(batch.keys())
    return [
        {k: _unwrap(batch[k][i]) for k in keys} for i in range(n)
    ]


def _unwrap(value):
    """numpy scalars -> python scalars for row ergonomics."""
    if isinstance(value, np.generic):
        return value.item()
    return value


def format_batch(rows: Block, batch_format: str):
    if batch_format in ("numpy", "default"):
        return rows_to_batch(rows)
    if batch_format in ("rows", "dicts"):
        return list(rows)
    if batch_format == "pandas":
        import pandas as pd

        return pd.DataFrame(rows)
    if batch_format == "pyarrow":  # reference's canonical block format
        import pyarrow as pa

        return pa.Table.from_pylist(rows)
    raise ValueError(f"unknown batch_format {batch_format!r}")


def iter_slices(rows: Block, size: int) -> Iterable[Block]:
    for start in range(0, len(rows), size):
        yield rows[start : start + size]
