# Copied from ray_tpu/data/read_api.py (JAX-free).
"""Dataset creation APIs.

Reference: python/ray/data/read_api.py — 35 read/from constructors;
the ones that matter for TPU input pipelines are implemented natively
(range/items + csv/json/jsonl/parquet/text/binary/numpy/tfrecords via
one read task per file, and from_numpy/from_pandas/from_arrow/
from_torch/from_huggingface in-memory converters), the hosted-service
connector zoo (BigQuery/Mongo/Iceberg/...) is out of scope and
documented as such.
"""

from __future__ import annotations

import builtins
import glob as _glob
import os
from typing import Any, Dict, List

import numpy as np

from .dataset import Dataset
from .executor import ReadStage


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            out.extend(
                sorted(
                    os.path.join(path, f)
                    for f in os.listdir(path)
                    if not f.startswith(".")
                )
            )
        elif any(c in path for c in "*?["):
            out.extend(sorted(_glob.glob(path)))
        else:
            out.append(path)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    if parallelism <= 0:
        parallelism = min(32, max(1, n // 1000 or 1))
    step = -(-n // parallelism)
    tasks = []
    for start in builtins.range(0, n, step):
        end = min(n, start + step)
        tasks.append(
            lambda s=start, e=end: [
                {"id": i} for i in builtins.range(s, e)
            ]
        )
    return Dataset([ReadStage(tasks, "read_range")])


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    rows = [
        item if isinstance(item, dict) else {"item": item}
        for item in items
    ]
    if parallelism <= 0:
        parallelism = min(32, max(1, len(rows) // 100 or 1))
    step = -(-len(rows) // parallelism) if rows else 1
    chunks = [
        rows[i : i + step] for i in builtins.range(0, len(rows), step)
    ] or [[]]
    return Dataset(
        [ReadStage([lambda c=c: c for c in chunks], "from_items")]
    )


def from_numpy(arrays: Dict[str, np.ndarray]) -> Dataset:
    n = len(next(iter(arrays.values())))
    rows = [
        {k: v[i] for k, v in arrays.items()} for i in builtins.range(n)
    ]
    return from_items(rows)


def _file_read_dataset(paths, read_one, name: str) -> Dataset:
    files = _expand_paths(paths)
    return Dataset(
        [ReadStage([lambda p=p: read_one(p) for p in files], name)]
    )


def read_csv(paths, *, parallelism: int = -1) -> Dataset:
    def read_one(path: str):
        import pyarrow.csv as pacsv

        return pacsv.read_csv(path).to_pylist()

    return _file_read_dataset(paths, read_one, "read_csv")


def read_json(paths, *, parallelism: int = -1) -> Dataset:
    def read_one(path: str):
        import json

        with open(path) as f:
            text = f.read().strip()
        if not text:
            return []
        if text[0] == "[":
            return json.loads(text)
        return [json.loads(line) for line in text.splitlines() if line]

    return _file_read_dataset(paths, read_one, "read_json")


def read_parquet(paths, *, parallelism: int = -1) -> Dataset:
    def read_one(path: str):
        import pyarrow.parquet as pq

        return pq.read_table(path).to_pylist()

    return _file_read_dataset(paths, read_one, "read_parquet")


def read_text(paths, *, parallelism: int = -1) -> Dataset:
    def read_one(path: str):
        with open(path) as f:
            return [{"text": line.rstrip("\n")} for line in f]

    return _file_read_dataset(paths, read_one, "read_text")


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    def read_one(path: str):
        with open(path, "rb") as f:
            return [{"path": path, "bytes": f.read()}]

    return _file_read_dataset(paths, read_one, "read_binary_files")


def read_numpy(paths, *, column: str = "data") -> Dataset:
    """.npy (one row per outer index) and .npz (one column per
    array) files (reference: read_api.py read_numpy)."""

    def read_one(path: str):
        loaded = np.load(path, allow_pickle=False)
        if isinstance(loaded, np.ndarray):
            return [{column: row} for row in loaded]
        arrays = {k: loaded[k] for k in loaded.files}
        n = len(next(iter(arrays.values())))
        return [
            {k: v[i] for k, v in arrays.items()}
            for i in builtins.range(n)
        ]

    return _file_read_dataset(paths, read_one, "read_numpy")


def read_tfrecords(paths, *, raw: bool = False) -> Dataset:
    """TFRecord files of tf.train.Example payloads, no tensorflow
    required (reference: read_api.py read_tfrecords; container/proto
    codec in data/tfrecords.py). `raw=True` yields undecoded
    {"bytes": payload} rows (webdataset-style passthrough)."""

    def read_one(path: str):
        from . import tfrecords as tfr

        if raw:
            return [
                {"bytes": payload}
                for payload in tfr.read_records(path)
            ]
        return [
            tfr.decode_example(payload)
            for payload in tfr.read_records(path)
        ]

    return _file_read_dataset(paths, read_one, "read_tfrecords")


def from_pandas(dfs) -> Dataset:
    """One block per DataFrame (reference: read_api.py from_pandas)."""
    import pandas as pd

    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    chunks = [df.to_dict("records") for df in dfs]
    return Dataset(
        [ReadStage([lambda c=c: c for c in chunks], "from_pandas")]
    )


def from_arrow(tables) -> Dataset:
    """One block per pyarrow Table (reference: from_arrow)."""
    import pyarrow as pa

    if isinstance(tables, pa.Table):
        tables = [tables]
    chunks = [table.to_pylist() for table in tables]
    return Dataset(
        [ReadStage([lambda c=c: c for c in chunks], "from_arrow")]
    )


def from_torch(torch_dataset, *, parallelism: int = -1) -> Dataset:
    """Map-style torch Dataset -> rows {"item": sample} (reference:
    from_torch). Materializes through __getitem__ on read workers in
    index ranges."""
    n = len(torch_dataset)
    if parallelism <= 0:
        parallelism = min(8, max(1, n // 1000 or 1))
    step = -(-n // parallelism) if n else 1

    def read_range(start: int, end: int):
        return [
            {"item": torch_dataset[i]}
            for i in builtins.range(start, end)
        ]

    tasks = [
        lambda s=s, e=min(n, s + step): read_range(s, e)
        for s in builtins.range(0, n, step)
    ] or [lambda: []]
    return Dataset([ReadStage(tasks, "from_torch")])


def from_huggingface(hf_dataset) -> Dataset:
    """datasets.Dataset -> one block per shard-ish chunk (reference:
    from_huggingface). Works with any object exposing __len__ +
    __getitem__(int) -> dict (the HF arrow-backed map-style API)."""
    n = len(hf_dataset)
    step = max(1, -(-n // 8))
    chunks = []
    for start in builtins.range(0, n, step):
        end = min(n, start + step)
        chunks.append(
            lambda s=start, e=end: [
                dict(hf_dataset[i]) for i in builtins.range(s, e)
            ]
        )
    return Dataset(
        [ReadStage(chunks or [lambda: []], "from_huggingface")]
    )
