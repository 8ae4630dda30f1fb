# Copied from ray_tpu/data/dataset.py (JAX-free).
"""Dataset: lazy logical plan over row blocks.

Reference: python/ray/data/dataset.py — a Dataset is a lazy plan
(logical operators) executed by the streaming executor into object-
store blocks; map/filter/flat_map/map_batches are per-block tasks,
repartition/random_shuffle/sort/groupby are all-to-all shuffles
(_internal/planner/exchange/), iteration pulls blocks; streaming_split
(dataset.py streaming_split + _internal/execution/operators/
output_splitter.py) feeds Train workers disjoint streams.
"""

from __future__ import annotations

import builtins
import queue as _queue
import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch as rt

from .._private import step_telemetry as _telemetry
from .block import (
    Block,
    batch_to_rows,
    format_batch,
    iter_slices,
    rows_to_batch,
)
from .executor import (
    ActorPoolStage,
    AllToAllStage,
    LimitStage,
    MapStage,
    ReadStage,
    Stage,
    execute_streaming,
)


class ActorPoolStrategy:
    """Compute strategy running a stage's UDF on warm, reusable actors
    (reference: python/ray/data/_internal/compute.py ActorPoolStrategy
    + operators/actor_pool_map_operator.py). Use for UDFs with
    expensive per-process setup — the pool autoscales between min_size
    and max_size on backlog."""

    def __init__(
        self,
        min_size: int = 1,
        max_size: int = 4,
        *,
        max_tasks_per_actor: int = 2,
        num_cpus: float = 1.0,
    ):
        if min_size < 1 or max_size < min_size:
            raise ValueError(
                f"bad pool bounds [{min_size}, {max_size}]"
            )
        self.min_size = min_size
        self.max_size = max_size
        self.max_tasks_per_actor = max_tasks_per_actor
        self.num_cpus = num_cpus


#: How far the block-ref stream pulls ahead of a prefetching batch
#: iterator: keeps the streaming executor submitting upstream tasks
#: while the prefetch thread is blocked inside an rt.get.
_REF_PULL_AHEAD = 2


def _prefetched(iterator: Iterator[Any], window: int) -> Iterator[Any]:
    """Run `iterator` on a background thread, yielding its items in
    order through a bounded queue (reference: iter_batches
    prefetch_batches -> _internal/block_batching prefetcher).

    Contract: order-preserving; exceptions from the producer re-raise
    at the consumer's next(); closing the returned generator (early
    `break`, GC) stops the producer promptly, closes the wrapped
    iterator (cascading cancellation for nested prefetchers), and
    joins the thread — no leaked threads, no dangling gets beyond the
    one already in flight.
    """
    out: _queue.Queue = _queue.Queue(maxsize=max(1, window))
    stop = threading.Event()

    def _put(item) -> bool:
        """Blocking put that aborts when the consumer went away."""
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def producer():
        try:
            try:
                for item in iterator:
                    if not _put(("item", item)) or stop.is_set():
                        return  # consumer gone: do not start another get
                _put(("done", None))
            except BaseException as e:  # noqa: BLE001 — relayed to consumer
                _put(("error", e))
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    thread = threading.Thread(
        target=producer, daemon=True, name="rt-data-prefetch"
    )

    def consume():
        # Started on first next(): a generator that is created but
        # never consumed must not leave a producer thread behind.
        thread.start()
        try:
            while True:
                kind, value = out.get()
                if kind == "item":
                    yield value
                elif kind == "done":
                    return
                else:
                    raise value
        finally:
            stop.set()
            # No drain needed: a producer blocked in put() re-checks
            # stop every 0.1s and exits WITHOUT consuming another
            # item from the wrapped iterator (draining here would let
            # its put succeed and the loop advance into one more
            # blocking get).
            thread.join(timeout=10.0)

    return consume()


def _batches_from_blocks(
    blocks: Iterator[Block],
    batch_size: int,
    batch_format: str,
    drop_last: bool,
) -> Iterator[Any]:
    """The one batching loop: both the serial and the prefetching
    iter_batches run THIS code, so ordering and drop_last semantics
    cannot drift between them."""
    carry: Block = []
    for block in blocks:
        carry.extend(block)
        while len(carry) >= batch_size:
            yield format_batch(carry[:batch_size], batch_format)
            carry = carry[batch_size:]
    if carry and not drop_last:
        yield format_batch(carry, batch_format)


class Dataset:
    def __init__(
        self,
        stages: List[Stage],
        window: int = 8,
        inflight_bytes: Optional[int] = None,
    ):
        self._stages = stages
        self._window = window
        self._inflight_bytes = inflight_bytes
        self._materialized: Optional[List[Any]] = None  # block refs

    # -- plan building -------------------------------------------------
    def _with(self, stage: Stage) -> "Dataset":
        return Dataset(
            self._stages + [stage], self._window, self._inflight_bytes
        )

    def options(
        self,
        *,
        window: Optional[int] = None,
        inflight_bytes: Optional[int] = None,
    ) -> "Dataset":
        """Execution knobs: per-stage in-flight task window and byte
        budget (reference: ExecutionOptions / DataContext resource
        limits)."""
        return Dataset(
            self._stages,
            window if window is not None else self._window,
            inflight_bytes
            if inflight_bytes is not None
            else self._inflight_bytes,
        )

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._with(
            MapStage(lambda block: [fn(row) for row in block], "map")
        )

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._with(
            MapStage(
                lambda block: [row for row in block if fn(row)], "filter"
            )
        )

    def flat_map(self, fn: Callable[[dict], List[dict]]) -> "Dataset":
        return self._with(
            MapStage(
                lambda block: [
                    out for row in block for out in fn(row)
                ],
                "flat_map",
            )
        )

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: Optional[ActorPoolStrategy] = None,
        fn_constructor_args: tuple = (),
    ) -> "Dataset":
        """Per-batch transform. `fn` may be a callable CLASS when
        `compute=ActorPoolStrategy(...)`: each pool actor instantiates
        it once (with fn_constructor_args) and reuses the instance for
        every batch — the warm-state UDF pattern (reference:
        dataset.py map_batches(compute=ActorPoolStrategy))."""

        def make_apply(udf):
            def apply(block: Block) -> Block:
                out: Block = []
                slices = (
                    iter_slices(block, batch_size)
                    if batch_size
                    else [block]
                )
                for rows in slices:
                    result = udf(format_batch(rows, batch_format))
                    out.extend(batch_to_rows(result))
                return out

            return apply

        if compute is not None:
            return self._with(
                ActorPoolStage(
                    fn,
                    make_apply,
                    ctor_args=tuple(fn_constructor_args),
                    min_size=compute.min_size,
                    max_size=compute.max_size,
                    max_tasks_per_actor=compute.max_tasks_per_actor,
                    num_cpus=compute.num_cpus,
                    name="map_batches(actors)",
                )
            )
        if isinstance(fn, type):
            raise ValueError(
                "class UDFs require compute=ActorPoolStrategy(...)"
            )
        return self._with(MapStage(make_apply(fn), "map_batches"))

    def add_column(self, name: str, fn: Callable[[dict], Any]) -> "Dataset":
        return self.map(lambda row: {**row, name: fn(row)})

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map(
            lambda row: {k: v for k, v in row.items() if k not in cols}
        )

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map(lambda row: {k: row[k] for k in cols})

    def limit(self, n: int) -> "Dataset":
        return self._with(LimitStage(n))

    # -- all-to-all ----------------------------------------------------
    def repartition(self, num_blocks: int) -> "Dataset":
        def split(block: Block, n: int) -> List[Block]:
            size = max(1, -(-len(block) // n)) if block else 1
            parts = [
                block[i * size : (i + 1) * size] for i in range(n)
            ]
            return parts

        return self._with(
            AllToAllStage(
                lambda refs: _shuffle(refs, num_blocks, split, _concat),
                "repartition",
            )
        )

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        def split(block: Block, n: int) -> List[Block]:
            rng = random.Random(
                seed if seed is not None else len(block)
            )
            parts: List[Block] = [[] for _ in range(n)]
            for row in block:
                parts[rng.randrange(n)].append(row)
            return parts

        def combine(*parts: Block) -> Block:
            rows = [row for part in parts for row in part]
            random.Random(seed).shuffle(rows)
            return rows

        def run(refs):
            n = max(1, len(refs))
            return _shuffle(refs, n, split, combine)

        return self._with(AllToAllStage(run, "random_shuffle"))

    def sort(self, key: str, *, descending: bool = False) -> "Dataset":
        def run(refs):
            n = max(1, len(refs))
            if not refs:
                return refs
            # Sample range boundaries (reference: exchange/sort_task_
            # spec.py samples blocks to pick partition boundaries).
            sample_task = rt.remote(num_cpus=1)(
                lambda block: sorted(row[key] for row in block)
            )
            samples = sorted(
                v
                for chunk in rt.get([sample_task.remote(r) for r in refs])
                for v in chunk
            )
            if not samples:
                return refs  # all blocks empty: nothing to sort
            bounds = [
                samples[
                    min((i + 1) * len(samples) // n, len(samples) - 1)
                ]
                for i in range(n - 1)
            ]

            def split(block: Block, parts_n: int) -> List[Block]:
                parts: List[Block] = [[] for _ in range(parts_n)]
                for row in block:
                    import bisect

                    parts[bisect.bisect_right(bounds, row[key])].append(
                        row
                    )
                return parts

            def combine(*parts: Block) -> Block:
                rows = [row for part in parts for row in part]
                rows.sort(key=lambda r: r[key], reverse=descending)
                return rows

            out = _shuffle(refs, n, split, combine)
            return list(reversed(out)) if descending else out

        return self._with(AllToAllStage(run, "sort"))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def union(self, other: "Dataset") -> "Dataset":
        def run(refs):
            return refs + list(
                execute_streaming(
                    other._stages,
                    other._window,
                    other._inflight_bytes,
                )
            )

        return self._with(AllToAllStage(run, "union"))

    # -- execution -----------------------------------------------------
    def _block_refs(self) -> List[Any]:
        if self._materialized is None:
            self._materialized = list(
                execute_streaming(
                    self._stages, self._window, self._inflight_bytes
                )
            )
        return self._materialized

    def iter_block_refs(self, *, prefetch: int = 0) -> Iterator[Any]:
        """Yield output block refs. prefetch>0 pulls up to that many
        refs ahead of the consumer on a background thread, keeping the
        streaming executor submitting upstream tasks while the
        consumer is busy (e.g. blocked in rt.get on an earlier
        block)."""
        if self._materialized is not None:
            # Already-resident refs: a pull-ahead thread over an
            # in-memory list buys nothing.
            return iter(self._materialized)
        base = execute_streaming(
            self._stages, self._window, self._inflight_bytes
        )
        if prefetch > 0:
            return _prefetched(base, prefetch)
        return base

    def materialize(self) -> "Dataset":
        self._block_refs()
        return self

    def num_blocks(self) -> int:
        return len(self._block_refs())

    def iter_rows(self) -> Iterator[dict]:
        for ref in self.iter_block_refs():
            yield from rt.get(ref)

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 0,
    ) -> Iterator[Any]:
        """Formatted batches over the block stream.

        prefetch_batches=k (k>0) moves block resolution (rt.get) and
        batch formatting onto a background thread holding up to k
        finished batches ahead of the consumer, with the block-ref
        stream itself pulled ahead — the training step never waits on
        the input pipeline once the window fills. k=0 is the exact
        serial path. Both paths run the same batching loop, so
        ordering and drop_last semantics are identical by
        construction.
        """
        ref_pull_ahead = _REF_PULL_AHEAD if prefetch_batches > 0 else 0

        def blocks() -> Iterator[Block]:
            for ref in self.iter_block_refs(prefetch=ref_pull_ahead):
                yield rt.get(ref)

        batches = _batches_from_blocks(
            blocks(), batch_size, batch_format, drop_last
        )
        if prefetch_batches > 0:
            batches = _prefetched(batches, prefetch_batches)
        # Outermost boundary: what's timed is the consumer-visible
        # stall per batch (post-prefetch), accumulated as the
        # data_wait_ms step phase (_private/step_telemetry.py).
        return _telemetry.timed_iter(batches, "data_wait_ms")

    def take(self, n: int = 20) -> List[dict]:
        out: List[dict] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[dict]:
        return list(self.iter_rows())

    def count(self) -> int:
        count_task = rt.remote(num_cpus=1)(lambda block: len(block))
        return sum(
            rt.get(
                [count_task.remote(r) for r in self.iter_block_refs()]
            )
        )

    def schema(self) -> Dict[str, str]:
        for ref in self.iter_block_refs():
            block = rt.get(ref)
            if block:
                return {
                    k: type(v).__name__ for k, v in block[0].items()
                }
        return {}

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return rows_to_batch(self.take_all())

    def to_pandas(self):
        """Materialize into one DataFrame (reference:
        Dataset.to_pandas)."""
        import pandas as pd

        return pd.DataFrame(self.take_all())

    def to_arrow(self):
        """Materialize into one pyarrow Table (reference:
        Dataset.to_arrow_refs, collapsed to a local table)."""
        import pyarrow as pa

        return pa.Table.from_pylist(self.take_all())

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 256,
        drop_last: bool = False,
        device: Optional[str] = None,
        dtypes=None,
        prefetch_batches: int = 0,
    ) -> Iterator[Dict[str, Any]]:
        """Batches as dicts of torch tensors (reference:
        Dataset.iter_torch_batches). Non-numeric columns pass through
        unconverted."""
        import torch

        for batch in self.iter_batches(
            batch_size=batch_size,
            batch_format="numpy",
            drop_last=drop_last,
            prefetch_batches=prefetch_batches,
        ):
            out: Dict[str, Any] = {}
            for key, column in batch.items():
                try:
                    tensor = torch.as_tensor(column)
                except (TypeError, RuntimeError):
                    out[key] = column
                    continue
                if dtypes is not None:
                    want = (
                        dtypes.get(key)
                        if isinstance(dtypes, dict)
                        else dtypes
                    )
                    if want is not None:
                        tensor = tensor.to(want)
                if device is not None:
                    tensor = tensor.to(device)
                out[key] = tensor
            yield out

    def stats(self) -> str:
        refs = self._block_refs()
        return (
            f"Dataset(blocks={len(refs)}, "
            f"stages={[s.name for s in self._stages]})"
        )

    def __repr__(self):
        return f"Dataset(stages={[s.name for s in self._stages]})"

    # -- split ---------------------------------------------------------
    def split(self, n: int) -> List["Dataset"]:
        """Materializing split into n datasets (reference:
        Dataset.split)."""
        refs = self._block_refs()
        outs: List[List[Any]] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            outs[i % n].append(ref)
        datasets = []
        for part in outs:
            ds = Dataset([], self._window)
            ds._materialized = part
            datasets.append(ds)
        return datasets

    def streaming_split(
        self, n: int, *, equal: bool = False
    ) -> List["DataIterator"]:
        """n disjoint iterators backed by a coordinator actor pulling
        the stream on demand (reference: Dataset.streaming_split ->
        OutputSplitter); the iterators are picklable and usable from
        Train workers."""
        coordinator_cls = rt.remote(num_cpus=0)(_SplitCoordinator)
        coordinator = coordinator_cls.remote(
            self._stages, self._window, n, equal, self._inflight_bytes
        )
        return [DataIterator(coordinator, i) for i in range(n)]

    # -- writes --------------------------------------------------------
    def write_csv(self, path: str) -> None:
        _write(self, path, "csv")

    def write_json(self, path: str) -> None:
        _write(self, path, "json")

    def write_parquet(self, path: str) -> None:
        _write(self, path, "parquet")

    def write_tfrecords(self, path: str) -> None:
        _write(self, path, "tfrecords")

    def write_numpy(self, path: str, *, column: str = "data") -> None:
        _write(self, path, "npy", column=column)


class GroupedData:
    """(reference: python/ray/data/grouped_data.py)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _aggregate(
        self, init: Any, update: Callable, finalize: Callable, name: str
    ) -> Dataset:
        key = self._key

        def run(refs):
            n = max(1, len(refs))

            def split(block: Block, parts_n: int) -> List[Block]:
                parts: List[Block] = [[] for _ in range(parts_n)]
                for row in block:
                    parts[hash(row[key]) % parts_n].append(row)
                return parts

            def combine(*parts: Block) -> Block:
                state: Dict[Any, Any] = {}
                for part in parts:
                    for row in part:
                        group = row[key]
                        state[group] = update(
                            state.get(group, init), row
                        )
                return [
                    {key: group, name: finalize(acc)}
                    for group, acc in sorted(state.items())
                ]

            return _shuffle(refs, n, split, combine)

        return self._ds._with(AllToAllStage(run, f"groupby.{name}"))

    def count(self) -> Dataset:
        return self._aggregate(
            0, lambda acc, row: acc + 1, lambda acc: acc, "count"
        )

    def sum(self, col: str) -> Dataset:
        return self._aggregate(
            0,
            lambda acc, row: acc + row[col],
            lambda acc: acc,
            f"sum({col})",
        )

    def mean(self, col: str) -> Dataset:
        return self._aggregate(
            (0, 0),
            lambda acc, row: (acc[0] + row[col], acc[1] + 1),
            lambda acc: acc[0] / acc[1] if acc[1] else 0.0,
            f"mean({col})",
        )

    def max(self, col: str) -> Dataset:
        return self._aggregate(
            None,
            lambda acc, row: row[col]
            if acc is None
            else builtins.max(acc, row[col]),
            lambda acc: acc,
            f"max({col})",
        )

    def min(self, col: str) -> Dataset:
        return self._aggregate(
            None,
            lambda acc, row: row[col]
            if acc is None
            else builtins.min(acc, row[col]),
            lambda acc: acc,
            f"min({col})",
        )


class _SplitCoordinator:
    """Actor pulling the stream once, handing blocks to n consumers.
    equal=True enforces strict round-robin; otherwise first-come-first-
    served (reference: output_splitter.py)."""

    def __init__(self, stages, window, n, equal, inflight_bytes=None):
        self._iter = execute_streaming(stages, window, inflight_bytes)
        self._n = n
        self._equal = equal
        self._queues: List[List[Block]] = [[] for _ in range(n)]
        self._rr = 0
        self._exhausted = False

    def next_block(self, idx: int):
        import ray_tpu_torch as rt_inner

        if self._queues[idx]:
            return self._queues[idx].pop(0)
        while not self._exhausted:
            try:
                ref = next(self._iter)
            except StopIteration:
                self._exhausted = True
                break
            block = rt_inner.get(ref)
            if self._equal:
                target = self._rr
                self._rr = (self._rr + 1) % self._n
                if target == idx:
                    return block
                self._queues[target].append(block)
            else:
                return block
        if self._queues[idx]:
            return self._queues[idx].pop(0)
        return None


class DataIterator:
    """Per-consumer view of a streaming split (reference:
    python/ray/data/iterator.py DataIterator)."""

    def __init__(self, coordinator, index: int):
        self._coordinator = coordinator
        self._index = index

    def iter_blocks(self) -> Iterator[Block]:
        while True:
            block = rt.get(
                self._coordinator.next_block.remote(self._index)
            )
            if block is None:
                return
            yield block

    def iter_rows(self) -> Iterator[dict]:
        for block in self.iter_blocks():
            yield from block

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 0,
    ) -> Iterator[Any]:
        """Same prefetch contract as Dataset.iter_batches: k>0 pulls
        coordinator blocks and formats batches on a background thread,
        k=0 is the serial path; identical ordering either way."""
        batches = _batches_from_blocks(
            self.iter_blocks(), batch_size, batch_format, drop_last
        )
        if prefetch_batches > 0:
            batches = _prefetched(batches, prefetch_batches)
        return _telemetry.timed_iter(batches, "data_wait_ms")

    def __reduce__(self):
        return (DataIterator, (self._coordinator, self._index))


# -- shuffle machinery -------------------------------------------------
def _concat(*parts: Block) -> Block:
    return [row for part in parts for row in part]


def _shuffle(
    refs: List[Any],
    n: int,
    split_fn: Callable[[Block, int], List[Block]],
    combine_fn: Callable[..., Block],
) -> List[Any]:
    """Two-round exchange (reference: _internal/planner/exchange/):
    every input block splits into n parts; the i-th output block
    combines the i-th part of every input."""
    if not refs:
        return []
    split_task = rt.remote(num_cpus=1, num_returns=n)(
        lambda block: tuple(split_fn(block, n))
        if n > 1
        else split_fn(block, n)[0]
    )
    parts = [split_task.remote(ref) for ref in refs]
    if n == 1:
        parts = [[p] for p in parts]
    combine_task = rt.remote(num_cpus=1)(combine_fn)
    return [
        combine_task.remote(*[parts[j][i] for j in range(len(refs))])
        for i in range(n)
    ]


def _write(ds: Dataset, path: str, fmt: str, **opts) -> None:
    import os

    os.makedirs(path, exist_ok=True)

    def write_block(block: Block, index: int) -> str:
        file_path = os.path.join(path, f"part-{index:05d}.{fmt}")
        if fmt == "csv":
            import csv

            with open(file_path, "w", newline="") as f:
                if block:
                    writer = csv.DictWriter(
                        f, fieldnames=list(block[0].keys())
                    )
                    writer.writeheader()
                    writer.writerows(block)
        elif fmt == "json":
            import json

            with open(file_path, "w") as f:
                for row in block:
                    f.write(json.dumps(row) + "\n")
        elif fmt == "parquet":
            import pyarrow as pa
            import pyarrow.parquet as pq

            table = pa.Table.from_pylist(block)
            pq.write_table(table, file_path)
        elif fmt == "tfrecords":
            from .tfrecords import encode_example, write_records

            write_records(
                file_path,
                (encode_example(row) for row in block),
            )
        elif fmt == "npy":
            column = opts.get("column", "data")
            np.save(
                file_path,
                np.asarray([row[column] for row in block]),
            )
        return file_path

    write_task = rt.remote(num_cpus=1)(write_block)
    refs = [
        write_task.remote(ref, i)
        for i, ref in enumerate(ds.iter_block_refs())
    ]
    rt.get(refs)
