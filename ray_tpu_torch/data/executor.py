# Copied from ray_tpu/data/executor.py (JAX-free).
"""Streaming execution of Dataset plans.

Reference: python/ray/data/_internal/execution/streaming_executor.py:48
— a pull-based loop moves blocks through operator stages with bounded
in-flight work. Two backpressure dimensions, matching the reference's
backpressure_policy/ package:

- task-count cap per stage (ConcurrencyCapBackpressurePolicy): at most
  `window` tasks in flight;
- in-flight BYTES budget (the resource-based output backpressure):
  completed-but-unconsumed block bytes per stage are bounded by
  `inflight_bytes`, so a skewed stage whose blocks balloon (flat_map
  fan-out) throttles submission instead of flooding the object store.
  Sizes come from the store's sealed-object metadata; inline (small)
  results are counted by their actual payload bytes.

Stages: ReadStage / MapStage run one task per block; ActorPoolStage
(reference: operators/actor_pool_map_operator.py) runs blocks on an
autoscaling pool of warm actors — the compute model for UDFs with
expensive setup (a loaded model); AllToAllStage is a materializing
barrier; LimitStage truncates.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Iterator, List, Optional

import ray_tpu_torch as rt

#: Default per-stage in-flight bytes budget. Deliberately a fraction of
#: the default object store so two busy stages + consumer still fit.
DEFAULT_INFLIGHT_BYTES = int(
    os.environ.get("RT_DATA_INFLIGHT_BYTES", str(256 * 1024 * 1024))
)

# One remote hop applies a serialized block transform; num_cpus=1 is
# the reference's default per-map-task resource.
_map_task = None


def _get_map_task():
    global _map_task
    if _map_task is None:

        def apply_block_fn(fn, *blocks):
            return fn(*blocks)

        _map_task = rt.remote(num_cpus=1)(apply_block_fn)
    return _map_task


class Stage:
    name: str = "stage"


class ReadStage(Stage):
    """Source: a list of argless callables, each producing one block."""

    def __init__(self, tasks: List[Callable[[], Any]], name="read"):
        self.tasks = tasks
        self.name = name


class MapStage(Stage):
    """block -> block transform, one remote task per block."""

    def __init__(self, fn: Callable, name="map"):
        self.fn = fn
        self.name = name


class ActorPoolStage(Stage):
    """block -> block transform on a pool of warm actors (reference:
    actor_pool_map_operator.py + ActorPoolStrategy). `udf` may be a
    callable CLASS — each pool actor instantiates it once (model load,
    connection setup) and reuses it for every block."""

    def __init__(
        self,
        udf: Any,
        make_apply: Callable,
        *,
        ctor_args: tuple = (),
        min_size: int = 1,
        max_size: int = 4,
        max_tasks_per_actor: int = 2,
        num_cpus: float = 1.0,
        name="map(actors)",
    ):
        self.udf = udf
        self.make_apply = make_apply
        self.ctor_args = ctor_args
        self.min_size = max(1, min_size)
        self.max_size = max(self.min_size, max_size)
        self.max_tasks_per_actor = max(1, max_tasks_per_actor)
        self.num_cpus = num_cpus
        self.name = name


class AllToAllStage(Stage):
    """Barrier: fn(list_of_refs) -> list_of_refs (it may submit its own
    remote tasks, e.g. shuffle partition/combine rounds)."""

    def __init__(self, fn: Callable[[List[Any]], List[Any]], name="a2a"):
        self.fn = fn
        self.name = name


class LimitStage(Stage):
    def __init__(self, n: int):
        self.n = n
        self.name = f"limit({n})"


def execute_streaming(
    stages: List[Stage],
    window: int = 8,
    inflight_bytes: Optional[int] = None,
) -> Iterator[Any]:
    """Yield output block refs, submitting work stage-by-stage with
    bounded per-stage in-flight tasks AND bytes."""
    budget = (
        inflight_bytes if inflight_bytes else DEFAULT_INFLIGHT_BYTES
    )

    def _map_pairs(fn, upstream):
        # A dedicated scope: a bare genexp here would close over the
        # LOOP variable and apply the last stage's fn to every stage.
        return ((fn, ref) for ref in upstream)

    gen: Iterator[Any] = iter(())
    for stage in stages:
        if isinstance(stage, ReadStage):
            gen = _task_gen(
                (
                    (read_fn,)
                    for read_fn in stage.tasks
                ),
                window,
                budget,
            )
        elif isinstance(stage, MapStage):
            gen = _task_gen(
                _map_pairs(stage.fn, gen), window, budget
            )
        elif isinstance(stage, ActorPoolStage):
            gen = _actor_pool_gen(gen, stage, window, budget)
        elif isinstance(stage, AllToAllStage):
            gen = iter(stage.fn(list(gen)))
        elif isinstance(stage, LimitStage):
            gen = _limit_gen(gen, stage.n)
        else:
            raise TypeError(f"unknown stage {stage!r}")
    return gen


class _ByteLedger:
    """Tracks in-flight output bytes for one stage.

    A submitted task's output is unknown until it completes; completed
    blocks report their sealed size (or inline payload bytes). The
    estimate for still-running tasks is the running average of observed
    block sizes, so a stage that starts producing huge blocks throttles
    within one window (reference: resource-based backpressure sizes
    operator outputs from block metadata the same way)."""

    _INLINE_FALLBACK = 32 * 1024

    def __init__(self):
        self._known: dict = {}  # id bytes -> size
        self._avg: float = float(self._INLINE_FALLBACK)
        self.observed = 0

    def _probe(self, ref) -> int:
        from .._private.worker import global_worker

        worker = global_worker()
        oid = ref.id()
        # Inline (direct-transport) results never touch the store;
        # their exact payload bytes live on the submitter-side future.
        direct = getattr(worker, "_direct", None)
        if direct is not None:
            entry = direct.lookup(oid)
            fut = entry[0] if isinstance(entry, tuple) else entry
            if (
                fut is not None
                and fut.done()
                and not fut.daemon_fallback
                and fut.results
            ):
                total = 0
                for kind, payload in fut.results:
                    if kind == "shm":
                        # Sealed-to-store result: payload is its size.
                        total += int(payload)
                    elif payload is not None:
                        total += len(payload)
                return total or self._INLINE_FALLBACK
        try:
            meta = worker.call("get_object_meta", oid=oid.binary())
            size = meta.get("size")
            return int(size) if size else self._INLINE_FALLBACK
        except Exception:
            return self._INLINE_FALLBACK

    def account(self, pending: List[Any]) -> float:
        """Estimated bytes held by `pending` (submitted, not yet
        yielded downstream)."""
        if not pending:
            return 0.0
        ready, _ = rt.wait(
            list(pending), num_returns=len(pending), timeout=0
        )
        for ref in ready:
            key = ref.id().binary()
            if key not in self._known:
                size = self._probe(ref)
                self._known[key] = size
                self.observed += 1
                self._avg += (size - self._avg) / self.observed
        total = 0.0
        ready_keys = {r.id().binary() for r in ready}
        for ref in pending:
            key = ref.id().binary()
            if key in ready_keys:
                total += self._known.get(key, self._avg)
            else:
                total += self._avg
        return total

    def forget(self, ref) -> None:
        self._known.pop(ref.id().binary(), None)


def _task_gen(
    submissions: Iterator[tuple], window: int, budget: int
) -> Iterator[Any]:
    """Common bounded-submission loop for read and map stages: submit
    while under both the task window and the byte budget, otherwise
    hand the oldest block downstream (the pull that frees budget)."""
    task = _get_map_task()
    ledger = _ByteLedger()
    pending: List[Any] = []
    for args in submissions:
        pending.append(task.remote(*args))
        while True:
            est = ledger.account(pending)  # also records sizes
            if not (
                len(pending) >= window
                # Cold-start calibration: until one real output size
                # is observed, the running-average estimate is a tiny
                # prior that would let a whole window of (possibly
                # huge) blocks through — hold at 2 in flight until the
                # first block reports its size.
                or (ledger.observed == 0 and len(pending) >= 2)
                or (len(pending) > 1 and est >= budget)
            ):
                break
            ref = pending.pop(0)
            ledger.forget(ref)
            yield ref
    while pending:
        ref = pending.pop(0)
        ledger.forget(ref)
        yield ref


class _PoolWorker:
    """One warm actor of an ActorPoolStage. The UDF class is
    instantiated HERE, once, so per-actor state (a loaded model)
    amortizes across every block this actor maps (reference:
    actor_pool_map_operator.py _MapWorker)."""

    def __init__(self, udf, make_apply, ctor_args=()):
        instance = udf(*ctor_args) if isinstance(udf, type) else udf
        self._apply = make_apply(instance)

    def apply(self, block):
        return self._apply(block)

    def ping(self):
        return "ok"


def _actor_pool_gen(
    upstream: Iterator[Any],
    stage: ActorPoolStage,
    window: int,
    budget: int,
) -> Iterator[Any]:
    """Autoscaling actor-pool map: blocks dispatch to the least-loaded
    live actor; when every actor is saturated (max_tasks_per_actor)
    and the pool is under max_size, a new actor spins up (reference:
    _ActorPool.scale_up on queued work). Actors are killed when the
    stage drains — including on early downstream termination (limit)."""
    worker_cls = rt.remote(num_cpus=stage.num_cpus)(_PoolWorker)
    ledger = _ByteLedger()
    pool: List[Any] = []
    load: dict = {}  # actor index -> in-flight count
    pending: List[tuple] = []  # (out_ref, actor_idx)

    def spawn():
        actor = worker_cls.remote(
            stage.udf, stage.make_apply, stage.ctor_args
        )
        pool.append(actor)
        load[len(pool) - 1] = 0
        return len(pool) - 1

    try:
        for _ in range(stage.min_size):
            spawn()
        for in_ref in upstream:
            # Pick the least-loaded actor; scale up if all saturated.
            idx = min(range(len(pool)), key=lambda i: load[i])
            if (
                load[idx] >= stage.max_tasks_per_actor
                and len(pool) < stage.max_size
            ):
                idx = spawn()
            out = pool[idx].apply.remote(in_ref)
            load[idx] += 1
            pending.append((out, idx))
            while len(pending) >= window or (
                len(pending) > 1
                and ledger.account([r for r, _ in pending]) >= budget
            ):
                ref, ref_idx = pending.pop(0)
                # Block completion is what frees the actor slot; the
                # oldest submission is (FIFO per actor) the first done.
                rt.wait([ref], num_returns=1)
                load[ref_idx] = max(0, load[ref_idx] - 1)
                ledger.forget(ref)
                yield ref
        while pending:
            ref, ref_idx = pending.pop(0)
            rt.wait([ref], num_returns=1)
            load[ref_idx] = max(0, load[ref_idx] - 1)
            ledger.forget(ref)
            yield ref
    finally:
        # Drain before teardown so in-flight results seal, then
        # release the workers (pool actors are stage-scoped).
        for ref, _ in pending:
            try:
                rt.wait([ref], num_returns=1, timeout=30)
            except Exception:
                pass
        for actor in pool:
            try:
                rt.kill(actor)
            except Exception:
                pass


def _limit_gen(upstream: Iterator[Any], n: int) -> Iterator[Any]:
    remaining = n
    for ref in upstream:
        if remaining <= 0:
            return
        block = rt.get(ref)
        if len(block) >= remaining:
            yield rt.put(block[:remaining])
            return
        remaining -= len(block)
        yield ref
