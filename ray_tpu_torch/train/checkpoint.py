"""Checkpoint save/restore with keep-last-k retention and async
persistence (PyTorch port of `ray_tpu/train/checkpoint.py`).

A state is a state dict: nested dicts of tensors (DTensors included)
and Python values, such as `TrainState.state_dict()`. It is written
with `torch.distributed.checkpoint` (DCP) under `<path>/state`, each
rank writing its own shards; `restore_checkpoint` reads it back into
the tensors of a target state dict, in place, whatever their sharding.

Async persistence keeps the JAX package's contracts:
``save_checkpoint(..., async_save=True)`` copies the state to host
memory before it returns (a blocking device-to-host snapshot: the next
step may update the parameters in place the moment it returns) and
hands the write to one background writer thread, so step N+1 runs
while save N persists. ``wait_for_checkpoints()`` is the durability
barrier and re-raises a write's error; the trainer calls it at fit
exit, and restore and retention call it before trusting a directory.
``metadata.json`` is written last, after every rank's shards, so its
presence marks a complete checkpoint.

In a process group, DCP's own collectives (the plan exchange and the
final barrier) run on a gloo group made for checkpoints alone, never
on the training group: the writer thread issues no collective that a
train step could interleave with.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

from .._private import step_telemetry

# -- async writer machinery --------------------------------------------------

_PENDING_LOCK = threading.Lock()
#: path -> futures of the in-flight background writes for that path
#: (same-path re-saves append; the single writer runs them in order).
_PENDING: Dict[str, List[Future]] = {}
_EXECUTOR: Optional[ThreadPoolExecutor] = None
#: (the world's group, the checkpoints' gloo group over the same ranks).
_GROUP: Optional[Tuple[Any, Any]] = None


def _writer() -> ThreadPoolExecutor:
    """One writer thread: saves persist in submission order, and at
    most one disk commit competes with training for host resources."""
    global _EXECUTOR
    with _PENDING_LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rtt-ckpt-writer"
            )
        return _EXECUTOR


def _checkpoint_group():
    """DCP's group: None outside a process group, else a gloo group over
    the world made once per world. Making it is a collective, so the
    first save (or restore) must come on every rank's main thread."""
    global _GROUP
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.group.WORLD
    if _GROUP is None or _GROUP[0] is not world:
        _GROUP = (world, dist.new_group(backend="gloo"))
    return _GROUP[1]


def _host_snapshot(state: Dict[str, Any]) -> Dict[str, Any]:
    """Blocking device-to-host copy of a state dict (a DTensor keeps its
    placements around a host copy of its local shard). It must finish
    before the caller's next train step, which updates the parameters
    in place."""
    from torch.distributed.checkpoint.staging import BlockingAsyncStager

    return BlockingAsyncStager().stage(state)


def _write_payload(path: str, state: Dict[str, Any],
                   metadata: Optional[dict]) -> None:
    """Persist one checkpoint directory. metadata.json lands LAST, on
    the group's first rank, after DCP's closing barrier."""
    import torch.distributed.checkpoint as dcp

    group = _checkpoint_group()
    dcp.save(state, checkpoint_id=os.path.join(path, "state"),
             process_group=group, no_dist=group is None)
    if metadata is not None and (group is None or dist.get_rank(group) == 0):
        tmp = os.path.join(path, "metadata.json.tmp")
        with open(tmp, "w") as f:
            json.dump(metadata, f)
        os.replace(tmp, os.path.join(path, "metadata.json"))


def save_checkpoint(
    path: str,
    state: Dict[str, Any],
    metadata: Optional[dict] = None,
    *,
    async_save: bool = False,
) -> str:
    """Save a state dict; in a process group every rank calls this
    with its own shards, in the same order.

    async_save=True returns as soon as the state is snapshotted to
    host memory; the disk write runs on a background writer thread.
    Call :func:`wait_for_checkpoints` (the trainer does at fit-exit)
    before treating the directory as durable.
    """
    path = os.path.abspath(path)
    # The step-blocking portion of a save (full write when sync, the
    # device->host snapshot when async) is a train-loop phase the step
    # telemetry attributes per step.
    t0 = time.monotonic()
    _checkpoint_group()  # made on this thread, before the writer needs it
    if not async_save:
        _write_payload(path, state, metadata)
        step_telemetry.add_phase(
            "ckpt_block_ms", (time.monotonic() - t0) * 1e3
        )
        return path
    snapshot = _host_snapshot(state)
    executor = _writer()
    with _PENDING_LOCK:
        # Submit under the lock: registration is atomic with the
        # submit, so a concurrent barrier can never miss an in-flight
        # write.
        future = executor.submit(_write_payload, path, snapshot, metadata)
        _PENDING.setdefault(path, []).append(future)
    step_telemetry.add_phase(
        "ckpt_block_ms", (time.monotonic() - t0) * 1e3
    )
    return path


def _wait_futures(path: str, futures: List[Future]) -> None:
    """Wait for the given writes; deregister them; re-raise the first
    error. Deregistration happens only AFTER the result — a concurrent
    barrier that snapshots _PENDING mid-wait still sees (and waits on)
    the in-flight write."""
    first_error: Optional[BaseException] = None
    for future in futures:
        try:
            future.result()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            if first_error is None:
                first_error = e
    with _PENDING_LOCK:
        remaining = _PENDING.get(path)
        if remaining is not None:
            remaining[:] = [f for f in remaining if f not in futures]
            if not remaining:
                del _PENDING[path]
    if first_error is not None:
        raise first_error


def wait_for_checkpoints(path: Optional[str] = None) -> None:
    """Durability barrier for async saves. With a path, waits only for
    that checkpoint; otherwise drains every pending save. Re-raises
    the first write error — a failed persist must surface at the
    barrier, not vanish into a daemon thread."""
    if path is not None:
        path = os.path.abspath(path)
        with _PENDING_LOCK:
            futures = list(_PENDING.get(path, ()))
        if futures:
            _wait_futures(path, futures)
        return
    first_error: Optional[BaseException] = None
    while True:
        with _PENDING_LOCK:
            items = [(p, list(fs)) for p, fs in _PENDING.items()]
        if not items:
            break
        for pending_path, futures in items:
            try:
                _wait_futures(pending_path, futures)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_error is None:
                    first_error = e
    if first_error is not None:
        raise first_error


def pending_checkpoints() -> List[str]:
    """Paths with an in-flight background write (newest last)."""
    with _PENDING_LOCK:
        return list(_PENDING)


def restore_checkpoint(path: str, target: Dict[str, Any]) -> Dict[str, Any]:
    """Restore into `target`, a state dict of the saved structure: its
    tensors are overwritten in place (each rank reads the shards its
    own DTensors hold) and its Python values replaced; returns it.
    Waits for any in-flight save of `path` first, so an async save
    followed by an immediate restore reads full data."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    wait_for_checkpoints(path)
    group = _checkpoint_group()
    dcp.load(target, checkpoint_id=os.path.join(path, "state"),
             process_group=group, no_dist=group is None)
    return target


def load_metadata(path: str) -> dict:
    wait_for_checkpoints(path)
    meta_path = os.path.join(path, "metadata.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


class CheckpointManager:
    """Keep-last-k checkpoint retention."""

    def __init__(self, root: str, num_to_keep: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.num_to_keep = num_to_keep
        os.makedirs(self.root, exist_ok=True)
        self._checkpoints: List[Tuple[int, str]] = []

    def save(
        self,
        step: int,
        state: Dict[str, Any],
        metrics: Optional[dict] = None,
        *,
        async_save: bool = False,
    ):
        path = os.path.join(self.root, f"checkpoint_{step:08d}")
        save_checkpoint(
            path,
            state,
            {"step": step, **(metrics or {})},
            async_save=async_save,
        )
        self._checkpoints.append((step, path))
        if self.num_to_keep is not None:
            while len(self._checkpoints) > self.num_to_keep:
                _, old = self._checkpoints.pop(0)
                # Never delete a directory whose write is still in
                # flight — the writer would resurrect a half-deleted
                # tree and "retained" checkpoints could be corrupt.
                wait_for_checkpoints(old)
                shutil.rmtree(old, ignore_errors=True)
        return path

    def wait(self) -> None:
        """Block until every save issued through this manager (and any
        other async save in the process) is durable."""
        wait_for_checkpoints()

    def latest(self) -> Optional[str]:
        wait_for_checkpoints()
        existing = sorted(
            d
            for d in os.listdir(self.root)
            if d.startswith("checkpoint_")
        )
        if not existing:
            return None
        return os.path.join(self.root, existing[-1])
