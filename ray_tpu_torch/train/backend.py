"""Training backends: per-gang setup hooks (PyTorch port of
`ray_tpu/train/backend.py`).

The JAX package's backend runs `jax.distributed.initialize` on every
worker of the gang. The port's rendezvous is `torch.distributed`'s:
`init_torch_distributed` joins one process group, NCCL on CUDA (one
card per rank) and gloo on the CPU, with rank 0 hosting the TCP store.
`run_local_gang` starts such a gang of local processes, which is how
the CPU tests and `graft_entry.dryrun_multichip` run a mesh here.
Running the rendezvous across a `WorkerGroup` (`TorchBackend.on_start`)
waits for the copied actor runtime.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence


class Backend:
    def on_start(self, worker_group, backend_config: dict) -> None:
        """Called after the worker gang is up, before the train loop."""

    def on_shutdown(self, worker_group) -> None:
        """Called when training finishes."""


class TorchBackend(Backend):
    """Joins the gang's workers into one `torch.distributed` process
    group (replaces `JaxBackend`'s `jax.distributed.initialize`): each
    worker calls `init_torch_distributed(rank, size, address)` with
    rank 0's address."""

    def on_start(self, worker_group, backend_config: dict) -> None:
        raise NotImplementedError(
            "TorchBackend.on_start over a WorkerGroup waits for the copied "
            "actor runtime (ROADMAP queue 1, trainer gang); run_local_gang "
            "starts a local gang meanwhile")


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_torch_distributed(rank: int, world_size: int, address: str, *,
                           device="cuda") -> None:
    """Join the process group at `address` ("host:port", rank 0's TCP
    store) as `rank` of `world_size`: NCCL for a CUDA device, the card
    being `rank` modulo the cards this host has; gloo for the CPU."""
    import torch
    import torch.distributed as dist

    if torch.device(device).type == "cuda":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw = {"backend": "nccl", "device_id": card}
    else:
        kw = {"backend": "gloo"}
    dist.init_process_group(init_method=f"tcp://{address}", rank=rank,
                            world_size=world_size, **kw)


def _gang_member(fn, rank, world_size, address, device, args, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        init_torch_distributed(rank, world_size, address, device=device)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def run_local_gang(fn: Callable[..., Any], world_size: int,
                   args: Sequence[Any] = (), *, device="cuda",
                   timeout: float = 120.0) -> List[Any]:
    """Run `fn(rank, *args)` in `world_size` fresh processes joined into
    one process group on localhost (`init_torch_distributed`): NCCL, one
    card per rank, unless `device="cpu"` (gloo). Return their results by
    rank. `fn` must be importable by name.
    A rank that raises fails the gang with its traceback; a gang still
    running after `timeout` seconds is killed and fails: every process
    is joined or killed before this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    address = f"localhost:{free_port()}"
    procs = [
        ctx.Process(target=_gang_member,
                    args=(fn, r, world_size, address, device, tuple(args),
                          results),
                    daemon=True)
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"local gang of {world_size} still running after "
                    f"{timeout} s (done: ranks {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)  # a last message may be in flight
                    if results.empty():
                        raise RuntimeError(
                            f"local gang: a rank exited with {dead[0]} "
                            "before reporting")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
        if errors:
            raise RuntimeError("local gang failed: " + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world_size)]
