"""Training backends: per-gang setup hooks (PyTorch port of
`ray_tpu/train/backend.py`).

The JAX package's backend runs `jax.distributed.initialize` on every
worker of the gang. The port's rendezvous is `torch.distributed`'s:
`init_torch_distributed` joins one process group, NCCL on CUDA (one
card per rank) and gloo on the CPU, with rank 0 hosting the TCP store.
`run_local_gang` starts such a gang of local processes, which is how
the CPU tests and `graft_entry.dryrun_multichip` run a mesh here;
`TorchBackend.on_start` runs the same rendezvous across a `WorkerGroup`
of the port's runtime actors, as `TorchTrainer(num_workers > 1)` does.
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


#: Seconds `TorchBackend.on_shutdown` waits for the ranks to leave.
LEAVE_TIMEOUT_S = 60.0


class TorchBackend(Backend):
    """Joins the gang's workers into one `torch.distributed` process
    group (replaces `JaxBackend`'s `jax.distributed.initialize`): rank 0
    picks its address and a free port, and every worker calls
    `init_torch_distributed(rank, size, address, device=...)` with it,
    all at once. `backend_config["device"]`: "cuda" (the default; NCCL,
    rank r on the worker's card r modulo its cards) or "cpu" (gloo).
    `on_shutdown` destroys each worker's group."""

    def on_start(self, worker_group, backend_config: dict) -> None:
        device = backend_config.get("device", "cuda")
        hosts = worker_group.run_all(_host_and_port)
        host, port = hosts[0]
        # One host: the loopback. Across hosts, rank 0's name.
        if all(h == host for h, _ in hosts):
            host = "localhost"
        address = f"{host}:{port}"
        worker_group.run_per_rank(
            _join_group,
            lambda rank: (rank, worker_group.size, address, device))

    def on_shutdown(self, worker_group) -> None:
        """Destroy each worker's group. A rank still blocked in a
        collective (its loop failed on another rank) never takes the
        call: after LEAVE_TIMEOUT_S the gang's shutdown kills it."""
        from .. import api as rt

        refs = [w.run.remote(_leave_group) for w in worker_group.workers]
        try:
            rt.get(refs, timeout=LEAVE_TIMEOUT_S)
        except Exception:  # noqa: BLE001 -- the actors are killed next
            pass


def _host_and_port():
    return socket.gethostname(), free_port()


def _join_group(rank, world_size, address, device):
    init_torch_distributed(rank, world_size, address, device=device)


def _leave_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


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


def _gang_member(fn, rank, world_size, address, device, inbox, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        args = inbox.get()
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
    # The arguments go by queue, not with the process: a process's start
    # blocks until the child has read what it was given, which takes the
    # child's imports once that passes a pipe's buffer.
    inbox = ctx.Queue()
    address = f"localhost:{free_port()}"
    procs = [
        ctx.Process(target=_gang_member,
                    args=(fn, r, world_size, address, device, inbox,
                          results),
                    daemon=True)
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put(tuple(args))
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
                p.join()  # rt: noqa[RT008] — joins a process just sent SIGKILL
        results.close()
        inbox.close()
        inbox.cancel_join_thread()
    return [out[r] for r in range(world_size)]
