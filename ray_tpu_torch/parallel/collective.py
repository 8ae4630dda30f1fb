"""Explicit collectives over one dimension of a device mesh (PyTorch port
of `ray_tpu/parallel/collective.py`).

The JAX package's collectives are traced primitives inside `shard_map`,
named by a mesh axis. The port's run eagerly on a process group: the
group of one named dimension of a `DeviceMesh` (`mesh.get_group("sp")`),
or None for the whole world. Every rank of the group must call them in
the same order.

They are differentiable where JAX differentiates through them
(`torch.distributed`'s own ops are not). The convention is the one the
port's sharded steps keep: every rank seeds the backward of its own
objective, and the ranks' objectives add up to the loss. Under it the
backward of a collective is JAX's transpose:

- `allreduce` sum: the gradients summed over the group; mean: divided
  by its size; prod: through a gather (a reduce-scatter of the
  gradients); max and min have no gradient, as `lax.pmax`/`lax.pmin`
  have none;
- `allgather` <-> `reducescatter` (sum);
- `broadcast`: the root gets the group's summed gradient, the others 0;
- `send_recv` (a ring shift): the reverse shift;
- `all_to_all`: the all_to_all with the split and concat dims swapped.

`pcast_varying` has no counterpart: it marks a value as varying over a
mesh axis for JAX's type checker, and a torch tensor carries no such
type.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed import ProcessGroup

Group = Optional[ProcessGroup]

_REDUCE_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def axis_index(group: Group) -> int:
    """This rank's position in the group."""
    return dist.get_rank(group)


def axis_size(group: Group) -> int:
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group: Group, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    n = axis_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    # all_reduce then slice: gloo has no reduce_scatter.
    return _all_reduce(x, group).chunk(n, dim=dim)[axis_index(group)].clone()


def global_rank(group: Group, rank: int) -> int:
    """The process group's global rank of the group's `rank`."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _shift(x: torch.Tensor, group: Group, shift: int) -> torch.Tensor:
    n = axis_size(group)
    if shift % n == 0:
        return x.clone()
    me = axis_index(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_to_all(x: torch.Tensor, group: Group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = axis_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduceNoGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        ctx.op = op
        return _all_reduce(x, group, _REDUCE_OPS[op])

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            f"allreduce {ctx.op!r} has no gradient (nor has JAX's "
            f"lax.p{ctx.op})")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.group, concat_dim, split_dim), None, None, None


def allreduce(x: torch.Tensor, group: Group = None, op: str = "sum"):
    """Reduce across the group; every member gets the result."""
    if op == "sum":
        return _AllReduceSum.apply(x, group)
    if op == "mean":
        return _AllReduceSum.apply(x, group) / axis_size(group)
    if op in ("max", "min"):
        return _AllReduceNoGrad.apply(x, group, op)
    if op == "prod":
        # Gather-then-multiply handles zeros and negatives exactly.
        return torch.prod(allgather(x.unsqueeze(0), group), dim=0)
    raise ValueError(f"unsupported reduce op: {op}")


def allgather(x: torch.Tensor, group: Group = None, *, concat_axis: int = 0):
    """Every member's shard, concatenated along `concat_axis` in rank
    order (JAX's tiled all_gather)."""
    return _AllGather.apply(x, group, concat_axis)


def reducescatter(x: torch.Tensor, group: Group = None, *,
                  scatter_axis: int = 0, op: str = "sum"):
    """Reduce, then keep this rank's block of `scatter_axis`."""
    if op not in ("sum", "mean"):
        raise ValueError(f"unsupported reducescatter op: {op}")
    out = _ReduceScatter.apply(x, group, scatter_axis)
    return out / axis_size(group) if op == "mean" else out


def broadcast(x: torch.Tensor, group: Group = None, root: int = 0):
    """Every member receives root's value: a sum over the group in which
    the other members put zeros (not their values times 0, which would
    carry their NaN/Inf), as in the JAX package."""
    is_root = torch.tensor(axis_index(group) == root, device=x.device)
    return allreduce(torch.where(is_root, x, torch.zeros_like(x)), group)


def send_recv(x: torch.Tensor, group: Group = None, *, shift: int = 1):
    """Ring shift: each member sends its value `shift` steps forward and
    receives the value of the member `shift` steps back."""
    return _Shift.apply(x, group, shift)


def barrier(group: Group = None) -> None:
    dist.barrier(group=group)


def all_to_all(x: torch.Tensor, group: Group = None, *, split_axis: int,
               concat_axis: int):
    """Split `split_axis` into one block per member, send block j to
    member j, and concatenate the blocks received along `concat_axis`
    in rank order (JAX's tiled all_to_all): the Ulysses reshard."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def all_reduce_(tensors: List[torch.Tensor], group: Group) -> None:
    """Sum each tensor over the group in place, in one collective (no
    gradient: for gradients and metrics already computed)."""
    if not tensors or axis_size(group) == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
