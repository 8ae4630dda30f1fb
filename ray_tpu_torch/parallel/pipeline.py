"""Pipeline parallelism over a `pp` process group (PyTorch port of
`ray_tpu/parallel/pipeline.py`).

The JAX package runs the GPipe schedule inside one SPMD program: every
rank computes every tick, bubble ticks are masked, and activations hop
stages by `ppermute`. The port runs the same schedule eagerly and skips
the bubbles: stage r takes microbatch i from stage r - 1 (stage 0 from
the input), runs its stage, and sends the result to stage r + 1; the
last stage banks it. The backward is driven explicitly, microbatch by
microbatch in reverse order, each stage receiving the gradient of its
output from the next stage and sending that of its input to the one
before. Autograd's own order across microbatches is not the same on
every rank, and NCCL matches point-to-point transfers in the order they
are issued, so the schedule decides it here. Every rank of a stage's
`sp`/`ep` groups takes the microbatches in the same order, so the
collectives inside a stage match too.

Gradients follow the port's convention (`collective.py`): every rank
seeds the backward of its own objective.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist
from torch import nn

from .collective import Group, allreduce, axis_index, axis_size, global_rank
from .sharding import tree_map


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in `_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _neighbours(group: Group, rank: int, n: int):
    """Global ranks of the stages before and after this one (None at the
    ends)."""
    return (global_rank(group, rank - 1) if rank > 0 else None,
            global_rank(group, rank + 1) if rank < n - 1 else None)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, microbatches, *leaves):
        stage_fn, tree, group, stacked, with_aux = run
        n, rank = axis_size(group), axis_index(group)
        prev, nxt = _neighbours(group, rank, n)
        outputs = torch.zeros_like(microbatches)
        aux_total = torch.zeros((), dtype=torch.float32,
                                device=microbatches.device)
        records = []
        with torch.enable_grad():
            params = tree if isinstance(tree, nn.Module) else _rebuild(
                tree, [x[rank] for x in leaves] if stacked else leaves)
            for i in range(microbatches.shape[0]):
                if rank == 0:
                    x = microbatches[i].detach()
                else:
                    x = torch.empty_like(microbatches[i])
                    dist.recv(x, prev, group=group)
                x.requires_grad_(rank > 0 or microbatches.requires_grad)
                y = stage_fn(params, x)
                y, aux = y if with_aux else (y, None)
                if rank < n - 1:
                    dist.send(y.detach().contiguous(), nxt, group=group)
                else:
                    outputs[i] = y.detach()
                if aux is not None:
                    aux_total += aux.detach().float()
                records.append((x, y, aux))
        ctx.run, ctx.records = run, records
        ctx.save_for_backward(*leaves)
        return outputs, aux_total

    @staticmethod
    def backward(ctx, g_outputs, g_aux):
        _, _, group, _, _ = ctx.run
        n, rank = axis_size(group), axis_index(group)
        prev, nxt = _neighbours(group, rank, n)
        leaves = ctx.saved_tensors
        wanted = [x for x in leaves if x.requires_grad]
        g_micro = torch.zeros_like(g_outputs)
        for i in reversed(range(len(ctx.records))):
            x, y, aux = ctx.records[i]
            if rank == n - 1:
                gy = g_outputs[i]
            else:
                gy = torch.empty_like(y)
                dist.recv(gy, nxt, group=group)
            roots, seeds = [y], [gy]
            if aux is not None and aux.requires_grad:
                roots.append(aux)
                seeds.append(g_aux.to(aux.dtype).expand_as(aux))
            # The stage's parameters take their gradients in `.grad`,
            # microbatch after microbatch, as a reentrant checkpoint's do.
            torch.autograd.backward(
                roots, seeds, inputs=([x] if x.requires_grad else []) + wanted)
            if x.requires_grad:
                if rank > 0:
                    dist.send(x.grad.contiguous(), prev, group=group)
                else:
                    g_micro[i] = x.grad
            ctx.records[i] = None  # this microbatch's graph is done
        return (None, g_micro if ctx.needs_input_grad[1] else None,
                *(None for _ in leaves))


def spmd_pipeline(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    stage_params: Any,
    microbatches: torch.Tensor,
    group: Group = None,
    *,
    stacked_params: bool = True,
    with_aux: bool = False,
):
    """Run a stage-partitioned function over microbatches (GPipe).

    stage_fn(stage_params, x) -> y, this rank's stage, with y shaped as
    x; with `with_aux=True` it returns (y, aux_scalar), and the aux of
    every microbatch is summed rank-locally (aux never travels between
    stages: sum it over the group to get the pipeline's total).
    stage_params: this rank's stage, an nn.Module or a tree (dicts,
    lists) of tensors; with `stacked_params` a tree whose leaves carry a
    leading [n_stages] axis (`stack_stage_params`), of which this rank
    takes its own slice.
    microbatches: [num_mb, mb, ...], read on the first stage only (the
    others take its shape and dtype).

    Returns [num_mb, mb, ...] outputs, valid on the LAST stage (zeros
    elsewhere), or (outputs, aux_sum) with `with_aux`. Differentiable:
    the backward is the explicit reverse schedule (see the module doc).
    It adds the stage parameters' gradients into their `.grad` as it
    runs each microbatch, as a reentrant checkpoint does, with no second
    copy of them: reach them with `backward()`, not `autograd.grad`.
    """
    leaves = _leaves(stage_params)
    run = (stage_fn, stage_params, group,
           stacked_params and not isinstance(stage_params, nn.Module),
           with_aux)
    outputs, aux = _Pipeline.apply(run, microbatches, *leaves)
    return (outputs, aux) if with_aux else outputs


def broadcast_from_last_stage(outputs: torch.Tensor,
                              group: Group = None) -> torch.Tensor:
    """Every rank gets the last stage's outputs (zeros elsewhere make a
    sum a broadcast). Under the port's gradient convention a value every
    rank then holds is counted once per rank: an objective computed from
    it on every rank must be divided by the group's size to count once."""
    return allreduce(outputs, group)


def stack_stage_params(per_stage_params: list) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    axis on every leaf."""
    first = per_stage_params[0]
    stacked = [torch.stack(xs) for xs in
               zip(*(_leaves(t) for t in per_stage_params))]
    return _rebuild(first, stacked)
