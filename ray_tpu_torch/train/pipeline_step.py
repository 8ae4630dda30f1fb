"""Pipeline-parallel training step for the flagship model (PyTorch port
of `ray_tpu/train/pipeline_step.py`).

The full Llama training step with its layer stack partitioned over the
`pp` axis of a ("pp", "sp", "ep") mesh (`pipeline_mesh`), composed with
sequence parallelism (ring attention over `sp`) and expert parallelism
(MoE all_to_alls over `ep`). The batch is sharded over `ep`, which
doubles as the data axis, the sequence over `sp`, the layers over `pp`.

Each rank holds its stage (`stage_module`): the embedding, final norm
and lm_head whole, as in the JAX package, the stage's layers, and of
each MoE layer its share of the experts. The schedule is
`spmd_pipeline`'s GPipe with an explicit backward. Where the JAX step
computes the embedding on every pp rank and the head on every rank
after broadcasting the last stage's output, the port embeds on the first
stage and computes the head on the last only; each replicated
parameter's gradient is then summed over the axes it is replicated on
(`_reduce_grads`), so every copy takes the same update, JAX's.

Every rank seeds the backward of its own share of the loss: the last
stage's masked NLL over its tokens divided by the whole batch's count
of targets, and every rank's MoE aux loss divided by num_mb * sp * ep.
The shares add up to JAX's loss: the xent's (nll_sum, count) summed over
`sp` and `ep` before the division, and the aux loss averaged over `sp`
and `ep`, summed over the stages and divided by num_mb.

Compile watch: the step is `train.pp_step`, and `init_fn`'s parts are
`train.pipeline.init_params` (the stage laid out) and
`train.pipeline.init_opt_state`, the JAX package's names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models.llama import (
    Llama,
    LlamaConfig,
    embed_tokens,
    masked_xent,
    model_norm,
)
from ..ops.norms import rotary_embedding
from ..parallel.collective import all_reduce_
from ..parallel.pipeline import spmd_pipeline
from .train_step import AdamW, TrainState

#: Parameters whose copies are split over `ep` (the experts), and those
#: every stage holds whole (the rest are the stage's layers).
_EXPERT_LEAVES = ("w_in", "w_out")
_REPLICATED = ("embed.weight", "final_norm", "lm_head.weight")


def to_pipeline_params(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                       pp: int) -> List[Dict[str, torch.Tensor]]:
    """A whole model's state dict split by stage, the counterpart of the
    JAX package's reshape of the stacked layers [L, ...] ->
    [pp, L/pp, ...]: entry s holds stage s's layers, renumbered from 0,
    and the parameters every stage holds whole."""
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    per = cfg.n_layers // pp
    stages = [{k: state[k] for k in _REPLICATED} for _ in range(pp)]
    for name, value in state.items():
        if name.startswith("layers."):
            _, i, leaf = name.split(".", 2)
            stage, j = divmod(int(i), per)
            stages[stage][f"layers.{j}.{leaf}"] = value
    return stages


def _stage_config(cfg: LlamaConfig, pp: int) -> LlamaConfig:
    # Remat "dots" keeps its policy; every other policy is full
    # checkpointing, as in the JAX step.
    return dataclasses.replace(
        cfg, n_layers=cfg.n_layers // pp,
        remat_policy="dots" if cfg.remat_policy == "dots" else "full")


def stage_module(model: Llama, pp: int, pp_rank: int, ep: int = 1,
                 ep_rank: int = 0, device=None) -> Llama:
    """A new `Llama` holding one rank's stage of `model` (a whole model):
    layers [pp_rank * L/pp, (pp_rank + 1) * L/pp), of each MoE layer the
    experts [ep_rank * E/ep, (ep_rank + 1) * E/ep), and the embedding,
    final norm and lm_head."""
    cfg = model.cfg
    if cfg.moe_experts % ep:
        raise ValueError(f"moe_experts={cfg.moe_experts} not divisible by "
                         f"ep={ep}")
    state = to_pipeline_params(model.state_dict(), cfg, pp)[pp_rank]
    e_local = cfg.moe_experts // ep
    for name in state:
        if name.rsplit(".", 1)[-1] in _EXPERT_LEAVES:
            state[name] = state[name][ep_rank * e_local:(ep_rank + 1) * e_local]
    device = device if device is not None else next(model.parameters()).device
    # Built on the device, not on "meta": a process's first module
    # construction on "meta" keeps its callers' frames alive (torch
    # 2.13), and with them `model`, until the garbage collector runs.
    stage = Llama(_stage_config(cfg, pp), device=device)
    for layer in stage.layers if cfg.moe_experts else ():
        for leaf in _EXPERT_LEAVES:
            shape = (e_local, *getattr(layer, leaf).shape[1:])
            setattr(layer, leaf, nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=device)))
    stage.load_state_dict(state)
    return stage


def _replicated_over(name: str) -> Tuple[str, ...]:
    """The mesh axes over which a stage parameter has copies."""
    if name in _REPLICATED:
        return ("pp", "sp", "ep")
    if name.rsplit(".", 1)[-1] in _EXPERT_LEAVES:
        return ("sp",)
    return ("sp", "ep")


def make_pp_train_step(
    cfg: LlamaConfig,
    mesh,
    optimizer: AdamW,
    *,
    num_microbatches: Optional[int] = None,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for pipeline-parallel training on `mesh`
    (`pipeline_mesh`: axes "pp", "sp", "ep", any of them size 1; only its
    ranks may call these).

    init_fn(model) -> TrainState: `model` is the whole Llama of `cfg`,
    the same on every rank; the state holds this rank's stage of it
    (`stage_module`) on the mesh's device type and its moments.
    step_fn(state, tokens, targets) -> (state, metrics): tokens and
    targets are the GLOBAL batch [B, T] (targets < 0 masked), the same on
    every rank, with B % (ep * num_microbatches) == 0 and T % sp == 0;
    num_microbatches defaults to max(2 * pp, 2). Metrics "loss" and
    "grad_norm" (before clipping, each parameter counted once) stay on
    the device. The state is updated in place.
    """
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    pp, sp, ep = sizes["pp"], sizes["sp"], sizes["ep"]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    if sp > 1 and cfg.attention != "ring":
        # The JAX step would attend within each sequence shard only.
        raise ValueError(f"sp={sp} with attention={cfg.attention!r}: only "
                         "ring attention attends across sequence shards")
    num_mb = num_microbatches or max(2 * pp, 2)
    groups = {a: mesh.get_group(a) for a in ("pp", "sp", "ep")}
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the pipeline mesh")
    pp_rank, sp_rank, ep_rank = coord
    first, last = pp_rank == 0, pp_rank == pp - 1
    sp_group = groups["sp"] if sp > 1 else None
    ep_group = groups["ep"] if ep > 1 else None
    device = torch.device(mesh.device_type)
    aux_scale = cfg.moe_aux_weight / (num_mb * sp * ep)

    from .._private import compile_watch

    build_stage = compile_watch.instrument(
        "train.pipeline.init_params",
        lambda model: stage_module(model, pp, pp_rank, ep, ep_rank,
                                   device=device))
    init_opt_state = compile_watch.instrument(
        "train.pipeline.init_opt_state", optimizer.init)

    def init_fn(model: Llama) -> TrainState:
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        stage = build_stage(model)
        return TrainState(step=0, params=stage,
                          opt_state=init_opt_state(list(stage.parameters())))

    def local(x, b_loc, t_loc):
        x = torch.as_tensor(x)
        return x[ep_rank * b_loc:(ep_rank + 1) * b_loc,
                 sp_rank * t_loc:(sp_rank + 1) * t_loc].to(device)

    def stage_fn(cos, sin):
        def run(layers, h):
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
            for layer in layers:
                h, layer_aux = layer(h, cos, sin, sp_group, ep_group)
                aux = aux + layer_aux
            return h, aux
        return run

    def step_fn(state: TrainState, tokens, targets):
        model = state.params
        B, T = tokens.shape
        if B % (ep * num_mb) or T % sp:
            raise ValueError(f"batch {B} x {T}: B must divide by ep * "
                             f"num_microbatches = {ep * num_mb}, T by sp={sp}")
        b_loc, t_loc = B // ep, T // sp
        mb = b_loc // num_mb
        count = torch.sum(torch.as_tensor(targets) >= 0).float().to(device)
        tokens, targets = local(tokens, b_loc, t_loc), local(targets, b_loc,
                                                             t_loc)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        positions = sp_rank * t_loc + torch.arange(t_loc, device=device)
        cos, sin = rotary_embedding(positions.expand(mb, t_loc), cfg.head_dim,
                                    cfg.rope_theta, cfg.rope_scaling)
        if first:
            x = embed_tokens(cfg, model, tokens)
        else:
            x = torch.empty(b_loc, t_loc, cfg.dim, dtype=cfg.dtype,
                            device=device)
        outs, aux = spmd_pipeline(
            stage_fn(cos, sin), model.layers,
            x.view(num_mb, mb, t_loc, cfg.dim), groups["pp"],
            stacked_params=False, with_aux=True)
        share = aux * aux_scale
        if last:
            h = model_norm(cfg, outs.view(b_loc, t_loc, cfg.dim),
                           model.final_norm)
            nll, _ = masked_xent(model.lm_head(h).float(), targets)
            share = share + nll / torch.clamp(count, min=1.0)
        # `outs` with a zero gradient: every stage enters the pipeline's
        # backward, whether or not its share reads the outputs.
        torch.autograd.backward([share, outs],
                                [torch.ones_like(share),
                                 torch.zeros_like(outs)])
        grads = _reduce_grads(model, groups)
        gnorm = _global_norm(model, grads, groups, sizes)
        optimizer.apply(params, grads, state.opt_state, gnorm)
        for p in params:
            p.grad = None
        loss = share.detach().clone()
        for a in ("pp", "sp", "ep"):
            all_reduce_([loss], groups[a])
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    # Same compile-watch contract as make_train_step's "train.step".
    step_fn = compile_watch.instrument("train.pp_step", step_fn)
    return init_fn, step_fn


def _reduce_grads(model: nn.Module, groups) -> List[torch.Tensor]:
    """Every parameter's gradient summed over the axes on which it has
    copies (zeros where a copy took no part: the embedding off the first
    stage, the head off the last)."""
    named = list(model.named_parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for _, p in named]
    for axis in ("pp", "sp", "ep"):
        all_reduce_([g for (n, _), g in zip(named, grads)
                     if axis in _replicated_over(n)], groups[axis])
    return grads


def _global_norm(model: nn.Module, grads, groups, sizes) -> torch.Tensor:
    """sqrt of the sum of squares over the whole model, each parameter
    counted once: a rank's squares of a parameter are divided by the
    number of ranks holding a copy, and summed over the mesh."""
    local = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for (name, _), g in zip(model.named_parameters(), grads):
        copies = math.prod(sizes[a] for a in _replicated_over(name))
        local = local + torch.sum(g.float() * g.float()) / copies
    for axis in ("pp", "sp", "ep"):
        all_reduce_([local], groups[axis])
    return torch.sqrt(local)
