"""Training step (PyTorch port of `ray_tpu/train/train_step.py`).

`default_optimizer` reproduces the JAX package's optax chain
(`clip_by_global_norm` then `adamw` under a warmup-cosine schedule)
step for step: the schedule is read at the update count before it is
incremented, so the first update is exactly zero; the clip divides by
the global norm with no epsilon; the moments keep the parameter dtype.
Updates are applied in place (the counterpart of buffer donation) unless
the step is built with donate=False.

`make_train_step(loss_fn, optimizer, mesh, param_annotations)` lays the
model out on a `MeshSpec` mesh where the JAX package hands shardings to
GSPMD (`shard_module`): tensor parallelism over `tp` through
`parallelize_module`, with the logits left sharded over the vocabulary
through the loss (`loss_parallel`), and FSDP2 (`fully_shard`) over the
data axes, sharding each parameter's embed dim where the rules put it on
`fsdp` and leaving whole the parameters they replicate (the norms), with
the sequence sharded over `sp` (the model's attention runs over the sp
group, and the gradients are summed over it). With `mesh=None` it is the
single-device step. Pipeline parallelism is `make_pp_train_step`
(`pipeline_step.py`).

Compile watch: the step is the program `train.step`, and `init_fn`'s two
parts `train.init_params` (the model laid out on its device or mesh; the
JAX package's jitted init also draws the weights, which the port's
caller builds) and `train.init_opt_state`, under the JAX package's
names: one signature per (state, batch) geometry, and a drifting batch
shape is a storm `doctor` names.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.parallel import loss_parallel

from .._private import step_telemetry
from ..parallel.collective import all_reduce_
from ..parallel.mesh import axis_size
from ..parallel.sharding import (
    ACT_RULES,
    PARAM_RULES,
    Rules,
    distribute,
    placements_for,
    tensor_dim_on,
    tree_map,
)


@dataclasses.dataclass
class TrainState:
    """Step count, the model (its parameters) and the optimizer state."""

    step: int
    params: nn.Module
    opt_state: Dict[str, Any]

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: the step, the model's state dict and
        the optimizer's, its moments keyed by parameter name. Its tensors
        are the live ones (sharded as the parameters are), so restoring
        into it restores the state in place."""
        names = [n for n, _ in self.params.named_parameters()]
        opt = self.opt_state
        return {
            "step": self.step,
            "params": self.params.state_dict(),
            "opt_state": {"count": opt["count"],
                          "mu": dict(zip(names, opt["mu"])),
                          "nu": dict(zip(names, opt["nu"]))},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Take the step and update count of a restored `state_dict()`
        (its tensors were restored in place)."""
        self.step = int(state["step"])
        self.opt_state["count"] = int(state["opt_state"]["count"])


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from `init_value` to
    `peak_value` over `warmup_steps`, then cosine down to `end_value` at
    `decay_steps` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a parameter: gathered from its shards if it is
    a DTensor (a collective: every rank of its mesh must call it)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


class AdamW:
    """Global-norm clip, then AdamW (optax `scale_by_adam`,
    `add_decayed_weights`, `scale_by_learning_rate`) on every parameter,
    norms included. On sharded parameters each rank updates its own
    shards: a moment has its parameter's placements, and the update is
    elementwise."""

    def __init__(self, schedule: Callable[[int], float], b1: float,
                 b2: float, eps: float, weight_decay: float,
                 grad_clip: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        # zeros_like of a DTensor is a DTensor placed like it: the
        # counterpart of `infer_opt_shardings`.
        return {
            "count": 0,
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
        }

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict[str, Any], grad_norm: torch.Tensor) -> None:
        """Update `params` and `state` in place. `grad_norm` is the
        global norm of `grads`, a plain tensor."""
        clip = grad_norm >= self.grad_clip
        count = state["count"] + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        lr = self.schedule(state["count"])
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            p, g, mu, nu = (local_shard(x) for x in (p, g, mu, nu))
            g = torch.where(clip, g / grad_norm.to(g.dtype) * self.grad_clip, g)
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = update + self.weight_decay * p
            p.add_(update * -lr)
        state["count"] = count


class SGD:
    """Plain SGD (optax `sgd` without momentum) with `AdamW`'s interface:
    each parameter moves by -learning_rate * its gradient; no clip, so
    `grad_norm` is not read."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict[str, Any], grad_norm=None) -> None:
        for p, g in zip(params, grads):
            local_shard(p).add_(local_shard(g), alpha=-self.learning_rate)
        state["count"] += 1


def default_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamW:
    """AdamW + warmup-cosine schedule + global-norm clipping, as the
    JAX package's `default_optimizer`."""
    warmup_steps = min(warmup_steps, max(1, total_steps // 10))
    schedule = warmup_cosine_decay(
        init_value=0.0,
        peak_value=learning_rate,
        warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=learning_rate * 0.1,
    )
    return AdamW(schedule, b1=b1, b2=b2, eps=1e-8,
                 weight_decay=weight_decay, grad_clip=grad_clip)


def _sum_of_squares(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(t.float() * t.float())


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32, a plain
    tensor. DTensors add their local shards' squares, each divided by
    the number of ranks that hold a copy of that shard, and one
    all-reduce over the process group sums them: every rank of the
    group must call it, and hold a shard of every DTensor (a parameter
    the mesh's tp ranks share is not on their mesh, so its copies are
    counted as the world over its shards)."""
    total = sum(_sum_of_squares(t) for t in tensors
                if not isinstance(t, DTensor))
    sharded = [t for t in tensors if isinstance(t, DTensor)]
    if sharded:
        local = 0.0
        for t in sharded:
            shards = math.prod(t.device_mesh.size(i)
                               for i, p in enumerate(t.placements)
                               if p.is_shard())
            copies = dist.get_world_size() // shards
            local = local + _sum_of_squares(t.to_local()) / copies
        dist.all_reduce(local)
        total = total + local
    return torch.sqrt(total)


def _check_mesh(mesh) -> Dict[str, int]:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if sizes.get("pp", 1) > 1:
        raise NotImplementedError(
            f"pp={sizes['pp']}: pipeline parallelism is make_pp_train_step "
            "(ray_tpu_torch.train.pipeline_step), on a (pp, sp, ep) mesh")
    return sizes


def _to_mesh(x, mesh, placements):
    """`x` (a tensor or array, or a DTensor) as a DTensor of `placements`
    on `mesh`. Every sharded dim must split evenly over its mesh axes,
    as JAX's `device_put` requires: a sequence that `sp` does not divide
    raises, where DTensor would cut uneven shards."""
    if not isinstance(x, DTensor):
        x = torch.as_tensor(x)
    splits = {}
    for i, p in enumerate(placements):
        if p.is_shard():
            splits.setdefault(p.dim, []).append(i)
    for dim, axes in splits.items():
        n = math.prod(mesh.size(i) for i in axes)
        if x.shape[dim] % n:
            names = [mesh.mesh_dim_names[i] for i in axes]
            raise ValueError(f"dim {dim} of the batch {tuple(x.shape)} does "
                             f"not split over the {n} ranks of {names}")
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute(x, mesh, placements)


def _tp_style(module: nn.Module, dim: int, axis_name: str):
    """The tensor-parallel style that shards `module`'s weight on `dim`.
    A column-sharded output stays sharded where the next op is local to
    the shard (heads, mlp) and is gathered where the model needs it
    whole (vocab: the logits)."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
    )

    if isinstance(module, nn.Embedding):
        if dim != 0:
            raise ValueError("an embedding splits over tp on its rows only")
        return RowwiseParallel(input_layouts=Replicate())  # partial sums
    if dim == 1:
        return RowwiseParallel()
    if axis_name == "vocab":
        # The logits stay a DTensor sharded over the vocabulary; the
        # loss reads them under `loss_parallel`.
        return ColwiseParallel(output_layouts=Shard(-1),
                               use_local_output=False)
    return ColwiseParallel()


def shard_module(model: nn.Module, mesh, param_annotations: Dict[str, Any],
                 rules: Rules = PARAM_RULES) -> nn.Module:
    """Lay `model` out on `mesh` (a `MeshSpec` mesh) in place, following
    each parameter's logical axes (`param_annotations`, by state-dict
    name) through `rules`:

    - `tp`: every nn.Linear / nn.Embedding whose weight has a dim on tp
      goes through `parallelize_module` (colwise for an output dim,
      rowwise for an input dim). A bare parameter with a dim on tp (a
      MoE layer's `w_in` [E, embed, mlp] and `w_out` [E, mlp, embed])
      becomes a DTensor sharded on that dim over the tp mesh; the layer
      runs its expert products on the local `mlp` shard
      (`ops.moe.moe_ffn_dense` over the tp group).
    - `fsdp`: FSDP2's `fully_shard` on each child of every ModuleList
      (the layers) and on the root, over the data axes as HSDP: `dcn_dp`
      and `dp` replicate (flattened into one dim when both are > 1),
      `fsdp` shards. `shard_placement_fn` shards each parameter on the
      dim the rules put on `fsdp` (two-dimensionally with tp: the
      experts' embed dim on fsdp, their mlp dim on tp). A parameter with
      no dim on `fsdp` (the norms, the biases) is left out of FSDP2
      (`ignored_params`), whole on every data shard as the rules have
      it; its gradients are averaged over the data shards by
      `reduce_data_grads`. A model with `batch_groups` (`Llama`)
      gets the data mesh's groups.
    - `sp`: no parameter rule names it, so the parameters are whole over
      it; a model with `seq_group` (`Llama`) gets the sp group, over
      which it runs its attention and takes the positions and the MoE
      router's statistics of its sequence shard. The step sums the
      gradients over it (`reduce_data_grads`).

    The model must be whole on every rank, on the mesh's device type or
    the CPU, with the same values.

    FSDP2 ties a sharded model into reference cycles (the state and the
    hooks it puts on each module refer back to the module), so a model
    dropped by its caller outlives `del` until the cyclic collector
    runs, where JAX frees arrays by refcount. Laying out a new model is
    where an earlier one is replaced (a second mesh step in a process, a
    retried fit, `donate=False`'s copy of every step): it runs the
    cyclic collector first, so the old one's memory is free before the
    new one takes its own."""
    gc.collect()
    sizes = _check_mesh(mesh)
    model.to(mesh.device_type)
    if sizes["tp"] > 1:
        from torch.distributed.tensor.parallel import parallelize_module

        plan = {}
        for name, module in model.named_modules():
            ann = param_annotations.get(f"{name}.weight")
            if ann is None or not isinstance(module, (nn.Linear, nn.Embedding)):
                continue
            dim = tensor_dim_on(ann.logical_axes, rules, "tp")
            if dim is not None:
                plan[name] = _tp_style(module, dim, ann.logical_axes[dim])
        parallelize_module(model, mesh["tp"], plan)
        _shard_bare_params(model, mesh["tp"], param_annotations, rules)

    from torch.distributed.fsdp import fully_shard

    fsdp_dim, ignored = {}, set()
    for name, p in model.named_parameters():
        ann = param_annotations.get(name)
        dim = tensor_dim_on(ann.logical_axes, rules, "fsdp") if ann else None
        fsdp_dim[id(p)] = dim
        if ann is not None and dim is None:
            ignored.add(p)

    def placement(p):
        dim = fsdp_dim.get(id(p))
        return Shard(dim) if dim is not None else None  # None: Shard(0)

    dp_mesh = data_mesh(mesh)
    if hasattr(model, "batch_groups") and dp_mesh.size() > 1:
        model.batch_groups = tuple(dp_mesh.get_group(i)
                                   for i in range(dp_mesh.ndim))
    if hasattr(model, "seq_group") and sizes["sp"] > 1:
        model.seq_group = mesh.get_group("sp")
    kw = dict(mesh=dp_mesh, shard_placement_fn=placement,
              ignored_params=ignored)
    for module in model.modules():
        if isinstance(module, nn.ModuleList):
            for child in module:
                fully_shard(child, **kw)
    fully_shard(model, **kw)
    return model


def _shard_bare_params(model: nn.Module, tp_mesh, param_annotations,
                       rules: Rules) -> None:
    """Shard over `tp_mesh` each parameter that is not an nn.Linear's or
    nn.Embedding's (those go through `parallelize_module`) and has a dim
    on tp: its local chunk of that dim, as a DTensor."""
    for module_name, module in model.named_modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            continue
        for name, p in list(module.named_parameters(recurse=False)):
            full = f"{module_name}.{name}" if module_name else name
            ann = param_annotations.get(full)
            dim = tensor_dim_on(ann.logical_axes, rules, "tp") if ann else None
            if dim is not None:
                setattr(module, name, nn.Parameter(
                    distribute(p.data, tp_mesh, [Shard(dim)]),
                    requires_grad=p.requires_grad))


def data_mesh(mesh):
    """The mesh FSDP2 runs over: the data axes as HSDP, `dcn_dp` and `dp`
    replicating (flattened into one dim when both are > 1), `fsdp`
    sharding."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    replicate = [a for a in ("dcn_dp", "dp") if sizes[a] > 1]
    if len(replicate) == 2:
        flat = mesh["dcn_dp", "dp"]._flatten("dcn_dp_dp")
        return mesh[flat.mesh_dim_names[0], "fsdp"]
    if replicate:
        return mesh[replicate[0], "fsdp"]
    return mesh["fsdp"]


def _fsdp_managed(p: torch.Tensor) -> bool:
    return isinstance(p, DTensor) and "fsdp" in p.device_mesh.mesh_dim_names


def reduce_data_grads(model: nn.Module, dp_mesh, sp_group=None) -> None:
    """Average the gradients over the data shards that FSDP2 does not
    average them over: those of the parameters FSDP2 leaves alone
    (`shard_module`) over the data mesh `dp_mesh` and the sp group, the
    others over the sp group alone. The parameters are whole over sp, so
    its ranks hold the same shards and each has the gradient of its own
    tokens' objective; `data_shards` counts sp in."""
    sp = [sp_group] if sp_group is not None else []
    data = ([dp_mesh.get_group(i) for i in range(dp_mesh.ndim)]
            if dp_mesh.size() > 1 else [])
    ignored, managed = [], []
    for p in model.parameters():
        if p.grad is not None:
            (managed if _fsdp_managed(p) else ignored).append(
                local_shard(p.grad))
    for grads, groups in ((ignored, data + sp), (managed, sp)):
        if not grads or not groups:
            continue
        for group in groups:
            all_reduce_(grads, group)
        n = math.prod(dist.get_world_size(group) for group in groups)
        for g in grads:
            g.div_(n)


def _data_sum(x: torch.Tensor, data_shards: int) -> torch.Tensor:
    """Sum of a scalar over the batch's data shards. On a mesh over the
    whole process group, the ranks that hold one data shard (its tp
    ranks) hold copies of the same value: the world's sum over copies."""
    x = x.clone()
    dist.all_reduce(x)
    return x / (dist.get_world_size() // data_shards)


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: AdamW,
    mesh=None,
    param_annotations: Optional[Dict[str, Any]] = None,
    *,
    param_rules: Rules = PARAM_RULES,
    batch_logical_axes: Tuple[Optional[str], ...] = ("batch", "seq"),
    act_rules: Rules = ACT_RULES,
    donate: bool = True,
    device="cuda",
):
    """Build (init_fn, step_fn).

    loss_fn(model, tokens, targets) -> scalar loss, a mean over the
    targets >= 0 (as `llama.loss_fn`).
    init_fn(model) -> TrainState: the model on `device` (mesh=None), or
    laid out on `mesh` by `shard_module(model, mesh, param_annotations,
    param_rules)`, and moments placed like their parameters.
    step_fn(state, tokens, targets) -> (state, metrics): one step;
    metrics {"loss", "grad_norm"}
    stay on the device (grad_norm of the gradients before clipping, over
    every shard). On a mesh, tokens and targets are `shard_batch`'s
    DTensors or whole host batches (sharded here, or resharded): rows
    over the data axes, the sequence over `sp`, whose size must divide
    it. Each data shard computes `loss_fn` on its own rows and sequence
    shard; weighted by its share of the batch's unmasked targets, the
    shards' losses and gradients add up to the mean over the whole
    batch, as the JAX step computes it, however unevenly the targets are
    masked. The step takes every mesh JAX's does but `pp`
    (`make_pp_train_step`): dcn_dp, dp, fsdp, sp and tp, MoE models
    included (`shard_module`).

    With `donate` (the default) the step updates the state passed in,
    in place, as the JAX step donates its buffers; with donate=False it
    leaves that state unchanged and returns a new one (a copy of the
    model and the optimizer state, updated).
    """
    if mesh is not None:
        if param_annotations is None:
            raise ValueError("a mesh needs param_annotations")
        _check_mesh(mesh)
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh spans {mesh.size()} ranks of a "
                             f"world of {dist.get_world_size()}: a train "
                             "step needs the whole world")
        device = torch.device(mesh.device_type)
        batch_placements = placements_for(mesh, batch_logical_axes, act_rules)
        data_shards = math.prod(mesh.size(i)
                                for i, p in enumerate(batch_placements)
                                if p.is_shard())
        dp_mesh = data_mesh(mesh)
        tp = axis_size(mesh, "tp")
        sp_group = mesh.get_group("sp") if axis_size(mesh, "sp") > 1 else None
    device = torch.device(device)

    blank = []  # donate=False on a mesh: the model's unsharded skeleton
    from .._private import compile_watch

    def place(model: nn.Module) -> nn.Module:
        if mesh is None:
            return model.to(device)
        if not donate:
            blank[:] = [copy.deepcopy(model).to("meta")]
        return shard_module(model, mesh, param_annotations, param_rules)

    place = compile_watch.instrument("train.init_params", place)
    init_opt_state = compile_watch.instrument("train.init_opt_state",
                                              optimizer.init)

    def init_fn(model: nn.Module) -> TrainState:
        model = place(model)
        return TrainState(step=0, params=model,
                          opt_state=init_opt_state(list(model.parameters())))

    def copy_state(state: TrainState) -> TrainState:
        """A new state equal to `state`. FSDP2 modules cannot be deep
        copied: on a mesh the copy is the skeleton laid out anew, its
        shards loaded from the state's."""
        if mesh is None:
            return TrainState(state.step, copy.deepcopy(state.params),
                              copy.deepcopy(state.opt_state))
        model = copy.deepcopy(blank[0]).to_empty(device=device)
        shard_module(model, mesh, param_annotations, param_rules)
        model.load_state_dict(state.params.state_dict())
        opt = state.opt_state
        return TrainState(state.step, model, {
            "count": opt["count"], "mu": [m.clone() for m in opt["mu"]],
            "nu": [n.clone() for n in opt["nu"]]})

    def local_batch(x):
        if mesh is None:
            return torch.as_tensor(x, device=device)
        return _to_mesh(x, mesh, batch_placements).to_local()

    def step_fn(state: TrainState, tokens, targets):
        if not donate:
            state = copy_state(state)
        model = state.params
        tokens, targets = local_batch(tokens), local_batch(targets)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        if mesh is None:
            loss = loss_fn(model, tokens, targets)
            loss.backward()
        else:
            # FSDP2 averages the gradients over the data shards: weight
            # each shard by data_shards x its share of the unmasked
            # targets, so they add up to the whole batch's mean.
            count = torch.sum(targets >= 0).float()
            share = count / torch.clamp(_data_sum(count, data_shards), min=1.0)
            with loss_parallel() if tp > 1 else contextlib.nullcontext():
                loss = loss_fn(model, tokens, targets)
                (loss * (share * data_shards)).backward()
            reduce_data_grads(model, dp_mesh, sp_group)
            loss = _data_sum(loss.detach() * share, data_shards)
        grads = [p.grad for p in params]
        gnorm = global_norm(grads)
        optimizer.apply(params, grads, state.opt_state, gnorm)
        for p in params:
            p.grad = None
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    # One signature per (state, batch) geometry, as the JAX step's one
    # compile: a drifting batch shape convicts itself in `doctor`.
    step_fn = compile_watch.instrument("train.step", step_fn)
    return init_fn, step_fn


def shard_batch(batch, mesh, logical_axes=("batch", "seq"),
                rules: Rules = ACT_RULES):
    """Host batches (tensors or numpy arrays, in a tree) as DTensors on
    the mesh's data axes. Every rank passes the same whole batch, as
    every process passes the same global array to JAX's device_put."""
    placements = placements_for(mesh, logical_axes, rules)
    return tree_map(lambda x: _to_mesh(x, mesh, placements), batch)


def prefetch_to_device(
    batches,
    mesh,
    *,
    buffer_size: int = 2,
    logical_axes: Tuple[Optional[str], ...] = ("batch", "seq"),
    rules: Rules = ACT_RULES,
):
    """Double-buffer host batches onto the mesh: batch N+1's copy is
    issued before batch N is consumed, so its host-to-device transfer
    overlaps step N's compute. On a CUDA mesh each leaf is pinned and
    copied with `non_blocking=True` on a side stream, and the consumer's
    stream waits for that copy's event when the batch is handed out;
    on a CPU mesh (where CPU-only torch cannot pin) it is sharded as
    `shard_batch` does. The dispatch time is billed as `h2d_ms`, the
    wait for the source as `data_wait_ms`.

    `batches` is any iterator of trees; buffer_size=2 is classic double
    buffering, 1 degenerates to put-then-yield with no overlap.
    """
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
    placements = placements_for(mesh, logical_axes, rules)
    cuda = mesh.device_type == "cuda"
    stream = torch.cuda.Stream() if cuda else None

    def put_leaf(x):
        x = torch.as_tensor(x)
        if not cuda:
            return _to_mesh(x, mesh, placements)
        with torch.cuda.stream(stream):
            x = x.pin_memory().to("cuda", non_blocking=True)
            return _to_mesh(x, mesh, placements)

    def put(batch):
        t0 = time.monotonic()
        out = tree_map(put_leaf, batch)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(stream)
        step_telemetry.add_phase("h2d_ms", (time.monotonic() - t0) * 1e3)
        return out, event

    def hand_out(entry):
        out, event = entry
        if event is not None:
            current = torch.cuda.current_stream()
            current.wait_event(event)
            # The copies were made on the side stream: keep their memory
            # from being reused before the consumer's stream is done.
            tree_map(lambda x: x.to_local().record_stream(current), out)
        return out

    window: "deque" = deque()
    iterator = iter(batches)

    def pull():
        with step_telemetry.phase_timer("data_wait_ms"):
            return next(iterator)

    while True:
        while len(window) < buffer_size:
            try:
                window.append(put(pull()))
            except StopIteration:
                while window:
                    yield hand_out(window.popleft())
                return
        yield hand_out(window.popleft())
