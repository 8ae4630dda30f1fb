"""What the ranks of a spawned gang run in the port's multi-rank tests
(`test_torch_sharded.py`, `test_torch_ring.py`, `test_torch_moe.py`,
`test_torch_pipeline.py`, `test_torch_seq_moe_tp.py`). The ranks import
this module and the port, never JAX: it imports neither JAX nor anything
of `ray_tpu`."""

import dataclasses
import functools
import os
import sys
import time

import numpy as np
import torch

from ray_tpu_torch import graft_entry
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train import (
    default_optimizer,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    shard_batch,
    wait_for_checkpoints,
)
from ray_tpu_torch.train.train_step import local_shard


def _step(cfg, mesh, model, tokens):
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=1e-2, total_steps=20),
        mesh, llama.param_annotations(cfg))
    state = init_fn(model)
    batch = torch.as_tensor(tokens).long()
    return state, lambda s: step_fn(s, shard_batch(batch[:, :-1], mesh),
                                    shard_batch(batch[:, 1:], mesh))


def checkpoint_round_trip(rank, path, tokens, spec=MeshSpec(fsdp=2),
                          config=None):
    """Two steps of `LlamaConfig.tiny(**config)` on the mesh of `spec`
    (default fsdp=2), an async save of the whole state by every rank,
    then a fresh state (other weights) restored from it: its local
    shards must equal the saved ones bit for bit, and a third step from
    each must give the same loss."""
    cfg = llama.LlamaConfig.tiny(**(config or {}))
    mesh = spec.build("cpu")
    state, step = _step(cfg, mesh, llama.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), tokens)
    for _ in range(2):
        state, _ = step(state)
    saved = state.state_dict()
    save_checkpoint(path, saved, {"step": state.step}, async_save=True)
    wait_for_checkpoints()
    fresh, fresh_step = _step(cfg, mesh, llama.init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu"), tokens)
    restored = restore_checkpoint(path, fresh.state_dict())
    fresh.load_state_dict(restored)
    bitwise = all(
        torch.equal(local_shard(restored["params"][k]), local_shard(v))
        for k, v in saved["params"].items()) and all(
        torch.equal(local_shard(restored["opt_state"][m][k]), local_shard(v))
        for m in ("mu", "nu") for k, v in saved["opt_state"][m].items())
    restored_step, count = fresh.step, fresh.opt_state["count"]
    losses = [step(state)[1]["loss"].item(),
              fresh_step(fresh)[1]["loss"].item()]
    return {"bitwise": bitwise, "step": restored_step, "count": count,
            "losses": losses,
            "jax_loaded": "jax" in sys.modules,
            "files": sorted(os.listdir(os.path.join(path, "state")))}


def fail_on_rank_one(rank):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def hang(rank, seconds):
    time.sleep(seconds)


def pipeline_runs(rank, runs):
    """The pipeline step (`make_pp_train_step`) on each run's ("pp", "sp",
    "ep") mesh over the gang's first pp * sp * ep ranks; the other ranks
    build the mesh with them and sit the run out (None). A run: (pp, sp,
    ep, cfg, the whole model's state dict as arrays, tokens [B, T + 1],
    steps, num_microbatches, learning rate, total steps). Per run and
    rank: its coordinate, the whole model's `llama.loss_fn` on the batch
    before the first step, the losses and grad norms, and on the ranks
    of sp coordinate 0 the final state of its stage, as arrays."""
    from ray_tpu_torch.parallel import pipeline_mesh
    from ray_tpu_torch.train import make_pp_train_step

    results = []
    for pp, sp, ep, cfg, start, tokens, steps, num_mb, lr, total in runs:
        mesh = pipeline_mesh(pp, sp, ep, "cpu")
        coord = mesh.get_coordinate()
        if coord is None:
            results.append(None)
            continue
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict({k: torch.as_tensor(v) for k, v in
                               start.items()})
        batch = torch.as_tensor(tokens).long()
        with torch.no_grad():
            whole = llama.loss_fn(model, batch[:, :-1], batch[:, 1:]).item()
        init_fn, step_fn = make_pp_train_step(
            cfg, mesh, default_optimizer(learning_rate=lr, total_steps=total),
            num_microbatches=num_mb)
        state = init_fn(model)
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = step_fn(state, batch[:, :-1], batch[:, 1:])
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        stage = None
        if coord[1] == 0:
            stage = {k: v.detach().numpy().copy()
                     for k, v in state.params.state_dict().items()}
        results.append({"coord": list(coord), "loss_fn": whole,
                        "losses": losses, "grad_norms": norms,
                        "stage": stage, "jax_loaded": "jax" in sys.modules})
    return results


def pipelines(rank, stage_ws, x, runs):
    """In a gang of 8: `spmd_pipeline` over the first n ranks, n in (2,
    4), of the stages tanh(h @ stage_ws[i]) on microbatches x: the last
    stage's outputs broadcast to every rank, and this rank's stage
    gradient of mean(outputs ** 2), each rank's objective divided by n
    so that the replicated loss counts once; then `pipeline_runs(rank,
    runs)`."""
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch.parallel.pipeline import (
        broadcast_from_last_stage,
        spmd_pipeline,
        stack_stage_params,
    )

    prims = {}
    for n in (2, 4):
        mesh = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("pp",))
        if mesh.get_coordinate() is None:
            continue
        group = mesh.get_group("pp")
        stacked = stack_stage_params([{"w": torch.tensor(w)}
                                      for w in stage_ws[:n]])
        stacked["w"].requires_grad_()
        out = broadcast_from_last_stage(
            spmd_pipeline(lambda p, h: torch.tanh(h @ p["w"]), stacked,
                          torch.tensor(x), group), group)
        (torch.mean(out ** 2) / n).backward()
        prims[n] = (out.detach().numpy(), stacked["w"].grad[rank].numpy(),
                    float(stacked["w"].grad.abs().sum()
                          - stacked["w"].grad[rank].abs().sum()))
    return prims, pipeline_runs(rank, runs)


def weights(shape, rank, salt):
    """The upstream weights of rank `rank`'s objective in the collective
    cases, the same for the port's gang and the JAX reference."""
    seed = 1000 * salt + rank
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


#: (name, op, output shape of one rank for a group of n, from x [4, 6]).
COLLECTIVE_CASES = [
    ("allreduce_sum", "sum", lambda n: (4, 6)),
    ("allreduce_mean", "mean", lambda n: (4, 6)),
    ("allreduce_prod", "prod", lambda n: (4, 6)),
    ("allgather", None, lambda n: (4, 6 * n)),
    ("reducescatter_sum", "sum", lambda n: (4 // n, 6)),
    ("reducescatter_mean", "mean", lambda n: (4 // n, 6)),
    ("broadcast", None, lambda n: (4, 6)),
    ("send_recv", None, lambda n: (4, 6)),
    ("all_to_all", None, lambda n: (4 // n, 6 * n)),
]


def _collective(name, op, x, group):
    from ray_tpu_torch.parallel import collective as C

    if name.startswith("allreduce"):
        return C.allreduce(x, group, op)
    if name == "allgather":
        return C.allgather(x, group, concat_axis=1)
    if name.startswith("reducescatter"):
        return C.reducescatter(x, group, scatter_axis=0, op=op)
    if name == "broadcast":
        return C.broadcast(x, group, root=1)
    if name == "send_recv":
        return C.send_recv(x, group, shift=1)
    return C.all_to_all(x, group, split_axis=0, concat_axis=1)


def _groups():
    """Groups of 2 (a 2 x 2 mesh's inner dim) and 4 (the world) in a gang
    of 4: {size: (group, this rank's index in it)}."""
    from torch.distributed.device_mesh import DeviceMesh

    import torch.distributed as dist

    mesh = DeviceMesh("cpu", torch.arange(4).view(2, 2),
                      mesh_dim_names=("outer", "inner"))
    rank = dist.get_rank()
    return {2: (mesh.get_group("inner"), rank % 2), 4: (None, rank)}


def sequence_ops(rank, x_all, qkv, do):
    """In a gang of 4: each collective of `COLLECTIVE_CASES` over groups
    of 2 and 4, on x = x_all[index in the group], with the gradient of
    the objective sum(out * weights) (the group's ranks' objectives add
    up); allreduce max and min (no gradient); and ring and Ulysses
    attention, causal and not, over groups of 2 and 4 on this rank's
    sequence shard of q, k, v [b, h, t, d] under the upstream gradient
    `do`. Returns {case: (output, gradients)}."""
    from ray_tpu_torch.ops.ring_attention import (
        ring_attention,
        ulysses_attention,
    )
    from ray_tpu_torch.parallel import collective as C

    out = {}
    for n, (group, index) in _groups().items():
        for salt, (name, op, shape) in enumerate(COLLECTIVE_CASES):
            x = torch.tensor(x_all[index]).requires_grad_()
            y = _collective(name, op, x, group)
            (y * torch.tensor(weights(shape(n), index, salt))).sum().backward()
            out[(name, n)] = (y.detach().numpy(), x.grad.numpy())
        for op in ("max", "min"):
            x = torch.tensor(x_all[index]).requires_grad_()
            y = C.allreduce(x, group, op)
            try:
                y.sum().backward()
                raised = False
            except NotImplementedError:
                raised = True
            out[(f"allreduce_{op}", n)] = (y.detach().numpy(), raised)
        for fn in (ring_attention, ulysses_attention):
            for causal in (True, False):
                q, k, v = (torch.tensor(a).chunk(n, dim=2)[index]
                           .requires_grad_() for a in qkv)
                y = fn(q, k, v, group, causal=causal)
                y.backward(torch.tensor(do).chunk(n, dim=2)[index])
                out[(fn.__name__, causal, n)] = (
                    y.detach().numpy(),
                    [a.grad.numpy() for a in (q, k, v)])
    return out


def expert_ops(rank, params, x_all, g_all, capacity_factor, aux_weight):
    """In a gang of 4: `moe_ffn_ep` over groups of 2 and 4 on this rank's
    token shard x_all[index] and its share of the experts, with the
    gradient of the objective sum(out * g_all[index]) + aux_weight * aux.
    Returns {n: (out, aux, grads of router, w_in, w_out and x)}."""
    from ray_tpu_torch.ops.moe import moe_ffn_ep

    out = {}
    for n, (group, index) in _groups().items():
        e_local = params["w_in"].shape[0] // n
        mine = slice(index * e_local, (index + 1) * e_local)
        p = {"router": torch.tensor(params["router"]).requires_grad_(),
             "w_in": torch.tensor(params["w_in"][mine]).requires_grad_(),
             "w_out": torch.tensor(params["w_out"][mine]).requires_grad_()}
        x = torch.tensor(x_all[index]).requires_grad_()
        y, aux = moe_ffn_ep(p, x, group, k=2, capacity_factor=capacity_factor)
        ((y * torch.tensor(g_all[index])).sum() + aux_weight * aux).backward()
        out[n] = (y.detach().numpy(), aux.item(),
                  [p[k].grad.numpy() for k in ("router", "w_in", "w_out")]
                  + [x.grad.numpy()])
    return out


def step_contracts(rank, tokens):
    """In a gang of 2, on the tiny model from one seed: (a) over
    `MeshSpec(tp=2)`, the logits' placement and this rank's shard of
    them, and the step's loss beside the single-device step's; (b) over
    `MeshSpec(fsdp=2)` with donate=False, whether three steps left the
    first state's parameters as they were, and their losses beside
    those of donate=True."""
    from torch.distributed.tensor.parallel import loss_parallel

    from ray_tpu_torch.train.train_step import full_tensor

    cfg = llama.LlamaConfig.tiny()
    batch = torch.as_tensor(tokens).long()

    def fresh():
        return llama.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")

    single_fn = make_train_step(llama.loss_fn, default_optimizer(
        learning_rate=1e-2, total_steps=20), device="cpu")
    single = single_fn[1](single_fn[0](fresh()), batch[:, :-1],
                          batch[:, 1:])[1]["loss"].item()
    mesh = MeshSpec(tp=2).build("cpu")
    state, step = _step(cfg, mesh, fresh(), tokens)
    loss = step(state)[1]["loss"].item()
    with torch.no_grad():  # the step's updated weights
        logits = llama.forward(state.params, batch[:, :-1])
        with loss_parallel():
            nll, count = llama.masked_xent(logits, batch[:, 1:])
    tp = {"shard_dims": [p.dim if p.is_shard() else None
                         for p in logits.placements],
          "local_shape": list(logits.to_local().shape),
          "whole_shape": list(logits.shape),
          "mean_nll": (nll / count).item(),
          "loss": loss, "single_loss": single}

    mesh = MeshSpec(fsdp=2).build("cpu")
    runs = {}
    for donate in (True, False):
        init_fn, step_fn = make_train_step(
            llama.loss_fn, default_optimizer(learning_rate=1e-2,
                                             total_steps=20),
            mesh, llama.param_annotations(cfg), donate=donate)
        first = init_fn(fresh())
        before = {k: full_tensor(v).clone()
                  for k, v in first.params.state_dict().items()}
        state, losses = first, []
        for _ in range(3):
            state, metrics = step_fn(state, batch[:, :-1], batch[:, 1:])
            losses.append(metrics["loss"].item())
        after = {k: full_tensor(v) for k, v in first.params.state_dict().items()}
        runs[donate] = {
            "losses": losses, "first_step": first.step,
            "unchanged": all(torch.equal(before[k], after[k]) for k in before),
            "new_state": state is not first}
    return {"tp": tp, "donate": runs}


def sequence_and_expert_meshes(rank, jobs, path, tokens):
    """In a gang of 8: for each job (config keywords, runs, start state),
    `graft_entry.train_on_meshes` at lr 1e-2 over 20 total steps, with
    the model's two sequence-attention routes counted; then
    `checkpoint_round_trip` of the 4-expert MoE on fsdp 2 x sp 2 x tp 2.
    Returns ([per job: (results, routes)], checkpoint result)."""
    out = []
    for config, runs, start in jobs:
        routes = {"ulysses_attention": 0, "ring_attention": 0}
        originals = {name: getattr(llama, name) for name in routes}

        def counted(name, *args, **kwargs):
            routes[name] += 1
            return originals[name](*args, **kwargs)

        for name in routes:
            setattr(llama, name, functools.partial(counted, name))
        try:
            results = graft_entry.train_on_meshes(
                rank, llama.LlamaConfig.tiny(**config), runs, start,
                1e-2, 20)
        finally:
            for name, fn in originals.items():
                setattr(llama, name, fn)
        out.append((results, routes))
    ckpt = checkpoint_round_trip(rank, path, tokens,
                                 MeshSpec(fsdp=2, sp=2, tp=2),
                                 {"moe_experts": 4})
    return out, ckpt


def ulysses_flash_and_tp_experts(rank, qkv, do, params, x, g, aux_weight):
    """In a gang of 2 (one group of the whole world): Ulysses attention
    with the flash op (its plain version on the CPU) on this rank's
    sequence shard of q, k, v [b, h, t, d], under the upstream gradient's
    shard; and `moe_ffn_dense` over the group as its tp group, on this
    rank's `mlp` shards of w_in / w_out with the router and x whole,
    every rank holding the same objective
    sum(out * g) + aux_weight * aux, as tensor-parallel ranks do.
    Also the error of the model's sequence attention under "flash" when
    sp does not divide the heads and the tensors are off the CPU (meta
    tensors stand in for the card's).
    Returns (attention output shard, its q/k/v gradients), (MoE output,
    aux, gradients of router, w_in shard, w_out shard and x), the
    error's text or None."""
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.moe import moe_ffn_dense
    from ray_tpu_torch.ops.ring_attention import ulysses_attention

    n = torch.distributed.get_world_size()
    q, k, v = (torch.tensor(a).chunk(n, dim=2)[rank].requires_grad_()
               for a in qkv)
    y = ulysses_attention(q, k, v, None, attention_fn=functools.partial(
        flash_attention, causal=True))
    y.backward(torch.tensor(do).chunk(n, dim=2)[rank])
    attention = (y.detach().numpy(), [a.grad.numpy() for a in (q, k, v)])

    p = {"router": torch.tensor(params["router"]).requires_grad_(),
         "w_in": torch.tensor(params["w_in"]).chunk(n, dim=2)[rank]
         .requires_grad_(),
         "w_out": torch.tensor(params["w_out"]).chunk(n, dim=1)[rank]
         .requires_grad_()}
    xt = torch.tensor(x).requires_grad_()
    out, aux = moe_ffn_dense(p, xt, k=2,
                             tp_group=torch.distributed.group.WORLD)
    ((out * torch.tensor(g)).sum() + aux_weight * aux).backward()
    experts = (out.detach().numpy(), aux.item(),
               [p[name].grad.numpy() for name in ("router", "w_in", "w_out")]
               + [xt.grad.numpy()])

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), attention="flash")
    odd = torch.empty(1, 3, 8, 16, device="meta")
    try:
        llama._sequence_attention(cfg, odd, odd, odd, None)
        refused = None
    except ValueError as e:
        refused = str(e)
    return attention, experts, refused
