"""Entry points of the PyTorch/CUDA port (the counterpart of the
repository's `__graft_entry__.py`).

entry()             - the flagship model's forward and example inputs,
                      on the card unless `device="cpu"`.
dryrun_multichip(n) - the sharded training step (dp + fsdp + tp, remat
                      Llama) over an n-rank mesh of local gloo processes
                      on the CPU, one step on tiny shapes; then the
                      two-slice check, a hybrid dcn_dp=2 x fsdp=n/2 mesh
                      against a flat fsdp=n one; then `dryrun_pp_sp_ep`.
dryrun_pp_sp_ep(n)  - the flagship step pipelined over pp, ring attention
                      over sp and MoE over ep (pp 2 x sp 2 x ep 2 at 8
                      ranks), 3 steps whose loss must fall; and a 4-stage
                      pipeline, ring + Ulysses attention and an
                      expert-parallel MoE, each with a gradient.

    python -m ray_tpu_torch.graft_entry 8
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import llama
from .parallel.mesh import MeshSpec, pipeline_mesh
from .train.backend import run_local_gang
from .train.train_step import (
    default_optimizer,
    full_tensor,
    local_shard,
    make_train_step,
    shard_batch,
)


def entry(device="cuda"):
    """Return (fn, example_args): the flagship model's forward, at the
    JAX entry's config, with its parameters and tokens on `device`."""
    cfg = llama.LlamaConfig(
        vocab_size=32000,
        dim=512,
        n_layers=4,
        n_heads=8,
        n_kv_heads=8,
        intermediate=1408,
        max_seq_len=512,
        dtype=torch.bfloat16,
        attention="flash",
    )
    gen = torch.Generator(device=device).manual_seed(0)
    model = llama.init_params(cfg, gen, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                           device=device)

    def fn(model, tokens):
        return llama.forward(model, tokens)

    return fn, (model, tokens)


#: One run of `train_on_meshes`: the layout, the batch [rows, seq + 1],
#: the number of steps and, optionally, targets [rows, seq] (< 0 masked)
#: to take in place of the batch's shifted tokens.
Run = Tuple[Any, ...]


def train_on_meshes(rank: int, cfg: llama.LlamaConfig, runs: Sequence[Run],
                    state: Optional[Dict[str, np.ndarray]] = None,
                    learning_rate: float = 3e-4,
                    total_steps: int = 10) -> List[Dict[str, Any]]:
    """One rank of a local gang (`run_local_gang`): for each run, the
    whole model from `state` (a state dict of arrays; None: random init
    from seed 0) laid out on the run's mesh (any `MeshSpec` but pp: the
    sequence over sp, a MoE config's experts over tp) by
    `make_train_step`,
    trained on the batch, every rank passing the same whole batch. Per
    run: the losses and grad norms, this rank's parameter bytes, and on
    rank 0 the final state, whole, as arrays."""
    results = []
    for spec, tokens, steps, *targets in runs:
        mesh = spec.build("cpu")
        if state is None:
            model = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        else:
            model = llama.Llama(cfg, device="cpu")
            model.load_state_dict({k: torch.from_numpy(np.array(v))
                                   for k, v in state.items()})
        init_fn, step_fn = make_train_step(
            llama.loss_fn,
            default_optimizer(learning_rate=learning_rate,
                              total_steps=total_steps),
            mesh, llama.param_annotations(cfg))
        st = init_fn(model)
        batch = torch.as_tensor(np.asarray(tokens)).long()
        inputs = shard_batch(batch[:, :-1], mesh)
        labels = shard_batch(torch.as_tensor(np.asarray(targets[0])).long()
                             if targets else batch[:, 1:], mesh)
        losses, norms = [], []
        for _ in range(steps):
            st, metrics = step_fn(st, inputs, labels)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        final = {n: full_tensor(t).numpy()  # a collective: every rank
                 for n, t in model.state_dict().items()}
        results.append({
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "losses": losses, "grad_norms": norms,
            "param_bytes": sum(local_shard(p).numel() * p.element_size()
                               for p in model.parameters()),
            "final": final if rank == 0 else None,
        })
    return results


def _dryrun_config() -> llama.LlamaConfig:
    return llama.LlamaConfig(
        vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=8,
        intermediate=256, max_seq_len=64, dtype=torch.float32,
        attention="reference",
    )


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """The FULL training step over an n-rank CPU mesh with real
    dp/fsdp/tp layouts, one step on tiny shapes, in n spawned gloo
    processes; then two steps of the hybrid two-slice mesh against the
    flat one, whose losses must agree within 5e-4 (pure data
    parallelism across slices changes nothing)."""
    tp = 2 if n_devices % 2 == 0 else 1
    dp = 2 if n_devices % 4 == 0 else 1
    fsdp = n_devices // (tp * dp)
    cfg = _dryrun_config()
    rng = np.random.default_rng(1)
    runs: List[Run] = [(MeshSpec(dp=dp, fsdp=fsdp, tp=tp),
                        rng.integers(0, cfg.vocab_size, (dp * fsdp, 64)), 1)]
    two_slice = n_devices >= 4 and n_devices % 2 == 0
    if two_slice:
        tokens = rng.integers(0, cfg.vocab_size, (n_devices, 65))
        runs += [(MeshSpec(dcn_dp=2, fsdp=n_devices // 2), tokens, 2),
                 (MeshSpec(fsdp=n_devices), tokens, 2)]
    main, *slices = run_local_gang(train_on_meshes, n_devices, (cfg, runs),
                                   device="cpu", timeout=timeout)[0]
    loss = main["losses"][0]
    assert loss > 0 and math.isfinite(loss), f"bad loss {loss}"
    print(f"dryrun_multichip OK: mesh={main['mesh']} loss={loss:.4f} step=1")
    if two_slice:
        hybrid, flat = slices[0]["losses"], slices[1]["losses"]
        for h, f in zip(hybrid, flat):
            assert abs(h - f) < 5e-4, (
                f"2-slice dp diverged from single-slice: {hybrid} vs {flat}")
        print(f"dryrun two-slice OK: hybrid mesh dcn_dp=2 x fsdp="
              f"{n_devices // 2} losses={[round(x, 4) for x in hybrid]} == "
              f"flat fsdp={n_devices} losses={[round(x, 4) for x in flat]}")
    else:
        print("dryrun two-slice skipped: need an even >=4 device count")
    dryrun_pp_sp_ep(n_devices, timeout)


def _flagship_pp_sp_ep(pp: int, sp: int, ep: int) -> Dict[str, Any]:
    """`__graft_entry__._dryrun_flagship_pp_sp_ep` on this rank: the
    flagship step pipelined over pp, ring attention over sp, 4 experts
    over ep, 3 steps on one batch."""
    from .train.pipeline_step import make_pp_train_step

    mesh = pipeline_mesh(pp, sp, ep, "cpu")
    if mesh.get_coordinate() is None:
        return {}
    cfg = llama.LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
        intermediate=128, max_seq_len=64, dtype=torch.float32,
        attention="ring", moe_experts=4 if ep > 1 else 0,
    )
    init_fn, step_fn = make_pp_train_step(
        cfg, mesh, default_optimizer(learning_rate=1e-2, total_steps=10),
        num_microbatches=2)
    state = init_fn(llama.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (4 * ep, 65),
                           generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(3):
        state, metrics = step_fn(state, tokens[:, :-1], tokens[:, 1:])
        losses.append(metrics["loss"].item())
    return {"mesh": {"pp": pp, "sp": sp, "ep": ep},
            "moe_experts": cfg.moe_experts, "losses": losses}


def _primitives(n: int) -> Optional[Dict[str, float]]:
    """`__graft_entry__._dryrun_pp_sp_ep` on this rank: an n-stage
    pipeline, ring + Ulysses attention over an n-rank sequence shard and
    an n-way expert-parallel MoE, each with a gradient. Returns each
    part's sum of absolute gradients (or outputs), on the first n ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    from .ops.moe import init_moe_params, moe_ffn_ep
    from .ops.ring_attention import ring_attention, ulysses_attention
    from .parallel.collective import allreduce
    from .parallel.pipeline import (
        broadcast_from_last_stage,
        spmd_pipeline,
        stack_stage_params,
    )

    mesh = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("x",))
    if mesh.get_coordinate() is None:
        return None
    group, rank = mesh.get_group("x"), mesh.get_coordinate()[0]
    gen = torch.Generator().manual_seed(0)
    d = 16
    # pp: the stages' objectives are one replicated loss, counted once.
    stacked = stack_stage_params([{"w": torch.randn(d, d, generator=gen) * 0.2}
                                  for _ in range(n)])
    stacked["w"].requires_grad_()
    x = torch.randn(8, 2, d, generator=gen)
    out = spmd_pipeline(lambda p, h: torch.tanh(h @ p["w"]), stacked, x,
                        group)
    (torch.mean(broadcast_from_last_stage(out, group) ** 2) / n).backward()
    # sp: ring + Ulysses over the local sequence shard.
    b, h, t, hd = 2, n, 8 * n, 16
    q = torch.randn(b, h, t, hd, generator=gen).chunk(n, dim=2)[rank]
    sp_out = (ring_attention(q, q, q, group, causal=True)
              + ulysses_attention(q, q, q, group, causal=True))
    # ep: 2 experts a rank, each rank's share of the mean loss.
    moe = init_moe_params(n * 2, d, 2 * d, gen, device="cpu")
    e = slice(rank * 2, rank * 2 + 2)
    w_in = moe["w_in"][e].clone().requires_grad_()
    w_out = moe["w_out"][e].clone().requires_grad_()
    toks = torch.randn(8 * n, d, generator=gen).chunk(n)[rank]
    ep_out, aux = moe_ffn_ep({"router": moe["router"], "w_in": w_in,
                              "w_out": w_out}, toks, group, k=2)
    ((torch.mean(ep_out ** 2) + 0.01 * aux) / n).backward()
    sums = torch.stack([stacked["w"].grad.abs().sum(), sp_out.abs().sum(),
                        w_in.grad.abs().sum() + w_out.grad.abs().sum()])
    return dict(zip(("pp_grad", "sp_out", "ep_grad"),
                    allreduce(sums, group).tolist()))


def _pp_sp_ep_rank(rank: int, n_devices: int):
    if n_devices >= 8:
        pp, sp, ep = 2, 2, 2
    elif n_devices >= 4:
        pp, sp, ep = 2, 2, 1
    else:
        pp = sp = ep = 0
    flagship = _flagship_pp_sp_ep(pp, sp, ep) if pp else None
    return flagship, _primitives(min(4, n_devices))


def dryrun_pp_sp_ep(n_devices: int, timeout: float = 300.0):
    """`__graft_entry__`'s pp/sp/ep dryruns in one gang of n gloo
    processes: the flagship step over pp 2 x sp 2 x ep 2 (8 ranks; 4:
    pp 2 x sp 2; fewer: skipped), whose loss must fall over 3 steps,
    and the pipeline, ring/Ulysses and MoE primitives over min(4, n)
    ranks, whose gradients must be finite. Returns rank 0's results."""
    flagship, parts = run_local_gang(_pp_sp_ep_rank, n_devices, (n_devices,),
                                     device="cpu", timeout=timeout)[0]
    if flagship:
        losses = flagship["losses"]
        assert all(math.isfinite(x) for x in losses), f"bad loss {losses}"
        assert losses[-1] < losses[0], f"loss must decrease: {losses}"
        print(f"dryrun flagship OK: mesh={flagship['mesh']} moe_experts="
              f"{flagship['moe_experts']} losses="
              f"{[round(x, 4) for x in losses]}")
    else:
        print("dryrun flagship pp/sp/ep skipped: <4 devices")
    assert all(math.isfinite(v) and v > 0 for v in parts.values()), parts
    print(f"dryrun pp/sp/ep OK: {min(4, n_devices)}-way pipeline, "
          f"ring+ulysses, moe")
    return flagship, parts


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
