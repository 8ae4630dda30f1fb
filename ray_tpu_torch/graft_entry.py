"""Entry points of the PyTorch/CUDA port (the counterpart of the
repository's `__graft_entry__.py`).

entry()             - the flagship model's forward and example inputs,
                      on the card unless `device="cpu"`.
dryrun_multichip(n) - the sharded training step (dp + fsdp + tp, remat
                      Llama) over an n-rank mesh of local gloo processes
                      on the CPU, one step on tiny shapes; then the
                      two-slice check, a hybrid dcn_dp=2 x fsdp=n/2 mesh
                      against a flat fsdp=n one.

    python -m ray_tpu_torch.graft_entry 8
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import llama
from .parallel.mesh import MeshSpec
from .train.backend import run_local_gang
from .train.train_step import default_optimizer, make_train_step, shard_batch


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
    from seed 0) laid out on the run's mesh by `make_train_step`,
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
        final = {n: t.full_tensor().numpy()  # a collective: every rank
                 for n, t in model.state_dict().items()}
        results.append({
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "losses": losses, "grad_norms": norms,
            "param_bytes": sum(p.to_local().numel() * p.element_size()
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
    print("dryrun pp/sp/ep: not run; pipeline, ring/Ulysses attention and "
          "MoE wait for the parallelism slice (ROADMAP queue 1, item 8)")


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
