"""What the ranks of a spawned gang run in the port's sharded tests
(`test_torch_sharded.py`). The ranks import this module and the port,
never JAX: it imports neither JAX nor anything of `ray_tpu`."""

import os
import sys
import time

import torch

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


def _step(cfg, mesh, model, tokens):
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=1e-2, total_steps=20),
        mesh, llama.param_annotations(cfg))
    state = init_fn(model)
    batch = torch.as_tensor(tokens).long()
    return state, lambda s: step_fn(s, shard_batch(batch[:, :-1], mesh),
                                    shard_batch(batch[:, 1:], mesh))


def checkpoint_round_trip(rank, path, tokens):
    """Two steps on an fsdp=2 mesh, an async save of the whole state by
    both ranks, then a fresh state (other weights) restored from it: its
    local shards must equal the saved ones bit for bit, and a third step
    from each must give the same loss."""
    cfg = llama.LlamaConfig.tiny()
    mesh = MeshSpec(fsdp=2).build("cpu")
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
        torch.equal(restored["params"][k].to_local(), v.to_local())
        for k, v in saved["params"].items()) and all(
        torch.equal(restored["opt_state"][m][k].to_local(), v.to_local())
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
