"""The training driver: one `TorchTrainer(num_workers=1)` fit whose loop
runs the port's `make_train_step` on a `MeshSpec` mesh, fed by
`prefetch_to_device` (pinned copies on a side stream).

The loop builds one train state, drives it through the mix's checked
steps (set-up, read for the comparison: each loss, the first gradient
from AdamW's first moment, each leaf's change), then measures for the
window: the steps that start before it closes, the card synchronised at
both ends, and the peak memory those steps allocate. A traced run then
profiles a few steps more. The reference follows the checked steps once
the program's state is freed.
"""

from __future__ import annotations

import gc
import tempfile
import time

from .. import traffic, weights
from ..reference import compare
from . import port


def _leaf_norms(torch, params, tensors, scale=1.0):
    out = {}
    for (name, _), t in zip(params, tensors):
        local = t.to_local() if hasattr(t, "to_local") else t
        out[port.bench_name(name)] = torch.linalg.vector_norm(
            local, dtype=torch.float32).item() * scale
    return out


def _change_norms(torch, model, a, seed, device):
    """Each leaf's distance from the seed's weights, made again one
    group at a time beside the live state."""
    params = {port.bench_name(n): (p.to_local() if hasattr(p, "to_local") else p)
              for n, p in model.named_parameters()}
    out = {}
    with torch.no_grad():
        for name, p0 in weights.all_weights(a, seed, device):
            out[name] = torch.linalg.vector_norm(
                params[name].float() - p0.float()).item()
    return out


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda") -> dict:
    import torch
    import torch.distributed as dist
    from torch.profiler import record_function

    from ray_tpu_torch._private import step_telemetry
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import (
        RunConfig,
        ScalingConfig,
        TorchTrainer,
        default_optimizer,
        init_torch_distributed,
        make_train_step,
        prefetch_to_device,
        report,
    )
    from ray_tpu_torch.train.backend import free_port

    from .. import trace as tracing

    mix = cell.mix
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    batch, seq = mix["batch"], mix["seq"]
    checked = mix["checked_steps"]
    opt = mix["optimizer"]
    out: dict = {"record": {}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def loop():
        own = not dist.is_initialized()
        if own:
            init_torch_distributed(0, 1, f"localhost:{free_port()}", device=dev)
        feed = None
        try:
            model, cfg, a = port.build_model(
                cell.config, seed, dev, attention="flash", remat=True,
                remat_policy=mix["remat_policy"], max_seq_len=seq)
            out["arch"] = a
            optimizer = default_optimizer(**{k: opt[k] for k in (
                "learning_rate", "weight_decay", "warmup_steps",
                "total_steps", "b1", "b2", "grad_clip")})
            if optimizer.eps != opt["eps"]:
                raise ValueError(f"the program's eps {optimizer.eps} is not "
                                 f"the mix's {opt['eps']}")
            mesh = MeshSpec(**mix["mesh"]).build(dev)
            init_fn, step_fn = make_train_step(
                llama.loss_fn, optimizer, mesh, llama.param_annotations(cfg))
            state = init_fn(model)
            del model
            params = list(state.params.named_parameters())

            def batches():
                k = 0
                while True:
                    k += 1
                    rows = torch.from_numpy(
                        traffic.train_batch(seed, k, batch, seq, a["vocab"]))
                    yield {"tokens": rows[:, :-1].contiguous(),
                           "targets": rows[:, 1:].contiguous()}

            feed = prefetch_to_device(batches(), mesh, buffer_size=2)
            steps = [0]

            def one_step():
                nonlocal state
                with record_function("gpubench.next_batch"):
                    data = next(feed)
                with record_function("gpubench.train_step"):
                    state, metrics = step_fn(state, data["tokens"],
                                             data["targets"])
                steps[0] += 1
                phases = step_telemetry.take_phases()
                report({"step": steps[0]})
                return metrics, phases

            losses = []
            for k in range(checked):
                metrics, _ = one_step()
                losses.append(metrics["loss"].item())
                if k == 0:
                    out["first_grad"] = _leaf_norms(
                        torch, params, state.opt_state["mu"],
                        1.0 / (1.0 - opt["b1"]))
            out["losses"] = losses
            out["change"] = _change_norms(torch, state.params, a, seed, dev)
            step_telemetry.take_phases()

            sync()
            if cuda:  # the window's peak, not the checked steps' readings
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out["setup_s"] = t0 - started
            n, h2d = 0, 0.0
            while time.perf_counter() - t0 < seconds:
                _, phases = one_step()
                n += 1
                h2d += phases.get("h2d_ms", 0.0)
            sync()
            window = time.perf_counter() - t0
            out["window"] = {"steps": n, "seconds": window,
                             "tokens": n * batch * seq, "h2d_ms": h2d}
            if cuda:
                out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
            if trace and cuda:
                tracing.warm_profiler(torch)
                one_step()
                sync()
                attention.reset_launch_counts()
                with tracing.profiled(torch, out["record"]):
                    for _ in range(mix["profile_steps"]):
                        one_step()
                out["record"]["launches"] = dict(attention.LAUNCHES)
                out["record"]["profile_steps"] = mix["profile_steps"]
            del state, step_fn, init_fn, params
        finally:
            if feed is not None:
                feed.close()
            if own:
                dist.destroy_process_group()
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="gpubench_fit_") as storage:
        result = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=cuda),
            run_config=RunConfig(name=cell.name, storage_path=storage),
        ).fit()
    if result.error is not None:
        raise result.error

    a = out["arch"]
    w = out["window"]
    tokens_per_s = w["tokens"] / w["seconds"] if w["steps"] else 0.0
    record = out["record"]
    record.update(arch=a, batch=batch, seq=seq, chips=cell.chips,
                  tokens_per_s=tokens_per_s, window=w)
    prog = {"losses": out["losses"], "first_grad": out["first_grad"],
            "change": out["change"]}
    t_ref = time.perf_counter()
    if dev.type == "cuda":
        record["allocated_before_reference"] = torch.cuda.memory_allocated(dev)
    ref = reference(cell, seed, dev)
    record["reference_s"] = time.perf_counter() - t_ref
    numbers = compare.train_numbers(prog, ref, checked)
    return {
        "e2e": {"train_tokens_per_s": tokens_per_s,
                "train_peak_gib": out.get("memory_peak_bytes", 0) / 2 ** 30,
                "setup_s": out["setup_s"]},
        "record": record,
        "numbers": numbers,
        "attempted": w["steps"],
        "failed": 0,
        "memory_peak_bytes": out.get("memory_peak_bytes", 0),
        "program": prog,
        "reference": ref,
    }


def batch_fn(cell, seed: int, device, drop_half: bool = False):
    """(tokens, targets) of step k on `device`, as the program was fed.
    `drop_half` masks half of the batch's targets (half of the rows, or
    of the one row's positions): the fault of a loss over half a batch."""
    import torch

    mix, a = cell.mix, weights.arch(cell.config)

    def batch(k):
        rows = torch.from_numpy(traffic.train_batch(
            seed, k, mix["batch"], mix["seq"], a["vocab"])).to(device)
        tokens, targets = rows[:, :-1], rows[:, 1:].clone()
        if drop_half:
            if targets.shape[0] > 1:
                targets[targets.shape[0] // 2:] = -1
            else:
                targets[:, targets.shape[1] // 2:] = -1
        return tokens, targets

    return batch


def reference(cell, seed: int, device, precision: str = "f32",
              drop_half: bool = False) -> dict:
    """The plain reference over the mix's checked steps."""
    import torch

    from ..reference import model as ref_model
    from ..reference import train as ref_train

    ref_model.no_tf32()
    state_device = cell.mix.get("reference_state_device")
    out = ref_train.follow(
        weights.arch(cell.config), seed, batch_fn(cell, seed, device, drop_half),
        cell.mix["checked_steps"], cell.mix["optimizer"], device,
        precision=precision, state_device=state_device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out
