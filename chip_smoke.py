#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA
Hopper card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, none of whose failures is caught:
  (a) print the card's name and power limit; build the CUDA kernels
      from `ray_tpu_torch/csrc/`;
  (b) hold each kernel against its plain PyTorch version on the card
      (bf16, q/k/v = randn * 0.5), at the slice's shape and at shapes
      that hit the edges of the kernels' 128-row tiles (t 192, t 64,
      tq 128 / tk 384, kv_len 200 inside a tile, bh 1), and the public
      `flash_attention` against `mha_reference` computed in f32 on the
      same inputs. The backward op is its three launches (delta and
      dq's accumulator zeroed, the fused kernel, dq's scale and cast)
      against its one plain version. Every
      output is held to its reference relatively: max abs error at
      most REL_TOL * max|ref| and L2 error at most REL_TOL * ||ref||.
      The backward runs under two upstream gradients: a random one
      (randn * 0.5), which makes every row of `do` matter, and the
      verify recipe's (loss sum(out * 0.01)), which is also held to its
      absolute bars (`out` 0.05, each gradient 0.01); lse is held to
      1e-3. Two negative controls show the bars catch a backward that
      writes no dq or reads `do` at the wrong rows. Then time each op
      (the backward's three launches together and each alone), its
      plain version and `scaled_dot_product_attention` (a yardstick
      only: the port never calls it);
  (c) the slice: Llama-2-7B width (dim 4096, 32 heads, head_dim 128,
      intermediate 11008, vocab 32000, bf16, flash attention, full
      remat) cut to 4 layers (`--layers`), batch 2 x seq 4096, 8 steps
      of `make_train_step` with `default_optimizer(3e-4,
      total_steps=20)` on one fixed batch. The loss must stay finite
      and fall, and the launch counters must show 2 forward (one under
      remat) and 1 backward op (each of its 3 launches once) per layer
      per step.

Prints `{"kernels": [...]}`, then `{"slice": {...}}`, and as the last
line `{"ok": true, "device": {...}}`. Exits non-zero with no result
line when there is no CUDA card or the port is not beside it.

`--profile` traces one more step with torch.profiler after the slice
and prints `{"profile": ...}`: device time by kernel, and idle share.

`--against ROOT` adds phase (d), a comparison with another checkout of
the repo at ROOT (for example `git archive <commit>` unpacked into a
gitignored directory). Its `ray_tpu_torch` is imported beside this one
and builds its kernels from its own sources. At the slice's shape its
forward kernel and its backward op (every launch its autograd backward
makes) are held to this tree's plain versions and timed in turns ROOT,
this, this, ROOT. Then each tree, ROOT first, trains two steps of the
slice from the same seed with the allocator's history recorded: the
peak of device memory and the largest allocations alive at it, by the
innermost line of the port that made them. Prints `{"against": ...}`.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

#: Dense bf16 tensor-core peak and HBM rate of an H100 SXM at 700 W
#: (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

#: Relative bar on every kernel output: a correct bf16 kernel reads
#: about 0.4% of max|ref|; an output left at zero or computed from the
#: wrong rows reads order 100%.
REL_TOL = 1e-2
#: The verify recipe's absolute bars, for its upstream gradient only.
OUT_TOL = 0.05
GRAD_TOL = 0.01
LSE_TOL = 1e-3
LOGITS_TOL = 0.1  # bf16 model, flash vs reference attention, 2 layers

#: Device-side names of every launch of the two attention ops.
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_pre_kernel",
                 "flash_bwd_kernel", "flash_bwd_dq_kernel")
#: The backward op's launches, by launch counter.
BWD_LAUNCHES = ("flash_bwd_pre", "flash_bwd", "flash_bwd_dq")

TRAIN_STEPS = 8
N_LAYERS = 4
BATCH, SEQ = 2, 4096


def cuda_ms(torch, fn, reps):
    """Mean time of `fn` over `reps` runs after one warm-up, by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def held(name, got, ref, abs_tol=None):
    """Print `got`'s error against `ref` and return (within the bars,
    max abs error). Bars: max abs error <= REL_TOL * max|ref|, L2 error
    <= REL_TOL * ||ref||, and max abs error <= `abs_tol` if given."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    err = diff.abs().max().item()
    ref_max = ref.abs().max().item()
    rel_l2 = (diff.norm() / ref.norm()).item()
    ok = err <= REL_TOL * ref_max and rel_l2 <= REL_TOL
    if abs_tol is not None:
        ok = ok and err <= abs_tol
    print(f"  {name}: max err {err:.3g} (max|ref| {ref_max:.3g}), "
          f"rel L2 {rel_l2:.3g}{'' if ok else ' -- outside the bars'}")
    return ok, err


def grads_held(got, ref, q_len, kv_len, abs_tol=None):
    """`held` over (dq, dk, dv) on their unpadded rows: (all within the
    bars, max abs error of each)."""
    rows = (q_len, kv_len, kv_len)
    checks = [held(name, g[:, :n], r[:, :n], abs_tol)
              for name, g, r, n in zip(("dq", "dk", "dv"), got, ref, rows)]
    return all(ok for ok, _ in checks), [err for _, err in checks]


def valid_pairs(causal, q_len, kv_len):
    """Unmasked (q, kv) pairs of one head: the work this data needs."""
    if not causal:
        return q_len * kv_len
    return sum(min(r + 1, kv_len) for r in range(q_len))


def bound_ms(flops, nbytes):
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def print_ptxas(reports, prefix=""):
    for name, report in reports.items():
        for line in report.splitlines():
            # C75xx: ptxas's wgmma advisories (a serialised pipeline).
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"  {prefix}{name}: {line.strip()}")


def load_port(root):
    """The `ray_tpu_torch` package of the checkout at `root`, imported
    beside this one as `against_ray_tpu_torch`."""
    pkg = os.path.join(os.path.abspath(root), "ray_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "against_ray_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    port = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = port
    spec.loader.exec_module(port)
    return port


def alloc_site(frames):
    """The innermost line of the port among an allocation's Python frames
    (innermost first), else the innermost line at all."""
    for f in frames:
        path = f["filename"]
        if "ray_tpu_torch" in path:
            return f"{path[path.rindex('ray_tpu_torch'):]}:{f['line']} {f['name']}"
    if frames:
        f = frames[0]
        return f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"
    return "(no Python frame)"


def peak_allocations(trace, top=8):
    """(bytes allocated at the peak above the recording's start, the
    largest allocations alive at the peak grouped by `alloc_site`), from
    the allocator's recorded history of one device."""
    def replay(stop):
        live, now, best, best_at = {}, 0, 0, -1
        for i, e in enumerate(trace[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                now += e["size"]
            elif e["action"] == "free_requested":
                live.pop(e["addr"], None)
                now -= e["size"]
            if now > best:
                best, best_at = now, i
        return live, best, best_at

    _, best, best_at = replay(len(trace))
    live = replay(best_at + 1)[0]
    sites = collections.Counter()
    for e in live.values():
        sites[alloc_site(e.get("frames", []))] += e["size"]
    return best, [{"site": s, "bytes": b} for s, b in sites.most_common(top)]


def step_memory(torch, port, n_layers, steps=2):
    """Peak device memory of `steps` steps of the slice trained by
    `port` (a `ray_tpu_torch` package) from seed 0, and what is alive at
    the peak."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    llama = port.models.llama
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    model = llama.init_params(cfg, gen, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=gen,
                          device=dev)
    init_fn, step_fn = port.train.make_train_step(
        llama.loss_fn,
        port.train.default_optimizer(learning_rate=3e-4, total_steps=20),
        device=dev)
    state = init_fn(model)
    del model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    for _ in range(steps):
        state, _ = step_fn(state, batch[:, :-1], batch[:, 1:])
    torch.cuda.synchronize()
    trace = torch.cuda.memory._snapshot()["device_traces"][dev.index or 0]
    torch.cuda.memory._record_memory_history(enabled=None)
    peak = torch.cuda.max_memory_allocated()
    above, sites = peak_allocations(trace)
    del state, batch, trace
    torch.cuda.empty_cache()
    return {"max_memory_allocated": peak, "at_start": start,
            "peak_from_history": start + above, "alive_at_peak": sites}


def against(torch, attn, root, randn, n_layers, reps=20):
    """Phase (d): this tree's attention ops against those of the checkout
    at `root`, then each tree's step memory (see the module's doc)."""
    other = load_port(root)
    reports = other.ops._build.build()
    print(f"against {root}: built {', '.join(reports) or 'cached'}")
    print_ptxas(reports, "against ")
    trees = {"against": other.ops.attention, "this": attn}
    bh, t, d = BATCH * 32, SEQ, 128
    scale = 1.0 / math.sqrt(d)
    q, k, v, do = (randn(bh, t, d) for _ in range(4))
    q2 = attn.prescale(q, scale)
    ref_out, ref_lse = attn.flash_forward_plain(q2, k, v, True, t)
    ref_grads = attn.flash_backward_plain(q2, k, v, ref_out, do, ref_lse,
                                          scale, True, t, t)
    fwd, bwd, errors = {}, {}, {}
    for name, tree in trees.items():
        fwd[name] = lambda tree=tree: tree.flash_forward(q2, k, v, True, t)
        out, lse = fwd[name]()
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = tree.FlashAttentionFunction.apply(*leaves, scale, True, t, t)
        bwd[name] = lambda o=o, leaves=leaves: torch.autograd.grad(
            o, leaves, do, retain_graph=True)
        print(f"against, {name} tree, held to this tree's plain versions:")
        checks = [held("out", out, ref_out)] + [
            held(n, g, r)
            for n, g, r in zip(("dq", "dk", "dv"), bwd[name](), ref_grads)]
        errors[name] = {"out": checks[0][1], "lse": max_err(lse, ref_lse),
                        "grads": [e for _, e in checks[1:]],
                        "within_bars": all(ok for ok, _ in checks)}
        del out, lse, o, leaves
    assert errors["this"]["within_bars"], errors
    del ref_out, ref_lse, ref_grads
    times = {}
    for op, fns, n in (("fwd", fwd, reps), ("bwd_op", bwd, reps // 2)):
        ms = [cuda_ms(torch, fns[name], n)
              for name in ("against", "this", "this", "against")]
        times[op] = {"against_ms": ms[::3], "this_ms": ms[1:3]}
        print(f"against, {op}: {root} {ms[0]:.3f} / {ms[3]:.3f} ms, "
              f"this {ms[1]:.3f} / {ms[2]:.3f} ms")
    del fwd, bwd, fns, q, k, v, do, q2
    torch.cuda.empty_cache()
    this_port = sys.modules["ray_tpu_torch"]
    memory = {name: step_memory(torch, port, n_layers)
              for name, port in (("against", other), ("this", this_port))}
    for name, m in memory.items():
        print(f"against, {name} tree: peak {m['max_memory_allocated']} B "
              f"(from history {m['peak_from_history']}), alive at the peak:")
        for row in m["alive_at_peak"]:
            print(f"    {row['bytes']:>12} {row['site']}")
    return {"root": root, "shape": [bh, t, d], "causal": True,
            "errors": errors, "times": times, "layers": n_layers,
            "memory": memory}


def profile_step(torch, run_step):
    """Device time by kernel over one traced step, grouped into the
    flash kernels, matrix products and the rest; and the device's idle
    share of the step's wall time (the profiler's own cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda row: -row[1])
    groups = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        if any(k in low for k in FLASH_KERNELS):
            groups["flash"] += ms
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy_ms = sum(groups.values())
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms, "groups_ms": groups,
        "top": [{"kernel": n[:120], "ms": ms, "calls": c}
                for n, ms, c in kernels[:12]],
    }


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile", action="store_true",
        help="after the slice, trace one more step with torch.profiler "
             "and print the device time by kernel")
    parser.add_argument(
        "--layers", type=int, default=N_LAYERS,
        help=f"depth of the slice's model (default {N_LAYERS}; "
             "Llama-2-7B has 32)")
    parser.add_argument(
        "--against", metavar="ROOT",
        help="compare the attention ops and the step's memory with those "
             "of another checkout at ROOT (phase (d))")
    args = parser.parse_args()
    n_layers = args.layers

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train import default_optimizer, make_train_step

    # ---- (a) header and build ----------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'cached'})")
    print_ptxas(reports)

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(bf16)

    # ---- (b) each kernel against its plain version --------------------
    # (label, bh, t, tk, d, causal, q_len, kv_len): t and tk are padded
    # to the kernels' tile; rows/columns past q_len/kv_len are padding.
    # The kernels work in 128-row tiles of q and KV: t 192 ends in half
    # a tile, t 64 is half of one, kv_len 200 ends inside a KV tile.
    edge_cases = [
        ("t192", 64, 192, 192, 128, True, 192, 192),
        ("t64", 64, 64, 64, 128, True, 64, 64),
        ("q128k384", 64, 128, 384, 128, False, 128, 384),
        ("kvlen200", 64, 256, 256, 128, False, 256, 200),
        ("bh1", 1, 256, 256, 128, True, 256, 256),
    ]
    fwd_cases = [
        ("main", 64, 4096, 4096, 128, True, 4096, 4096),
        ("cross", 64, 512, 2048, 128, False, 512, 2048),
        ("ragged", 64, 320, 320, 128, True, 300, 300),
        ("d64", 64, 1024, 1024, 64, True, 1024, 1024),
    ] + edge_cases
    bwd_cases = [
        ("main", 64, 4096, 4096, 128, True, 4096, 4096),
        ("causal2048", 64, 2048, 2048, 128, True, 2048, 2048),
        ("cross", 64, 512, 2048, 128, False, 512, 2048),
        ("ragged", 64, 320, 320, 128, True, 300, 300),
        ("d64", 64, 1024, 1024, 64, True, 1024, 1024),
    ] + edge_cases

    def inputs(bh, t, tk, d, q_len, kv_len):
        """q pre-scaled for the kernels, k, v, and q itself."""
        q, k, v = randn(bh, t, d), randn(bh, tk, d), randn(bh, tk, d)
        q[:, q_len:] = 0
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        return attn.prescale(q, 1.0 / math.sqrt(d)), k, v, q

    def backward(q2, k, v, out, lse, do, causal, kv_len, q_len):
        """(kernels, plain version) of the backward op under upstream
        `do`."""
        args = (q2, k, v, out, do, lse, 1.0 / math.sqrt(q2.shape[-1]),
                causal, kv_len, q_len)
        got = attn.flash_backward(*args)
        torch.cuda.synchronize()
        return got, attn.flash_backward_plain(*args)

    results = {}
    for label, bh, t, tk, d, causal, q_len, kv_len in fwd_cases:
        q2, k, v, _ = inputs(bh, t, tk, d, q_len, kv_len)
        out, lse = attn.flash_forward(q2, k, v, causal, kv_len)
        torch.cuda.synchronize()
        p_out, p_lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
        print(f"fwd {label} {(bh, t, tk, d)} causal={causal}:")
        ok, e_out = held("out", out[:, :q_len], p_out[:, :q_len], OUT_TOL)
        e_lse = max_err(lse[:, :q_len], p_lse[:, :q_len])
        print(f"  lse: max err {e_lse:.3g} (bar {LSE_TOL})")
        assert ok and e_lse <= LSE_TOL, (label, e_out, e_lse)
        results[("fwd", label)] = (e_out, e_lse)
        del out, lse, p_out, p_lse
    for label, bh, t, tk, d, causal, q_len, kv_len in bwd_cases:
        q2, k, v, _ = inputs(bh, t, tk, d, q_len, kv_len)
        out, lse = attn.flash_forward(q2, k, v, causal, kv_len)
        do = randn(bh, t, d)
        do[:, q_len:] = 0
        print(f"bwd {label} {(bh, t, tk, d)} causal={causal}, random do:")
        got, ref = backward(q2, k, v, out, lse, do, causal, kv_len, q_len)
        ok, errs = grads_held(got, ref, q_len, kv_len)
        assert ok, (label, "random do", errs)
        results[("bwd", label)] = max(errs)
        if label == "main":
            # Negative controls: the bars reject a backward that wrote no
            # dq, and the kernel given `do` shifted by one row.
            print("  negative control, dq = 0 (must be outside the bars):")
            assert not grads_held((torch.zeros_like(got[0]),) + got[1:],
                                  ref, q_len, kv_len)[0]
            print("  negative control, do shifted one row (must be "
                  "outside the bars):")
            shifted, _ = backward(q2, k, v, out, lse, do.roll(1, dims=1),
                                  causal, kv_len, q_len)
            assert not grads_held(shifted, ref, q_len, kv_len)[0]
            del shifted
        del got, ref
        # The verify recipe's upstream gradient: d(sum(out * 0.01))/d(out).
        do = torch.full_like(out, 0.01)
        do[:, q_len:] = 0
        print(f"bwd {label}, recipe do = 0.01:")
        got, ref = backward(q2, k, v, out, lse, do, causal, kv_len, q_len)
        ok, errs = grads_held(got, ref, q_len, kv_len, GRAD_TOL)
        assert ok, (label, "recipe do", errs)
        del out, lse, do, got, ref
    torch.cuda.empty_cache()

    # The public op (padding, reshapes, autograd) against mha_reference
    # in f32 on the same bf16 inputs, at the verify recipe's shapes, under
    # a random upstream gradient. t_q == t_k wherever causal, where the
    # reference's bottom-right mask equals the kernels' top-left one.
    for tq, tkv, causal in [(2048, 2048, True), (512, 2048, False),
                            (300, 300, True)]:
        q = randn(1, 2, tq, 128).requires_grad_()
        k = randn(1, 2, tkv, 128).requires_grad_()
        v = randn(1, 2, tkv, 128).requires_grad_()
        do = randn(1, 2, tq, 128)
        out = attn.flash_attention(q, k, v, causal=causal)
        grads = torch.autograd.grad(out, (q, k, v), do)
        qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
        ref = attn.mha_reference(qf, kf, vf, causal=causal)
        ref_grads = torch.autograd.grad(ref, (qf, kf, vf), do.float())
        print(f"flash_attention vs mha_reference (f32) tq={tq} tk={tkv} "
              f"causal={causal}:")
        checks = [held("out", out, ref)] + [
            held(name, g, r)
            for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads)]
        assert all(ok for ok, _ in checks), (tq, tkv, causal)

    # Times at the slice's shape: b 2 x h 32 = bh 64, t 4096, d 128.
    bh, t, d = BATCH * 32, SEQ, 128
    scale = 1.0 / math.sqrt(d)
    q2, k, v, q = inputs(bh, t, t, d, t, t)
    do = randn(bh, t, d)
    out, lse = attn.flash_forward(q2, k, v, True, t)
    bwd_args = (q2, k, v, out, do, lse, scale, True, t, t)
    fwd_ms = cuda_ms(torch, lambda: attn.flash_forward(q2, k, v, True, t), 20)
    fwd_plain_ms = cuda_ms(
        torch, lambda: attn.flash_forward_plain(q2, k, v, True, t), 3)
    # The backward op is every launch of it, as the train step runs it
    # (outputs and dq's accumulator allocated, delta, the fused kernel,
    # dq's scale and cast): the same work as SDPA's backward share.
    bwd_ms = cuda_ms(torch, lambda: attn.flash_backward(*bwd_args), 10)
    delta, dq_acc = attn.flash_backward_pre(out, do)
    bwd_launch_ms = {
        "flash_bwd_pre": cuda_ms(
            torch, lambda: attn.flash_backward_pre(out, do), 20),
        "flash_bwd": cuda_ms(torch, lambda: attn.flash_backward_main(
            q2, k, v, do, lse, delta, dq_acc, True, t, t), 10),
        "flash_bwd_dq": cuda_ms(torch, lambda: attn.flash_backward_dq(
            dq_acc, q2.shape, scale), 20),
    }
    bwd_plain_ms = cuda_ms(
        torch, lambda: attn.flash_backward_plain(*bwd_args), 2)
    q4, k4, v4, do4 = (x.view(BATCH, 32, t, d) for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd_ms = cuda_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=True, scale=scale), 20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
    sdpa_fwd_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa(qg, kg, vg, is_causal=True, scale=scale), (qg, kg, vg), do4), 10)
    sdpa_bwd_ms = sdpa_fwd_bwd_ms - sdpa_fwd_ms
    # Two products of 2*d FLOP per unmasked pair forward, five backward;
    # each input read once and each output written once (the backward's
    # outputs dq, dk and dv in bf16).
    pairs = bh * valid_pairs(True, t, t)
    fwd_bound, fwd_by = bound_ms(4 * d * pairs, nbytes(q2, k, v, out, lse))
    bwd_bound, bwd_by = bound_ms(
        10 * d * pairs, nbytes(q2, k, v, out, do, lse) + 3 * nbytes(q2))
    print(f"flash_fwd {fwd_ms:.3f} ms (plain {fwd_plain_ms:.2f}, sdpa "
          f"{sdpa_fwd_ms:.3f}, bound {fwd_bound:.3f} by {fwd_by})")
    print(f"flash_bwd op {bwd_ms:.3f} ms (launches "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in bwd_launch_ms.items())
          + f"; plain {bwd_plain_ms:.2f}, sdpa bwd {sdpa_bwd_ms:.3f}, "
          f"bound {bwd_bound:.3f} by {bwd_by})")
    del (q2, k, v, q, do, out, lse, bwd_args, delta, dq_acc, q4, k4, v4, do4,
         qg, kg, vg)
    torch.cuda.empty_cache()

    # ---- (c) the slice ------------------------------------------------
    # A small bf16 model first: flash against reference attention on
    # the same weights.
    small = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              max_seq_len=256, dtype=bf16)
    m_flash = llama.init_params(small, gen, device=dev)
    m_ref = llama.Llama(dataclasses.replace(small, attention="reference"),
                        device=dev)
    m_ref.load_state_dict(m_flash.state_dict())
    toks = torch.randint(0, small.vocab_size, (2, 200), generator=gen,
                         device=dev)
    with torch.no_grad():
        lf = llama.forward(m_flash, toks)
        lr = llama.forward(m_ref, toks)
    assert lf.shape == (2, 200, small.vocab_size) and torch.isfinite(lf).all()
    e_logits = max_err(lf, lr)
    print(f"small model logits, flash vs reference: err {e_logits:.3g}")
    assert e_logits <= LOGITS_TOL, e_logits
    del m_flash, m_ref, lf, lr

    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    model = llama.init_params(cfg, gen, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=gen,
                          device=dev)
    tokens, targets = batch[:, :-1], batch[:, 1:]
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=3e-4, total_steps=20),
        device=dev)
    state = init_fn(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    losses, norms, step_s = [], [], []
    attn.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens, targets)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    launches = dict(attn.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    print("losses", [round(x, 4) for x in losses])
    print("grad norms", [round(x, 4) for x in norms])
    assert all(math.isfinite(x) for x in losses + norms), losses
    assert losses[-1] < losses[0], losses
    assert launches["flash_fwd"] == TRAIN_STEPS * n_layers * 2, launches
    for name in BWD_LAUNCHES:
        assert launches[name] == TRAIN_STEPS * n_layers, launches
    steady = statistics.median(step_s[1:])
    tokens_per_s = BATCH * SEQ / steady
    mfu = llama.flops_per_token(cfg, SEQ) * tokens_per_s / PEAK_BF16_FLOPS

    if args.profile:
        profile = profile_step(
            torch, lambda: step_fn(state, tokens, targets))
        print(json.dumps({"profile": profile}))

    kernels = [
        {
            "name": "flash_fwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/attention.py:136",
            "launches": launches["flash_fwd"],
            "max_abs_err": results[("fwd", "main")][0],
            "lse_max_abs_err": results[("fwd", "main")][1],
            "ms": fwd_ms, "plain_ms": fwd_plain_ms,
            "bound_ms": fwd_bound, "bound_by": fwd_by,
            "library_ms": sdpa_fwd_ms,
            "bound_share": fwd_bound / fwd_ms,
            "vs_library": fwd_ms / sdpa_fwd_ms,
            "shape": [bh, t, d], "causal": True,
        },
        {
            # The op: its three launches, timed together (`ms`) and one
            # by one (`launch_ms`); `launches` counts the fused kernel.
            "name": "flash_bwd", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "ray_tpu/ops/attention.py:302",
            "launches": launches["flash_bwd"],
            "launches_by_kernel": {n: launches[n] for n in BWD_LAUNCHES},
            "max_abs_err": results[("bwd", "main")],
            "ms": bwd_ms, "launch_ms": bwd_launch_ms,
            "kernel_ms": bwd_launch_ms["flash_bwd"],
            "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_bound, "bound_by": bwd_by,
            # The backward share of one SDPA forward+backward.
            "library_ms": sdpa_bwd_ms,
            "library_fwd_bwd_ms": sdpa_fwd_bwd_ms,
            "bound_share": bwd_bound / bwd_ms,
            "vs_library": bwd_ms / sdpa_bwd_ms,
            "shape": [bh, t, d], "causal": True,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"slice": {
        "config": f"llama2_7b width, {n_layers} layers, bf16, flash, "
                  "remat full",
        "batch": BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "grad_norms": norms,
        "step_ms": [s * 1e3 for s in step_s],
        "steady_step_ms": steady * 1e3, "tokens_per_s": tokens_per_s,
        "mfu": mfu, "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
        "max_memory_allocated": peak_bytes,
        "memory_allocated_at_start": start_bytes, "launches": launches,
        "card": card,
    }}))
    if args.against:
        del model, state, batch, tokens, targets, step_fn, init_fn
        torch.cuda.empty_cache()
        print(json.dumps({"against": against(
            torch, attn, args.against, randn, n_layers)}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
