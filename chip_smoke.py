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
  (f) after (c) has freed its memory: (f1) the slice's model (same
      width and depth, batch 2 x 4096, bf16, flash) from one set of
      weights and one batch, 4 steps under each remat policy ("full",
      "dots", "dots_flash"). The step-1 losses must agree to
      REMAT_LOSS_REL and grad norms to REMAT_GNORM_REL, every step's
      loss to "full"'s to MESH_LOSS_REL, the loss must
      fall under each, and the counters must show 2 forward launches
      per layer per step under "full" and "dots", 1 under "dots_flash",
      and one backward op (3 launches) per layer per step under all
      three. (f2) `bench.py`'s mesh path: a NCCL world of one rank made
      by the port's backend, `MeshSpec(fsdp=1).build("cuda")`, and
      `make_train_step(loss, optimizer, mesh, param_annotations(cfg))`
      with `shard_batch` under "dots_flash" on the same weights and
      batch, 4 steps: the parameters must be DTensors on the CUDA mesh,
      the backend nccl, and the losses (f1)'s "dots_flash" ones to
      MESH_LOSS_REL; `prefetch_to_device` puts 3 host batches on the
      mesh through pinned memory and a side stream, unchanged. (f3) a `TorchTrainer` fit (`num_workers=1`) at the
      small width of (c)'s small model saves an async checkpoint every 2
      of 6 steps keeping 2: both kept directories hold `metadata.json`
      after the fit, and the newest restores bit for bit; three more
      saves, each after the last one's write, time the snapshot with
      the writer idle.
  (e) serving, after (c) has freed its model and optimizer: (e1) at a
      small width in f32 (vocab 512, dim 256, 2 layers, 4 heads on 2 KV
      heads), 6 greedy requests through the engine (slots 4, max_len
      256, prefill_chunk 32, prefix cache on; two share a prefix, one
      arrives while another decodes) must equal `generate` token for
      token. (e2) Llama-2-7B (`LlamaConfig.llama2_7b()`, 32 layers by
      `--serve-layers`, bf16, random init from the seeded generator),
      2 prompts of 1024 tokens: `prefill` and 16 `decode_step`s on the
      contiguous cache, and `paged_prefill` in 256-token chunks and 16
      `paged_decode_step`s on a scrambled block pool. Each step's
      logits are held to teacher-forced logits at the same positions of
      the f32 `llama.forward` of the same weights: max abs and relative
      L2 error each at most NOISE_RATIO x those of the bf16
      `llama.forward`. Held to the next position's, they must fall
      outside. (e3) the server on
      the same model: `EngineConfig(slots=8, max_len=2048,
      prefill_chunk=256, prefix_cache=True)`, 16 requests of a shared
      512-token system prefix and a seeded random tail of 64-1024
      tokens, 64 new tokens each, greedy, all submitted at once and each
      stream consumed on its own thread. Every request must end with
      "length", the prefix cache must hit, and the flash launch counters
      must not move while the engine serves. Greedy consistency: each
      served token's teacher-forced (bf16) logit is within delta (3x
      the largest error of (e2)'s logits against the bf16 forward) of
      its row's maximum; held to the
      next position's logits (the control) not every token may be.

Prints `{"kernels": [...]}` (with each kernel's launches under each
remat policy and in the mesh step), then `{"slice": {...}}`, then
`{"serve": {...}}` (the card, TTFT and inter-token gap p50/p99, decode
tokens/s and step ms at a full batch beside its bound, prefill
tokens/s, prefix hits and tokens saved, pool bytes, peak memory of
phase (e)), then `{"train_sharded": {...}}` (the card; step ms,
tokens/s, MFU, peak memory, losses and launches of each (f1) policy
and of (f2); (f3)'s checkpoints and `ckpt_block_ms`), and as the last
line `{"ok": true, "device": {...}}`. Exits non-zero with no result
line when there is no CUDA card or the port is not beside it.

`--profile` traces one more step with torch.profiler after the slice
and prints `{"profile": ...}`: device time by kernel, and idle share.
It traces one more step of each (f1) policy and of (f2) too, into
their records in `{"train_sharded": ...}`.
It also traces one paged decode step at the full batch and one prefill
chunk of the serving model, into the `{"serve": ...}` record's
"profile".

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
#: Bar of the serving phase's bf16 logits, against the f32 forward of
#: the same weights: at most this many times the error of the bf16
#: `llama.forward` itself. A flat REL_TOL does not fit bf16 logits: the
#: bf16 forward itself lies about 1% (relative L2) from the f32 one, and
#: the serving path's bf16 arithmetic as far.
NOISE_RATIO = 2.0

#: Device-side names of every launch of the two attention ops.
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_pre_kernel",
                 "flash_bwd_kernel", "flash_bwd_dq_kernel")
#: The backward op's launches, by launch counter.
BWD_LAUNCHES = ("flash_bwd_pre", "flash_bwd", "flash_bwd_dq")

TRAIN_STEPS = 8
N_LAYERS = 4
#: Phase (f): steps per remat policy, and the policies.
REMAT_STEPS = 4
REMAT_POLICIES = ("full", "dots", "dots_flash")
#: (f1) The three policies run one forward on the same weights and
#: batch, so their step-1 losses agree to the bit; the bar only absorbs
#: printing. Their backward differs in what it recomputes, and the
#: flash backward's dq sums in f32 in no fixed order, so a few bf16
#: gradient elements may round the other way: the step-1 grad norms
#: read within 4e-6 of each other (PERF.md), and the bar leaves 12x.
REMAT_LOSS_REL = 1e-6
REMAT_GNORM_REL = 5e-5
#: (f1) every step's loss under "dots" and "dots_flash" against "full",
#: and (f2) the mesh step's against (f1)'s dots_flash: step 1 is the same
#: computation on the same inputs (FSDP2 over one rank gathers and
#: reduces nothing); from step 2 on, updates of at most 3e-4 per element
#: (lr under warmup) may differ where a gradient rounds the other way,
#: which moved the step-4 loss by at most 3.0e-4 relative (PERF.md). A
#: wrong gradient in one layer moves that layer's whole update, and the
#: loss falls by 40% over these steps.
MESH_LOSS_REL = 1e-3
SERVE_LAYERS = 32
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
    err, ref_max, rel_l2 = rel_errors(got, ref)
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
        # Trees before the op's `torch.library` registration carry it
        # as an autograd Function.
        op = getattr(tree, "flash_attention_bhsd", None) or (
            tree.FlashAttentionFunction.apply)
        o = op(*leaves, scale, True, t, t)
        bwd[name] = lambda o=o, leaves=leaves: torch.autograd.grad(
            o, leaves, do, retain_graph=True)
        print(f"against, {name} tree, held to this tree's plain versions:")
        checks = [held("out", out, ref_out)] + [
            held(n, g, r)
            for n, g, r in zip(("dq", "dk", "dv"), bwd[name](), ref_grads)]
        errors[name] = {"out": checks[0][1], "lse": max_err(lse, ref_lse),
                        "grads": [e for _, e in checks[1:]],
                        "within_bars": all(ok for ok, _ in checks)}
        del out, lse, o, op, leaves
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


def rel_errors(got, ref):
    """(max abs error, max|ref|, relative L2 error) of `got` against
    `ref`, in f32."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    return (diff.abs().max().item(), ref.abs().max().item(),
            (diff.norm() / ref.norm()).item())


def percentile(xs, q):
    """The q-th percentile (0-100) of `xs`, nearest rank."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def held_steps(name, got, teacher, truth):
    """Hold each step of `got` [b, steps, vocab] (bf16 serving logits) to
    `truth`, the f32 forward of the same weights at the same positions:
    its max abs error and relative L2 error must each be at most
    NOISE_RATIO times the bf16 `teacher`'s own over all the steps. As a
    control that must fail, each step but the last is held to `truth`
    one position later. Returns the max abs error against `teacher`."""
    steps = got.shape[1]
    floor_err, _, floor_l2 = rel_errors(teacher, truth)

    def ok(e):
        return e[0] <= NOISE_RATIO * floor_err and e[2] <= NOISE_RATIO * floor_l2

    errors = [rel_errors(got[:, i], truth[:, i]) for i in range(steps)]
    shifted = [rel_errors(got[:, i], truth[:, i + 1]) for i in range(steps - 1)]
    to_teacher = rel_errors(got, teacher)
    print(f"  {name}, {steps} steps against the f32 forward: max err up to "
          f"{max(e[0] for e in errors):.4g} (max|ref| "
          f"{max(e[1] for e in errors):.4g}), rel L2 up to "
          f"{max(e[2] for e in errors):.4g}; bf16 forward's own: max err "
          f"{floor_err:.4g}, rel L2 {floor_l2:.4g}; against the bf16 forward: "
          f"max err {to_teacher[0]:.4g}, rel L2 {to_teacher[2]:.4g}; shifted "
          f"one position (must be outside the bars): rel L2 from "
          f"{min(e[2] for e in shifted):.4g}")
    assert all(ok(e) for e in errors), (name, errors, floor_err, floor_l2)
    assert not any(ok(e) for e in shifted), (name, "control", shifted)
    return to_teacher[0]


def serve_phase(torch, llama, attn, card, n_layers, dev, profile=False):
    """Phase (e), the serving slice (see the module's doc), on device
    `dev`. Returns the `{"serve": ...}` record."""
    import threading

    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.models import generate as gen

    g = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()

    def prompt(n):
        return torch.randint(0, 512, (n,), generator=g, device=dev).tolist()

    # (e1) f32 at a small width: the engine equals `generate` exactly.
    small = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              max_seq_len=256, dtype=torch.float32,
                              remat=False)
    m_small = llama.init_params(small, g, device=dev)
    shared = prompt(64)
    prompts = [shared + prompt(23), shared + prompt(50), prompt(20),
               prompt(97), prompt(41), prompt(130)]
    eng = InferenceEngine(m_small, small, EngineConfig(
        slots=4, max_len=256, prefill_chunk=32, prefix_cache=True,
        max_new_tokens=24))
    try:
        streams = [eng.submit(p) for p in prompts[:5]]
        first = next(streams[0])  # request 0 decodes ...
        streams.append(eng.submit(prompts[5]))  # ... when this one arrives
        outs = [[first] + list(streams[0])] + [list(s) for s in streams[1:]]
        small_stats = eng.stats()
    finally:
        eng.close()
    for p, out in zip(prompts, outs):
        want, _ = gen.generate(m_small, torch.tensor([p], device=dev),
                               torch.tensor([len(p)], device=dev), small,
                               max_new_tokens=24)
        assert out == want[0].tolist(), (len(p), out, want[0].tolist())
    assert small_stats["prefix_hits"] >= 1, small_stats
    print(f"serve (e1), f32 small width: 6 requests through the engine equal "
          f"generate token for token; prefix hits "
          f"{small_stats['prefix_hits']}")
    del m_small, eng

    # (e2) full width, bf16: cached and paged logits against
    # teacher-forced `llama.forward`.
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, remat=False)
    model = llama.init_params(cfg, g, device=dev)
    b, t, steps, chunk, bl = 2, 1024, 16, 256, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev)

    # The f32 model of the same weights gives the truth both bf16 paths
    # are held to.
    m32 = llama.Llama(dataclasses.replace(cfg, dtype=torch.float32,
                                          attention="reference"), device=dev)
    m32.load_state_dict(model.state_dict())

    def teacher(seq, m=model):
        with torch.no_grad():
            return llama.forward(m, seq)

    def forced(seq):
        """(bf16, f32) teacher-forced logits of the last steps + 1."""
        return (teacher(seq)[:, t - 1:], teacher(seq, m32)[:, t - 1:])

    cache = gen.init_kv_cache(cfg, b, t + steps, device=dev)
    logits, cache = gen.prefill(model, cfg, tokens, cache, 0, t)
    got, seq = [logits[:, -1]], tokens
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    for i in range(steps):
        tok, cache, last = gen.decode_step(model, cfg, cache, got[-1], t + i,
                                           alive)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        got.append(last)
    del cache, logits
    print(f"serve (e2), {cfg.n_layers} layers bf16, batch {b} x {t} + {steps} "
          "steps, against teacher-forced llama.forward:")
    err_cached = held_steps("prefill + decode_step", torch.stack(got, 1),
                            *forced(seq))
    nb = (t + steps) // bl
    order = torch.randperm(b * nb, generator=g, device=dev) + 1
    tables = order.view(b, nb)
    pool = gen.init_block_pool(cfg, b * nb + 1, bl, device=dev)
    for off in range(0, t, chunk):
        logits, pool = gen.paged_prefill(model, cfg, tokens[:, off:off + chunk],
                                         pool, tables, off, off + chunk)
    got, seq = [logits[:, -1]], tokens
    for i in range(steps):
        tok, pool, last = gen.paged_decode_step(
            model, cfg, pool, tables, got[-1],
            torch.full((b,), t + i, device=dev), alive)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        got.append(last)
    err_paged = held_steps("paged_prefill + paged_decode_step",
                           torch.stack(got, 1), *forced(seq))
    del pool, logits, got, seq, tokens, m32
    torch.cuda.empty_cache()
    # A served token's teacher-forced logit is at most 2 x this error
    # below its row's maximum (each of the two logits moves by at most
    # the error); x1.5 for the server's longer sequences.
    delta = 3.0 * max(err_cached, err_paged)

    # (e3) the server: 16 requests sharing a 512-token system prefix.
    ec = EngineConfig(slots=8, max_len=2048, prefill_chunk=256,
                      prefix_cache=True, max_new_tokens=64)
    system = torch.randint(0, cfg.vocab_size, (512,), generator=g,
                           device=dev).tolist()
    tails = torch.randint(64, 1025, (16,), generator=g, device=dev).tolist()
    requests = [system + torch.randint(0, cfg.vocab_size, (n,), generator=g,
                                       device=dev).tolist() for n in tails]
    eng = InferenceEngine(model, cfg, ec, family="llama2_7b")
    outs = [[] for _ in requests]
    arrivals = [[] for _ in requests]
    try:
        attn.reset_launch_counts()
        t0 = time.perf_counter()
        streams = [eng.submit(p) for p in requests]

        def consume(i):
            for tok in streams[i]:
                arrivals[i].append(time.perf_counter())
                outs[i].append(tok)

        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(len(streams))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall_s = time.perf_counter() - t0
        serve_launches = dict(attn.LAUNCHES)
        stats = eng.stats()
    finally:
        eng.close()
    reasons = [s.finish_reason for s in streams]
    assert reasons == ["length"] * len(streams), reasons
    assert all(len(o) == ec.max_new_tokens for o in outs)
    assert stats["prefix_hits"] >= 1, stats
    assert not any(serve_launches.values()), serve_launches

    # Greedy consistency against teacher-forced logits (these launch the
    # forward kernel: the counters were read above). The control holds
    # each token to the logits one position later, and must fail.
    n = exact = consistent = control = 0
    worst_gap = 0.0
    for p, out in zip(requests, outs):
        seq = torch.tensor([p + out[:-1]], device=dev)
        ref = teacher(seq)[0, len(p) - 1:]  # the logits each token came from
        toks = torch.tensor(out, device=dev)
        top = ref.max(dim=-1).values
        gap = top - ref.gather(1, toks[:, None])[:, 0]
        shifted = top[1:] - ref[1:].gather(1, toks[:-1, None])[:, 0]
        n += len(out)
        exact += int((ref.argmax(-1) == toks).sum())
        consistent += int((gap <= delta).sum())
        control += int((shifted <= delta).sum())
        worst_gap = max(worst_gap, gap.max().item())
        del seq, ref
    print(f"serve (e3): greedy consistency, delta {delta:.4g}: {consistent} of "
          f"{n} tokens within delta of their row's maximum (largest gap "
          f"{worst_gap:.4g}), exact argmax {exact} of {n} (no bar); control, "
          f"tokens against the next position's logits: {control} of "
          f"{n - len(requests)} within delta (must not be all)")
    assert consistent == n, (consistent, n, worst_gap, delta)
    assert control < n - len(requests), control

    ttft = [(a[0] - t0) * 1e3 for a in arrivals]  # all submitted at t0
    gaps = [(y - x) * 1e3 for a in arrivals for x, y in zip(a, a[1:])]
    full = stats["decode_by_batch"].get(ec.slots, {"steps": 0, "ms": 0.0})
    decode_ms = sum(r["ms"] for r in stats["decode_by_batch"].values())
    step_ms_full = full["ms"] / full["steps"] if full["steps"] else None
    # The decode bound at a full batch: the weights and the live KV of
    # 8 rows read once, at the run's mean live length.
    kv_per_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    mean_live = (sum(len(p) for p in requests) / len(requests)
                 + ec.max_new_tokens / 2)
    weight_bytes = cfg.num_params() * 2
    bound = (weight_bytes + ec.slots * mean_live * kv_per_token) / HBM_BYTES_PER_S
    serve = {
        "card": card,
        "config": f"llama2_7b, {cfg.n_layers} layers, bf16, random init",
        "engine": dataclasses.asdict(ec),
        "requests": len(requests), "prompt_tokens": [len(p) for p in requests],
        "new_tokens": ec.max_new_tokens, "wall_s": wall_s,
        "ttft_ms_p50": percentile(ttft, 50), "ttft_ms_p99": percentile(ttft, 99),
        "itl_ms_p50": percentile(gaps, 50), "itl_ms_p99": percentile(gaps, 99),
        "decode_tokens_per_s": stats["tokens_emitted"] / (decode_ms / 1e3),
        "decode_step_ms_full_batch": step_ms_full,
        "decode_steps_full_batch": full["steps"],
        "decode_by_batch": stats["decode_by_batch"],
        "decode_bound_ms_full_batch": bound * 1e3,
        "decode_bound_mean_live_tokens": mean_live,
        "prefill_tokens_per_s": stats["prefill_tokens"] / (stats["prefill_ms"] / 1e3),
        "prefill_chunks": stats["prefill_chunks"],
        "prefix_hits": stats["prefix_hits"],
        "prefix_tokens_saved": stats["prefix_tokens_saved"],
        "pool_bytes": stats["kv_bytes"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "logits_max_err": {"cached": err_cached, "paged": err_paged},
        "delta": delta, "exact_argmax_share": exact / n,
        "flash_launches_while_serving": serve_launches,
    }
    print(f"serve (e3): {len(requests)} requests in {wall_s:.2f} s; decode "
          f"step at batch {ec.slots} {step_ms_full} ms (bound "
          f"{bound * 1e3:.3f} ms); TTFT p50 {serve['ttft_ms_p50']:.1f} ms")
    del eng
    if profile:
        serve["profile"] = profile_serving(torch, gen, model, cfg, ec,
                                           round(mean_live), dev)
    del model
    torch.cuda.empty_cache()
    return serve


def remat_runs(torch, llama, attn, cfg, init_state, batch, dev,
               profile=False):
    """(f1): `REMAT_STEPS` single-device steps under each policy from the
    same weights and batch. Returns {policy: record}."""
    from ray_tpu_torch.train import default_optimizer, make_train_step

    runs = {}
    for policy in REMAT_POLICIES:
        c = dataclasses.replace(cfg, remat_policy=policy)
        model = llama.Llama(c, device=dev)
        model.load_state_dict(init_state)
        init_fn, step_fn = make_train_step(
            llama.loss_fn,
            default_optimizer(learning_rate=3e-4, total_steps=20), device=dev)
        state = init_fn(model)
        runs[policy] = train_steps(torch, llama, attn, c, state, step_fn,
                                   batch[:, :-1], batch[:, 1:], profile)
        del model, state, step_fn, init_fn
        torch.cuda.empty_cache()
    return runs


def train_steps(torch, llama, attn, cfg, state, step_fn, tokens, targets,
                profile=False):
    """`REMAT_STEPS` steps, timed by the host clock around a synchronise,
    with the launch counters zeroed just before them and read just
    after, and the peak memory of the steps; with `profile`, one more
    step traced by `profile_step`."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    attn.reset_launch_counts()
    for _ in range(REMAT_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, tokens, targets)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    launches = dict(attn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(step_s[1:])
    n_tokens = tokens.shape[0] * tokens.shape[1]
    tokens_per_s = n_tokens / steady
    traced = {}
    if profile:
        traced["profile"] = profile_step(
            torch, lambda: step_fn(state, tokens, targets))
    return {**traced,
        "losses": losses, "grad_norms": norms,
        "step_ms": [x * 1e3 for x in step_s], "steady_step_ms": steady * 1e3,
        "tokens_per_s": tokens_per_s,
        "mfu": llama.flops_per_token(cfg, tokens.shape[1]) * tokens_per_s
        / PEAK_BF16_FLOPS,
        "max_memory_allocated": peak,
        "launches": launches,
    }


def rel(a, b):
    return abs(a - b) / abs(b)


def mesh_run(torch, llama, attn, cfg, init_state, batch, dev, profile=False):
    """(f2): the flagship's mesh path, `bench.py`'s `make_train_step(loss,
    optimizer, mesh, param_annotations(cfg))` over `MeshSpec(fsdp=1)`, on
    a NCCL world of one rank made by the port's backend."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import (
        default_optimizer,
        init_torch_distributed,
        make_train_step,
        prefetch_to_device,
        shard_batch,
    )
    from ray_tpu_torch.train.backend import free_port

    init_torch_distributed(0, 1, f"localhost:{free_port()}", device=dev)
    try:
        backend = dist.get_backend()
        mesh = MeshSpec(fsdp=1).build(dev)
        model = llama.Llama(cfg, device=dev)
        model.load_state_dict(init_state)
        init_fn, step_fn = make_train_step(
            llama.loss_fn, default_optimizer(learning_rate=3e-4,
                                             total_steps=20),
            mesh, llama.param_annotations(cfg))
        state = init_fn(model)
        params = list(model.parameters())
        on_mesh = all(isinstance(p, DTensor) and p.device_mesh.device_type
                      == "cuda" and p.to_local().is_cuda for p in params)
        record = train_steps(torch, llama, attn, cfg, state, step_fn,
                             shard_batch(batch[:, :-1], mesh),
                             shard_batch(batch[:, 1:], mesh), profile)
        # The prefetcher's pinned side-stream copies onto the same mesh.
        host = [batch.cpu() + i for i in range(3)]
        fetched = list(prefetch_to_device(iter(host), mesh,
                                          logical_axes=("batch", None)))
        prefetched = all(isinstance(b, DTensor) and torch.equal(
            b.to_local().cpu(), h) for b, h in zip(fetched, host))
        record.update({"backend": backend, "params_are_dtensors": on_mesh,
                       "prefetch_equal": prefetched and len(fetched) == 3,
                       "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))})
        del model, state, step_fn, init_fn, params
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return record


def trainer_run(torch, llama, dev):
    """(f3): a `TorchTrainer` fit at phase (c)'s small width that saves
    an async checkpoint every 2 of 6 steps through a `CheckpointManager`
    keeping 2; then the newest is restored into a fresh state."""
    import shutil

    from ray_tpu_torch._private import step_telemetry
    from ray_tpu_torch.train import (
        CheckpointManager,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
        default_optimizer,
        make_train_step,
        pending_checkpoints,
        report,
        restore_checkpoint,
        save_checkpoint,
        wait_for_checkpoints,
    )

    small = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2,
                              n_heads=4, n_kv_heads=2, intermediate=512,
                              max_seq_len=256, dtype=torch.bfloat16)
    storage = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_trainer")
    shutil.rmtree(storage, ignore_errors=True)
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, small.vocab_size, (4, 129), generator=g,
                         device=dev)
    init = {k: v.clone() for k, v in
            llama.init_params(small, g, device=dev).state_dict().items()}
    saved, block_ms, save_ms, in_flight = {}, [], [], []

    def make_state():
        model = llama.Llama(small, device=dev)
        model.load_state_dict(init)
        init_fn, step_fn = make_train_step(
            llama.loss_fn, default_optimizer(learning_rate=1e-3,
                                             total_steps=20), device=dev)
        return init_fn(model), step_fn

    def loop():
        state, step_fn = make_state()
        mgr = CheckpointManager(os.path.join(storage, "checkpoints"),
                                num_to_keep=2)
        for step in range(1, 7):
            state, metrics = step_fn(state, toks[:, :-1], toks[:, 1:])
            loss = metrics["loss"].item()
            path = None
            if step % 2 == 0:
                step_telemetry.take_phases()
                in_flight.append(len(pending_checkpoints()))
                t0 = time.perf_counter()
                path = mgr.save(step, state.state_dict(), {"loss": loss},
                                async_save=True)
                # The snapshot, as save_checkpoint bills it; the call's
                # wall also waits for the write it retires (keep 2).
                save_ms.append((time.perf_counter() - t0) * 1e3)
                block_ms.append(step_telemetry.take_phases()["ckpt_block_ms"])
                saved[path] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in flat(state.state_dict())}
            report({"step": step, "loss": loss}, checkpoint=path)

    try:
        result = TorchTrainer(loop, scaling_config=ScalingConfig(num_workers=1),
                              run_config=RunConfig(storage_path=storage)).fit()
        assert result.error is None, result.error
        root = os.path.join(storage, "checkpoints")
        kept = sorted(os.listdir(root))
        durable = all(os.path.exists(os.path.join(root, d, "metadata.json"))
                      for d in kept)
        fresh, _ = make_state()
        restored = restore_checkpoint(result.checkpoint_path,
                                      fresh.state_dict())
        want = saved[result.checkpoint_path]
        got = dict(flat(restored))
        bitwise = set(got) == set(want) and all(
            torch.equal(got[k], want[k]) if torch.is_tensor(want[k])
            else got[k] == want[k] for k in want)
        # The same snapshot with no write running beside it: each save
        # here waits for its own write before the next.
        idle_ms = []
        for i in range(3):
            step_telemetry.take_phases()
            save_checkpoint(os.path.join(storage, f"idle_{i}"),
                            fresh.state_dict(), async_save=True)
            idle_ms.append(step_telemetry.take_phases()["ckpt_block_ms"])
            wait_for_checkpoints()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    record = {
        "config": "vocab 512, dim 256, 2 layers, 4 heads / 2 KV, bf16",
        "steps": len(result.metrics_history), "kept": kept,
        "metadata_in_every_kept": durable,
        "checkpoint_path": os.path.basename(result.checkpoint_path),
        "restored_bitwise": bitwise, "tensors": len(want),
        "ckpt_block_ms": block_ms, "manager_save_ms": save_ms,
        "writes_in_flight_at_save": in_flight,
        "ckpt_block_ms_writer_idle": idle_ms,
    }
    print(f"(f3) trainer: {record['steps']} steps, kept {kept}, metadata "
          f"in every kept: {durable}, restored bit for bit: {bitwise}, "
          f"ckpt_block_ms {[round(x, 2) for x in block_ms]} (writes in "
          f"flight {in_flight}), manager.save wall "
          f"{[round(x, 2) for x in save_ms]} ms; with the writer idle "
          f"{[round(x, 2) for x in idle_ms]} ms")
    assert kept == ["checkpoint_00000004", "checkpoint_00000006"], kept
    assert durable and bitwise, record
    return record


def flat(tree, prefix=""):
    """(dotted key, leaf) pairs of nested dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def train_sharded_phase(torch, llama, attn, card, n_layers, dev,
                        profile=False):
    """Phase (f), after (c) has freed its memory (see the module's doc).
    Returns the `{"train_sharded": ...}` record."""
    cfg = llama.LlamaConfig.llama2_7b(n_layers=n_layers, max_seq_len=SEQ)
    g = torch.Generator(device=dev).manual_seed(2)
    init_state = {k: v.clone() for k, v in
                  llama.init_params(cfg, g, device=dev).state_dict().items()}
    batch = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1), generator=g,
                          device=dev)
    torch.cuda.empty_cache()
    runs = remat_runs(torch, llama, attn, cfg, init_state, batch, dev,
                      profile)
    full = runs["full"]
    for policy, r in runs.items():
        r["loss_rel_to_full"] = [rel(a, b) for a, b in
                                 zip(r["losses"], full["losses"])]
        r["grad_norm_rel_to_full"] = rel(r["grad_norms"][0],
                                         full["grad_norms"][0])
        print(f"(f1) remat {policy}: losses {[round(x, 5) for x in r['losses']]}"
              f" (relative to full: "
              f"{[f'{d:.2e}' for d in r['loss_rel_to_full']]}; step-1 grad "
              f"norm {r['grad_norm_rel_to_full']:.2e})"
              f", grad norms {[round(x, 5) for x in r['grad_norms']]}, step "
              f"{r['steady_step_ms']:.2f} ms, {r['tokens_per_s']:.0f} tokens/s"
              f", MFU {r['mfu']:.4f}, peak {r['max_memory_allocated']} B, "
              f"launches {r['launches']}")
        if "profile" in r:
            prof = r["profile"]
            print(f"(f1) remat {policy}, traced step: device busy "
                  f"{prof['device_busy_ms']:.2f} ms of {prof['wall_ms']:.2f}, "
                  f"by group {prof['groups_ms']}")
    for policy, r in runs.items():
        assert all(math.isfinite(x) for x in r["losses"] + r["grad_norms"])
        assert r["losses"][-1] < r["losses"][0], (policy, r["losses"])
        assert rel(r["losses"][0], full["losses"][0]) <= REMAT_LOSS_REL, policy
        assert rel(r["grad_norms"][0], full["grad_norms"][0]) <= \
            REMAT_GNORM_REL, policy
        assert all(d <= MESH_LOSS_REL for d in r["loss_rel_to_full"]), (
            policy, r["loss_rel_to_full"])
        fwd_per_layer = 1 if policy == "dots_flash" else 2
        assert r["launches"]["flash_fwd"] == \
            REMAT_STEPS * n_layers * fwd_per_layer, (policy, r["launches"])
        for name in BWD_LAUNCHES:
            assert r["launches"][name] == REMAT_STEPS * n_layers, (
                policy, r["launches"])

    mesh = mesh_run(torch, llama, attn,
                    dataclasses.replace(cfg, remat_policy="dots_flash"),
                    init_state, batch, dev, profile)
    ref = runs["dots_flash"]
    diffs = [rel(a, b) for a, b in zip(mesh["losses"], ref["losses"])]
    print(f"(f2) MeshSpec(fsdp=1) on {mesh['backend']}: losses "
          f"{[round(x, 5) for x in mesh['losses']]} (relative to (f1) "
          f"dots_flash: {[f'{d:.2e}' for d in diffs]}), step "
          f"{mesh['steady_step_ms']:.2f} ms against {ref['steady_step_ms']:.2f}"
          f" ms, params DTensors on CUDA: {mesh['params_are_dtensors']}, "
          f"prefetched batches equal: {mesh['prefetch_equal']}, "
          f"launches {mesh['launches']}")
    assert mesh["backend"] == "nccl" and mesh["params_are_dtensors"], mesh
    assert mesh["prefetch_equal"], mesh
    assert all(d <= MESH_LOSS_REL for d in diffs), diffs
    assert mesh["launches"]["flash_fwd"] == REMAT_STEPS * n_layers, mesh
    del init_state, batch
    torch.cuda.empty_cache()

    trainer = trainer_run(torch, llama, dev)
    return {
        "card": card,
        "config": f"llama2_7b width, {n_layers} layers, bf16, flash",
        "batch": BATCH, "seq": SEQ, "steps": REMAT_STEPS,
        "bars": {"remat_loss_rel": REMAT_LOSS_REL,
                 "remat_grad_norm_rel": REMAT_GNORM_REL,
                 "mesh_loss_rel": MESH_LOSS_REL},
        "f1": {"policies": runs,
               "launches": {p: r["launches"] for p, r in runs.items()}},
        "f2": {**mesh, "loss_rel_to_f1": diffs,
               "f1_dots_flash_step_ms": ref["steady_step_ms"]},
        "f3": trainer,
    }


def profile_serving(torch, gen, model, cfg, ec, live, dev):
    """One paged decode step over a full batch whose rows hold `live`
    tokens each, and one prefill chunk, each timed by the host clock
    (mean of 5 after a warm-up) and then traced by `profile_step`."""
    nb = ec.max_len // 16
    pool = gen.init_block_pool(cfg, ec.slots * nb + 1, 16, device=dev)
    tables = torch.arange(1, ec.slots * nb + 1, device=dev).view(ec.slots, nb)
    last = torch.randn(ec.slots, cfg.vocab_size, device=dev)
    positions = torch.full((ec.slots,), live, device=dev)
    alive = torch.ones(ec.slots, dtype=torch.bool, device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, ec.prefill_chunk), device=dev)
    off = (live // ec.prefill_chunk) * ec.prefill_chunk
    runs = {
        "decode_step": lambda: gen.paged_decode_step(
            model, cfg, pool, tables, last, positions, alive),
        "prefill_chunk": lambda: gen.paged_prefill(
            model, cfg, chunk, pool, tables[:1], off, off + ec.prefill_chunk),
    }
    out = {"live_tokens": live, "prefill_offset": off}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        out[name] = {"host_clock_ms": (time.perf_counter() - t0) / 5 * 1e3,
                     **profile_step(torch, run)}
        print(f"serve profile, {name}: {out[name]['host_clock_ms']:.2f} ms, "
              f"device busy {out[name]['device_busy_ms']:.2f} ms of "
              f"{out[name]['wall_ms']:.2f} traced, idle share "
              f"{out[name]['idle_share']:.3f}")
    return out


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
    parser.add_argument(
        "--serve-layers", type=int, default=SERVE_LAYERS,
        help=f"depth of the serving phase's Llama-2-7B (default "
             f"{SERVE_LAYERS}, the full model)")
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
    del model, state, batch, tokens, targets, step_fn, init_fn
    torch.cuda.empty_cache()

    # ---- (f) remat policies, the mesh step, trainer and checkpoints ----
    sharded = train_sharded_phase(torch, llama, attn, card, n_layers, dev,
                                  args.profile)
    by_policy = sharded["f1"]["launches"]

    # ---- (e) serving ---------------------------------------------------
    serve = serve_phase(torch, llama, attn, card, args.serve_layers, dev,
                        args.profile)
    serve_launches = serve["flash_launches_while_serving"]

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
            "serve_launches": serve_launches["flash_fwd"],
            "launches_by_policy": {p: n["flash_fwd"]
                                   for p, n in by_policy.items()},
            "launches_mesh_step": sharded["f2"]["launches"]["flash_fwd"],
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
            "serve_launches": serve_launches["flash_bwd"],
            "launches_by_policy": {p: n["flash_bwd"]
                                   for p, n in by_policy.items()},
            "launches_mesh_step": sharded["f2"]["launches"]["flash_bwd"],
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
    print(json.dumps({"serve": serve}))
    print(json.dumps({"train_sharded": sharded}))
    if args.against:
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
