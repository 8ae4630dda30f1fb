#!/usr/bin/env python3
"""Ablations of the port's "any" flash kernels on one CUDA card.

Each variant is a copy of `ray_tpu_torch/` under
`build/ablation/<variant>/` with one named change to its `csrc/`
(VARIANTS), loaded beside this tree under a module name of its own (the
op registers under the package's name, so the copies coexist) and built
from its own sources; each tree's ptxas summary of the "wide" and the
backward kernels is printed (registers, spills, C75xx advisories). At
each shape of SHAPES (`--dtype`: those of one dtype) every tree's
`flash_forward` and `flash_backward` op are held to this tree's plain
version (printed, not held: a variant may trade precision on purpose)
and timed by CUDA events in turns (each tree, SDPA, then the same in
reverse), beside `scaled_dot_product_attention` (its backward share:
forward and backward less forward) and, with `--against ROOT`, the
`ray_tpu_torch` of another checkout at ROOT.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 kernel_ablation.py [--against ROOT] [--dtype DT] [VARIANT ...]

With no VARIANT it times every one. Prints the card's name and power
limit, then one line per shape and op: each tree's min / max over its
turns in ms. Copies stay under the gitignored `build/`.
"""

from __future__ import annotations

import argparse
import importlib.util
import math
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

#: variant -> (what it changes, [(file in csrc/, old text, new text)]).
VARIANTS = {
    "cvt_split": (
        "the TF32 split rounded by the cvt.rna.tf32.f32 instruction",
        [("hopper.cuh", "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
          "  return tf32_rna_cvt(x);")]),
    "convert_once": (
        "the f32 kernel's converter splits the first K and V tile only "
        "(wrong outputs: the consumers' time without the converter's)",
        [("flash_fwd_any.cu", "      split_k<D>(smem + C::k_off",
          "      if (j == 0) split_k<D>(smem + C::k_off"),
         ("flash_fwd_any.cu", "      split_vt<D>(smem + C::v_off",
          "      if (j == 0) split_vt<D>(smem + C::v_off")]),
    "wide_convert_once": (
        "the f32 wide forward's converter splits the first KV tile's K "
        "boxes and V^T only (wrong outputs: the time without its splits)",
        [("flash_fwd_any.cu",
          "        store_k_box(smem + L.k_off + s * 2 * K_SPLIT, cur, "
          "box_steps(h), tid);",
          "        if (j == 0) store_k_box(smem + L.k_off + s * 2 * K_SPLIT, "
          "cur, box_steps(h), tid);"),
         ("flash_fwd_any.cu", "      store_vt(smem + L.v_off, vi, cw, tid);",
          "      if (j == 0) store_vt(smem + L.v_off, vi, cw, tid);")]),
    "wide_s_one_term": (
        "the f32 wide forward's S in one TF32 term, hi*hi (wrong past the "
        "f32 bar: the S products' share)",
        [("flash_fwd_any.cu",
          "    wgmma_tf32(part, a_lo[kk], kmajor_desc(k_hi, BN, kk), kk > 0);\n"
          "    wgmma_tf32(part, a_hi[kk], kmajor_desc(k_lo, BN, kk), 1);\n"
          "    wgmma_tf32(part, a_hi[kk], kmajor_desc(k_hi, BN, kk), 1);\n"
          "  }\n  wgmma_commit();\n  wgmma_wait<0>();\n"
          "  fence_operands(part);\n#pragma unroll\n"
          "  for (int i = 0; i < BN / 2; ++i) sc[i] += part[i];",
          "    wgmma_tf32(part, a_hi[kk], kmajor_desc(k_hi, BN, kk), kk > 0);\n"
          "  }\n  wgmma_commit();\n  wgmma_wait<0>();\n"
          "  fence_operands(part);\n#pragma unroll\n"
          "  for (int i = 0; i < BN / 2; ++i) sc[i] += part[i];")]),
    "wide_q_global": (
        "the f32 wide forward reads Q2 from global memory (L2) at every d",
        [("flash_fwd_any.cu",
          "  L.q_resident = q_bytes + rest <= SMEM_MAX;",
          "  L.q_resident = false;")]),
    "head_by_head": (
        "both f32 wide kernels' blocks head by head (each head's tiles "
        "heaviest first) instead of heaviest first across all heads",
        [("flash_fwd_any.cu",
          "  const int bh = rest % gridDim.y;\n"
          "  const int q0 = (gridDim.x - 1 - rest / gridDim.y) * BM;",
          "  const int bh = rest / gridDim.x;\n"
          "  const int q0 = (gridDim.x - 1 - rest % gridDim.x) * BM;"),
         ("flash_bwd_any.cu",
          "  const int bh = rest % gridDim.y;\n"
          "  const int j0 = rest / gridDim.y * BK;",
          "  const int bh = rest / gridDim.x;\n"
          "  const int j0 = rest % gridDim.x * BK;")]),
    "bwd_no_dq": (
        "the f32 wide backward without dQ = dS K_c and its reductions "
        "(wrong dq: the time of the rest)",
        [("flash_bwd_any.cu", "      for (int hq = 0; hq < 2; ++hq) {",
          "      for (int hq = 0; hq < 0; ++hq) {")]),
    "bwd_one_term": (
        "the f32 wide backward's products in one TF32 term, hi*hi (wrong "
        "past the f32 bar: the tensor pipe's share)",
        [("hopper.cuh",
          "    for (int m = 0; m < M; ++m) mma_tf32(d[m][n], a_lo[m], b_hi[n]);",
          ""),
         ("hopper.cuh",
          "    for (int m = 0; m < M; ++m) mma_tf32(d[m][n], a_hi[m], b_lo[n]);",
          "")]),
    "bwd_no_stream": (
        "the f32 wide backward streams only its first q tile's slices, "
        "later tiles reuse them (wrong results: the time without the "
        "stream)",
        [("flash_bwd_any.cu",
          "      load_slice(smem + (nx & 1) * STAGE, s_stats",
          "      if (nx < ns) load_slice(smem + (nx & 1) * STAGE, s_stats")]),
    "any_f32_nt4": (
        "the f32 backward up to head_dim 256 with 32 columns a warp, as "
        "above 256 (the route before its warps shared a narrow chunk)",
        [("flash_bwd_any.cu",
          "  auto fn = cw <= 8 * WARPS       ? launch_nt<1>\n"
          "            : cw <= 16 * WARPS    ? launch_nt<2>\n"
          "                                  : launch_nt<4>;",
          "  auto fn = launch_nt<4>;")]),
    "wide16_s_pipelined": (
        "the 16-bit wide backward issues each box's S^T / dP^T products "
        "before waiting for the last box's",
        [("flash_bwd_any.cu",
          "      wgmma_commit();\n"
          "      wgmma_wait<0>();\n"
          "      fence_operands(st);\n"
          "      if (tid == 0) mbar_arrive(&empty[s]);\n"
          "      if (++s == STAGES) {\n"
          "        s = 0;\n"
          "        phase ^= 1;\n"
          "      }\n"
          "    }\n",
          "      wgmma_commit();\n"
          "      if (h > 0) {\n"
          "        wgmma_wait<1>();\n"
          "        if (tid == 0)\n"
          "          mbar_arrive(&empty[(s + STAGES - 1) % STAGES]);\n"
          "      }\n"
          "      if (++s == STAGES) {\n"
          "        s = 0;\n"
          "        phase ^= 1;\n"
          "      }\n"
          "    }\n"
          "    wgmma_wait<0>();\n"
          "    fence_operands(st);\n"
          "    if (tid == 0) mbar_arrive(&empty[(s + STAGES - 1) % STAGES]);\n")]),
    "wide16_ring2": (
        "the 16-bit wide backward's ring of box columns in 2 stages, not 3",
        [("flash_bwd_any.cu",
          "constexpr int STAGES = 3;               // the ring of box columns",
          "constexpr int STAGES = 2;               // the ring of box columns")]),
    "wide16_dq_whole": (
        "the 16-bit wide backward makes dQ_tile over both of a "
        "warpgroup's boxes in one product (64 registers a thread)",
        [("flash_bwd_any.cu", "    wg::tile_grads<T, MYB, W, NA, true>(",
          "    wg::tile_grads<T, MYB, W, NA, false>(")]),
    "wide16_no_dq": (
        "the 16-bit wide backward without dQ's reductions into dq_acc and "
        "its second box's product (wrong dq: the time of the rest)",
        [("flash_bwd_any.cu", "    wg::tile_grads<T, MYB, W, NA, true>(",
          "    wg::tile_grads<T, MYB, W, NA, true, false>("),
         ("flash_bwd_any.cu",
          "template <typename T, int MYB, int W, int NA, bool SPLIT_DQ = false>",
          "template <typename T, int MYB, int W, int NA, bool SPLIT_DQ = false,\n"
          "          bool DQ = true>"),
         ("flash_bwd_any.cu",
          "    for (int h0 = 0; h0 < MYB; h0 += DQB) {",
          "    for (int h0 = 0; h0 < (DQ ? MYB : 0); h0 += DQB) {")]),
    "no_split": (
        "every TF32 split skipped: hi the f32 bits as they are, lo 0 "
        "(wrong past the f32 bar: the split's share)",
        [("hopper.cuh", "  hi = CVT ? tf32_rna_cvt(x) : tf32_rna(x);",
          "  hi = __float_as_uint(x);\n  lo = 0u;\n  return;")]),
}

#: (dtype, bh, t, head_dim), causal: the f32 kernel's timed shape and
#: every other head_dim it takes, and the "wide" kernels' in bf16 and f32.
SHAPES = (("float32", 64, 1024, 128), ("float32", 16, 2048, 256),
          *(("float32", 64, 1024, d) for d in (32, 64, 96, 160, 192, 224)),
          ("bfloat16", 16, 1024, 512), ("float32", 16, 1024, 512))
REPS = 10


def make_variant(name: str) -> str:
    """A fresh copy of this tree's package with the variant's change."""
    root = os.path.join(ROOT, "build", "ablation", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "ray_tpu_torch"),
                    os.path.join(root, "ray_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in VARIANTS[name][1]:
        path = os.path.join(root, "ray_tpu_torch", "csrc", fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {fname} does not hold its "
                             "text once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def print_ptxas_summary(name: str, reports) -> None:
    """ptxas's registers, spills and C75xx advisories of the "wide" kernels
    and the backward kernels in one tree's build reports."""
    for lib, report in reports.items():
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "wide" not in line and "flash_bwd" not in line:
                continue
            if "C75" in line:
                print(f"  {name} {lib}: {line.strip()[:110]}")
            elif "Compiling entry" in line:
                kernel = line.split("'")[1] if "'" in line else line
                for follow in lines[i + 1:i + 4]:
                    if "registers" in follow or "spill" in follow:
                        print(f"  {name} {lib} {kernel[:60]}: "
                              f"{follow.strip()}")


def load_port(root: str, name: str):
    """The `ray_tpu_torch` package at `root`, imported as `name`."""
    pkg = os.path.join(os.path.abspath(root), "ray_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    port = importlib.util.module_from_spec(spec)
    sys.modules[name] = port
    spec.loader.exec_module(port)
    return port


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", metavar="VARIANT",
                        help=f"variants to time, of {sorted(VARIANTS)} "
                             "(default: all)")
    parser.add_argument("--against", metavar="ROOT",
                        help="also time the checkout at ROOT")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        help="time only the SHAPES of this dtype")
    args = parser.parse_args()
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    roots = {"this": ROOT}
    if args.against:
        roots["against"] = args.against
    for name in args.variants or VARIANTS:
        print(f"variant {name}: {VARIANTS[name][0]}")
        roots[name] = make_variant(name)
    ports = {name: load_port(root, f"ablation_{name}")
             for name, root in roots.items()}
    # One nvcc per tree and source, all started together.
    libs = ("flash_fwd_any", "flash_bwd_any")
    with ThreadPoolExecutor(len(ports)) as pool:
        reports = list(pool.map(lambda p: p.ops._build.build(libs),
                                ports.values()))
    for name, report in zip(ports, reports):
        print_ptxas_summary(name, report)
    attns = {name: port.ops.attention for name, port in ports.items()}
    this = attns["this"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dt, bh, t, d in SHAPES:
        if args.dtype and dt != args.dtype:
            continue
        dtype = getattr(torch, dt)
        tol = (chip_smoke.F32_REL_TOL if dtype == torch.float32
               else chip_smoke.REL_TOL)
        scale = 1.0 / math.sqrt(d)
        q, k, v, do = ((torch.randn(bh, t, d, generator=gen, device="cuda")
                        * 0.5).to(dtype) for _ in range(4))
        q2 = this.prescale(q, scale)
        ref, ref_lse = this.flash_forward_plain(q2, k, v, True, t)
        # The backward op at every shape.
        backward = True
        if backward:
            ref_grads = this.flash_backward_plain(q2, k, v, ref, do, ref_lse,
                                                  scale, True, t, t)
        fns = {"fwd": {}, "bwd": {}}
        for name, attn in attns.items():
            out, lse = attn.flash_forward(q2, k, v, True, t)
            chip_smoke.held(f"{name} {(dt, bh, t, d)} out", out, ref,
                            rel_tol=tol)
            fns["fwd"][name] = lambda attn=attn: attn.flash_forward(
                q2, k, v, True, t)
            if backward:
                bwd_args = (q2, k, v, out, do, lse, scale, True, t, t)
                for gname, got, want in zip(("dq", "dk", "dv"),
                                            attn.flash_backward(*bwd_args),
                                            ref_grads):
                    chip_smoke.held(f"{name} {(dt, bh, t, d)} {gname}", got,
                                    want, rel_tol=tol)
                fns["bwd"][name] = lambda attn=attn, bwd_args=bwd_args: (
                    attn.flash_backward(*bwd_args))
        q4, k4, v4, do4 = (x.view(1, bh, t, d) for x in (q, k, v, do))
        fns["fwd"]["sdpa"] = lambda: sdpa(q4, k4, v4, is_causal=True,
                                          scale=scale)
        if backward:
            qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
            fns["bwd"]["sdpa"] = lambda: torch.autograd.grad(
                sdpa(qg, kg, vg, is_causal=True, scale=scale), (qg, kg, vg),
                do4)
        times = {}
        for op, ops in fns.items():
            times[op] = {name: [] for name in ops}
            for name in list(ops) + list(reversed(list(ops))):
                times[op][name].append(
                    chip_smoke.cuda_ms(torch, ops[name], REPS))
        if backward:  # SDPA's backward share
            times["bwd"]["sdpa"] = [
                b - f for b, f in zip(times["bwd"]["sdpa"],
                                      times["fwd"]["sdpa"])]
        for op, by_tree in times.items():
            if by_tree:
                print(f"{op} {(dt, bh, t, d)} causal: " + ", ".join(
                    f"{name} {min(ms):.4f} / {max(ms):.4f}"
                    for name, ms in by_tree.items()))
        del q, k, v, do, q2, ref, ref_lse, fns, q4, k4, v4, do4
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
