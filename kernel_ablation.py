#!/usr/bin/env python3
"""Ablations of the port's "any" flash forward kernels on one CUDA card.

Each variant is a copy of `ray_tpu_torch/` under
`build/ablation/<variant>/` with one named change to its `csrc/`
(VARIANTS), loaded beside this tree under a module name of its own (the
op registers under the package's name, so the copies coexist) and built
from its own sources. At each shape of SHAPES every tree's
`flash_forward` is held to this tree's plain version (printed, not held:
a variant may trade precision on purpose) and timed by CUDA events in
turns (each tree, SDPA, then the same in reverse), beside
`scaled_dot_product_attention` and, with `--against ROOT`, the
`ray_tpu_torch` of another checkout at ROOT.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 kernel_ablation.py [--against ROOT] [VARIANT ...]

With no VARIANT it times every one. Prints the card's name and power
limit, then one line per shape: each tree's min / max over its turns in
ms. Copies stay under the gitignored `build/`.
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
}

#: (dtype, bh, t, head_dim), causal: the f32 kernel's timed shape and
#: every other head_dim it takes, and the 16-bit "wide" kernel's.
SHAPES = (("float32", 64, 1024, 128), ("float32", 16, 2048, 256),
          *(("float32", 64, 1024, d) for d in (32, 64, 96, 160, 192, 224)),
          ("bfloat16", 16, 1024, 512))
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
    # One nvcc per tree, all started together.
    with ThreadPoolExecutor(len(ports)) as pool:
        list(pool.map(lambda p: p.ops._build.build(("flash_fwd_any",)),
                      ports.values()))
    attns = {name: port.ops.attention for name, port in ports.items()}
    this = attns["this"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dt, bh, t, d in SHAPES:
        dtype = getattr(torch, dt)
        tol = (chip_smoke.F32_REL_TOL if dtype == torch.float32
               else chip_smoke.REL_TOL)
        q, k, v = ((torch.randn(bh, t, d, generator=gen, device="cuda")
                    * 0.5).to(dtype) for _ in range(3))
        q2 = this.prescale(q, 1.0 / math.sqrt(d))
        ref, _ = this.flash_forward_plain(q2, k, v, True, t)
        fns = {}
        for name, attn in attns.items():
            out, _ = attn.flash_forward(q2, k, v, True, t)
            chip_smoke.held(f"{name} {(dt, bh, t, d)}", out, ref,
                            rel_tol=tol)
            fns[name] = lambda attn=attn: attn.flash_forward(q2, k, v, True,
                                                             t)
        q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
        fns["sdpa"] = lambda: sdpa(q4, k4, v4, is_causal=True,
                                   scale=1.0 / math.sqrt(d))
        times = {name: [] for name in fns}
        for name in list(fns) + list(reversed(list(fns))):
            times[name].append(chip_smoke.cuda_ms(torch, fns[name], REPS))
        print(f"{(dt, bh, t, d)} causal: " + ", ".join(
            f"{name} {min(ms):.4f} / {max(ms):.4f}"
            for name, ms in times.items()))
        del q, k, v, q2, ref, fns, q4, k4, v4
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
