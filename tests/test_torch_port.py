"""Hygiene of the PyTorch port: `ray_tpu_torch` and `chip_smoke.py`
import neither JAX nor anything of `ray_tpu`, its entry points default
to the card, and its parameters line up with the JAX package's."""

import ast
import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.models import llama
from ray_tpu_torch.train import make_train_step

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_tpu_torch")


def _port_sources():
    paths = [os.path.join(root, name)
             for root, _, files in os.walk(PORT)
             for name in files if name.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py")]


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "ray_tpu")


def test_imports_leave_jax_and_ray_tpu_out():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'ray_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr
    n_modules = sum(1 for p in _port_sources() if p.startswith(PORT)) - 1
    assert int(proc.stdout.split()[-1]) == n_modules


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_or_ray_tpu_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_entry_points_default_to_the_card():
    assert inspect.signature(llama.Llama).parameters["device"].default == "cuda"
    assert inspect.signature(llama.init_params).parameters["device"].default == "cuda"
    assert inspect.signature(make_train_step).parameters["device"].default == "cuda"


def test_load_jax_params_round_trips_tiny():
    cfg_j = jax_llama.LlamaConfig.tiny(qk_norm=True, attn_bias=True)
    cfg = llama.LlamaConfig.tiny(qk_norm=True, attn_bias=True)
    tree = jax.tree.map(np.asarray, jax_llama.init_params(jax.random.PRNGKey(0), cfg_j))
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    back = llama.to_jax_params(model.state_dict(), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_7b_width_shapes_match_jax_without_allocating():
    cfg_j = jax_llama.LlamaConfig.llama2_7b(n_layers=4)
    cfg = llama.LlamaConfig.llama2_7b(n_layers=4)
    shapes = jax.eval_shape(lambda k: jax_llama.init_params(k, cfg_j),
                            jax.random.PRNGKey(0))
    state = llama.Llama(cfg, device="meta").state_dict()
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in state.values())
    leaves = {"embed": ("embed.weight", False), "final_norm": ("final_norm", False),
              "lm_head": ("lm_head.weight", True)}
    for leaf, (name, transpose) in leaves.items():
        want = shapes[leaf].shape[::-1] if transpose else shapes[leaf].shape
        assert tuple(state[name].shape) == want, leaf
    for leaf, spec in shapes["layers"].items():
        name, transpose = llama._LAYER_LEAVES[leaf]
        want = spec.shape[1:][::-1] if transpose else spec.shape[1:]
        for i in range(cfg.n_layers):
            assert tuple(state[f"layers.{i}.{name}"].shape) == want, (leaf, i)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_jax == sum(t.numel() for t in state.values()) == cfg.num_params()


def test_chip_smoke_finds_the_peak_and_what_is_alive_at_it():
    import chip_smoke

    def frame(path, line, name):
        return [{"filename": path, "line": line, "name": name}]

    trace = [
        {"action": "alloc", "addr": 1, "size": 100,
         "frames": frame("/x/ray_tpu_torch/ops/attention.py", 5, "f")},
        {"action": "alloc", "addr": 2, "size": 50, "frames": []},
        # A block allocated before the history began, freed during it.
        {"action": "free_requested", "addr": 9, "size": 30},
        {"action": "alloc", "addr": 3, "size": 60,
         "frames": frame("/t/torch/nn/functional.py", 7, "g")},
        {"action": "free_requested", "addr": 1, "size": 100},
        {"action": "alloc", "addr": 4, "size": 10, "frames": []},
    ]
    above, alive = chip_smoke.peak_allocations(trace)
    assert above == 180
    assert alive == [
        {"site": "ray_tpu_torch/ops/attention.py:5 f", "bytes": 100},
        {"site": "functional.py:7 g", "bytes": 60},
        {"site": "(no Python frame)", "bytes": 50},
    ]


def test_chip_smoke_loads_another_checkout_beside_this_one(tmp_path):
    import shutil

    import chip_smoke
    from ray_tpu_torch.ops import attention as attn

    shutil.copytree(PORT, tmp_path / "ray_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    try:
        other = chip_smoke.load_port(tmp_path)
        other_attn = other.ops.attention
        assert other_attn.__file__.startswith(str(tmp_path))
        assert other_attn.LAUNCHES is not attn.LAUNCHES
        gen = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(2, 64, 64, generator=gen) for _ in range(4))
        grads = []
        for tree in (other_attn, attn):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = tree.FlashAttentionFunction.apply(*leaves, 0.125, True, 64, 64)
            grads.append((out,) + torch.autograd.grad(out, leaves, do))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        for name in [m for m in sys.modules if m.startswith("against_ray_tpu_torch")]:
            del sys.modules[name]
