"""Selective remat in the port (`LlamaConfig.remat_policy` "dots" and
"dots_flash") on the CPU, in f32, against "full" and against the JAX
package's `loss_fn` under the same policy, on the same parameters (JAX
init perturbed with numpy noise, through `load_jax_params`).

On the CPU the JAX package's `flash_attention` takes `mha_reference`
(`ray_tpu/ops/attention.py:601-603`), so there JAX's "dots_flash" equals
its "dots": the flash residuals it would save do not exist. The port's
CPU flash op runs the kernels' plain versions, so its "dots_flash"
really saves the flash forward's outputs: the forward runs once per
layer per step instead of twice."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import attention as attn

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

POLICIES = ("full", "dots", "dots_flash")
#: Loss and gradients against JAX (f32, different summation orders).
TOL = 1e-4


def _tree(cfg, seed=0):
    params = jax_llama.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _batch(cfg, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 25))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _port_grads(tree, policy, attention="flash"):
    cfg = llama.LlamaConfig.tiny(remat_policy=policy, attention=attention)
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    inputs, targets = (torch.from_numpy(x).long() for x in _batch(cfg))
    loss = llama.loss_fn(model, inputs, targets)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.item(), grads, cfg


@pytest.mark.parametrize("policy", ["dots", "dots_flash"])
@pytest.mark.parametrize("attention", ["flash", "reference"])
def test_policy_equals_full_to_the_bit(policy, attention):
    """Saving an output instead of recomputing it changes no number."""
    tree = _tree(jax_llama.LlamaConfig.tiny())
    loss, grads, _ = _port_grads(tree, policy, attention)
    want_loss, want, _ = _port_grads(tree, "full", attention)
    assert loss == want_loss
    for name, g in grads.items():
        torch.testing.assert_close(g, want[name], rtol=0, atol=0)


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_grads_match_jax_under_the_policy(policy):
    jcfg = jax_llama.LlamaConfig.tiny(remat_policy=policy)
    tree = _tree(jcfg, seed=2)
    inputs, targets = _batch(jcfg, seed=3)
    want_loss, want = jax.value_and_grad(jax_llama.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(inputs),
        jnp.asarray(targets), jcfg)
    cfg = llama.LlamaConfig.tiny(remat_policy=policy)
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    loss = llama.loss_fn(model, torch.from_numpy(inputs).long(),
                         torch.from_numpy(targets).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    got = llama.to_jax_params(
        {n: p.grad for n, p in model.named_parameters()}, cfg)
    jax.tree.map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=TOL,
                                                atol=TOL),
        got, want)


@pytest.mark.parametrize("policy,per_layer", [("full", 2), ("dots", 2),
                                              ("dots_flash", 1)])
def test_flash_forward_runs_per_layer_per_step(policy, per_layer, monkeypatch):
    """The plain forward stands in for the kernel on the CPU: "dots_flash"
    reads its saved output in the backward, the others rerun it."""
    calls = []
    plain = attn.flash_forward_plain

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(attn, "flash_forward_plain", counting)
    tree = _tree(jax_llama.LlamaConfig.tiny(), seed=4)
    _, _, cfg = _port_grads(tree, policy)
    assert len(calls) == per_layer * cfg.n_layers


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["dots", "dots_flash"])
def test_policy_saves_the_products_without_batch_dims(policy):
    """The backward of "full" recomputes each layer's projections up to
    the last one it needs (6 of 7: the checkpoint stops before w2, whose
    output no backward reads); under "dots" and "dots_flash" it reads
    them back instead and recomputes none."""
    tree = _tree(jax_llama.LlamaConfig.tiny(), seed=5)
    counts = {}
    for p in ("full", policy):
        cfg = llama.LlamaConfig.tiny(remat_policy=p, attention="reference")
        model = llama.Llama(cfg, device="cpu")
        model.load_state_dict(llama.load_jax_params(tree, cfg))
        inputs, targets = (torch.from_numpy(x).long() for x in _batch(cfg))
        loss = llama.loss_fn(model, inputs, targets)
        with _CountMatmuls() as mode:
            loss.backward()
        counts[p] = mode.mm
    assert counts["full"] - counts[policy] == 6 * cfg.n_layers


def test_remat_off_ignores_the_policy():
    tree = _tree(jax_llama.LlamaConfig.tiny(), seed=6)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(remat_policy="dots"),
                              remat=False)
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    inputs, targets = (torch.from_numpy(x).long() for x in _batch(cfg))
    loss = llama.loss_fn(model, inputs, targets)
    assert loss.item() == _port_grads(tree, "full")[0]
