"""Parity of the port's Llama (`ray_tpu_torch.models.llama`) with the
JAX package's (`ray_tpu.models.llama`) on the CPU, in f32.

The JAX parameters go to the port through `load_jax_params`: the two
packages' random initializers draw different numbers, so comparing two
independent inits would prove nothing. Every leaf is perturbed with
numpy noise first, so biases and norms are not left at 0 and 1, where
a mapping fault would not show."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.models import llama

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

LOGITS_TOL = 1e-4


VARIANTS = {
    "plain": {},
    "gqa": {"n_kv_heads": 2},
    "gemma_qwen3_knobs": {
        "act": "gelu_tanh", "norm_offset": True, "embed_scale": True,
        "custom_head_dim": 32, "qk_norm": True, "attn_bias": True,
    },
}


def _configs(**kw):
    return (dataclasses.replace(jax_llama.LlamaConfig.tiny(), **kw),
            dataclasses.replace(llama.LlamaConfig.tiny(), **kw))


def _jax_tree(cfg, seed=0):
    params = jax_llama.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )


def _port_model(tree, cfg):
    state = llama.load_jax_params(tree, cfg)
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(state)
    assert set(state) == set(model.state_dict())
    return model


def _tokens(cfg, seed=1, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_jax(variant):
    jcfg, cfg = _configs(**VARIANTS[variant])
    tree = _jax_tree(jcfg)
    toks = _tokens(cfg)
    want = jax_llama.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), jcfg)
    model = _port_model(tree, cfg)
    with torch.no_grad():
        got = llama.forward(model, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


@pytest.mark.parametrize("variant", ["plain", "gqa"])
def test_loss_with_masked_targets_matches_jax(variant):
    jcfg, cfg = _configs(**VARIANTS[variant])
    tree = _jax_tree(jcfg, seed=2)
    toks = _tokens(cfg, seed=3, shape=(2, 25))
    targets = toks[:, 1:].copy()
    targets[0, :7] = -1
    targets[1, -3:] = -1
    want = jax_llama.loss_fn(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(toks[:, :-1]), jnp.asarray(targets), jcfg)
    model = _port_model(tree, cfg)
    got = llama.loss_fn(model, torch.from_numpy(toks[:, :-1]).long(),
                        torch.from_numpy(targets).long())
    np.testing.assert_allclose(got.item(), float(want), rtol=LOGITS_TOL)


def test_masked_xent_pieces():
    logits = np.random.default_rng(4).standard_normal((2, 5, 11)).astype(np.float32)
    targets = np.array([[1, -1, 3, 10, 0], [-1, -1, 2, 2, 7]], dtype=np.int32)
    want = jax_llama.masked_xent(jnp.asarray(logits), jnp.asarray(targets))
    got = llama.masked_xent(torch.from_numpy(logits), torch.from_numpy(targets).long())
    np.testing.assert_allclose([g.item() for g in got], [float(w) for w in want],
                               rtol=1e-6)


@pytest.mark.parametrize("preset", ["tiny", "llama2_7b", "gemma_2b", "llama3_8b",
                                    "bench_410m"])
def test_presets_count_like_jax(preset):
    jcfg = getattr(jax_llama.LlamaConfig, preset)()
    cfg = getattr(llama.LlamaConfig, preset)()
    assert cfg.num_params() == jcfg.num_params()
    assert llama.flops_per_token(cfg, 4096) == jax_llama.flops_per_token(jcfg, 4096)
    assert cfg.head_dim == jcfg.head_dim


def test_remat_gives_the_same_logits_and_grads():
    _, cfg = _configs()
    tree = _jax_tree(_configs()[0], seed=5)
    toks = torch.from_numpy(_tokens(cfg, seed=6)).long()
    results = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = _port_model(tree, c)
        loss = llama.loss_fn(model, toks[:, :-1], toks[:, 1:])
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kw,error,match", [
    pytest.param({"moe_experts": 4}, NotImplementedError, "MoE",
                 id="kw0-MoE"),
    pytest.param({"attention": "ring"}, NotImplementedError, "ring",
                 id="kw1-ring"),
    # "dots" and "dots_flash" run (tests/test_torch_remat.py); a policy
    # the JAX package does not name is refused.
    pytest.param({"remat_policy": "offload"}, ValueError, "remat",
                 id="kw2-remat"),
    pytest.param({"remat_policy": "nothing_saveable"}, ValueError, "remat",
                 id="kw3-remat"),
])
def test_unported_paths_raise(kw, error, match):
    with pytest.raises(error, match=match):
        llama.Llama(llama.LlamaConfig.tiny(**kw), device="meta")
