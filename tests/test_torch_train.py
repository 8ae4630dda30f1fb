"""Parity of the port's train step (`ray_tpu_torch.train`) with the JAX
package's `make_train_step` on one CPU device, in f32: the same
parameters (through `load_jax_params`), the same batch and
`default_optimizer(learning_rate=1e-2, total_steps=20)` on both sides
for three steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import MeshSpec
from ray_tpu.train import train_step as jax_train
from ray_tpu_torch.models import llama
from ray_tpu_torch.train import default_optimizer, make_train_step
from ray_tpu_torch.train.train_step import warmup_cosine_decay

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

STEPS = 3
RTOL = 1e-4


def _batch(vocab, seed=7):
    toks = np.random.default_rng(seed).integers(0, vocab, (2, 33)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def jax_run():
    """Initial parameters, per-step metrics and final parameters of
    three JAX steps."""
    cfg = jax_llama.LlamaConfig.tiny()
    mesh = MeshSpec(fsdp=1).build(jax.devices()[:1])
    init_fn, step_fn = jax_train.make_train_step(
        lambda p, t, y: jax_llama.loss_fn(p, t, y, cfg),
        jax_train.default_optimizer(learning_rate=1e-2, total_steps=20),
        mesh, jax_llama.param_annotations(cfg), donate=False,
    )
    state = init_fn(jax.random.PRNGKey(0),
                    lambda k: jax_llama.init_params(k, cfg))
    initial = jax.tree.map(np.array, state.params)
    inputs, targets = _batch(cfg.vocab_size)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step_fn(state, jnp.asarray(inputs), jnp.asarray(targets))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return initial, losses, norms, jax.tree.map(np.array, state.params)


def _port_run(initial, remat=True):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), remat=remat)
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(initial, cfg))
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=1e-2, total_steps=20),
        device="cpu")
    state = init_fn(model)
    inputs, targets = (torch.from_numpy(x).long() for x in _batch(cfg.vocab_size))
    losses, norms, params = [], [], []
    for _ in range(STEPS):
        state, metrics = step_fn(state, inputs, targets)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        params.append(llama.to_jax_params(state.params.state_dict(), cfg))
    assert state.step == STEPS
    return losses, norms, params


def test_trajectory_matches_jax(jax_run):
    initial, losses, norms, final = jax_run
    got_losses, got_norms, params = _port_run(initial)
    np.testing.assert_allclose(got_losses, losses, rtol=RTOL)
    np.testing.assert_allclose(got_norms, norms, rtol=RTOL)
    # The schedule is read at count 0, where warmup starts at lr 0.
    jax.tree.map(np.testing.assert_array_equal, params[0], initial)
    # Adam moves every element by about lr whatever its gradient's size,
    # so an element whose gradient is near 0, where the two frameworks'
    # f32 sums differ most, differs by a small share of lr (1e-2).
    jax.tree.map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-4),
        params[-1], final)


def test_remat_on_and_off_agree(jax_run):
    initial = jax_run[0]
    on, off = _port_run(initial, remat=True), _port_run(initial, remat=False)
    assert on[0] == off[0] and on[1] == off[1]
    jax.tree.map(np.testing.assert_array_equal, on[2][-1], off[2][-1])


def test_donate_false_leaves_the_state_passed_in_unchanged(jax_run):
    """JAX's contract: with donate=False the step returns a new state and
    the state passed in keeps its parameters, optimizer state and step;
    the trajectory is the donating step's."""
    initial, losses = jax_run[:2]
    cfg = llama.LlamaConfig.tiny()
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(initial, cfg))
    init_fn, step_fn = make_train_step(
        llama.loss_fn, default_optimizer(learning_rate=1e-2, total_steps=20),
        donate=False, device="cpu")
    first = init_fn(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    inputs, targets = (torch.from_numpy(x).long() for x in _batch(cfg.vocab_size))
    state, got = first, []
    for _ in range(STEPS):
        state, metrics = step_fn(state, inputs, targets)
        got.append(metrics["loss"].item())
    assert state is not first and first.step == 0 and state.step == STEPS
    assert first.opt_state["count"] == 0
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert all(not m.any() for m in first.opt_state["mu"])
    np.testing.assert_allclose(got, losses, rtol=RTOL)


@pytest.mark.parametrize("total", [20, 1000])
def test_schedule_matches_optax(total):
    import optax

    warmup = min(100, max(1, total // 10))
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=total, end_value=3e-5)
    got = warmup_cosine_decay(0.0, 3e-4, warmup, total, 3e-5)
    for count in [0, 1, warmup - 1, warmup, warmup + 1, total // 2, total,
                  total + 5]:
        # optax evaluates in f32: agreement to f32 rounding.
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5,
                                   atol=1e-12)


def test_clip_has_no_epsilon():
    """optax scales by max_norm / g_norm exactly once the norm reaches
    max_norm; torch's clip_grad_norm_ would add 1e-6."""
    opt = default_optimizer(learning_rate=1.0, weight_decay=0.0,
                            warmup_steps=1, total_steps=10)
    # f64, where a 1e-6 in the divisor is far above rounding.
    p = torch.zeros(4, dtype=torch.float64)
    g = torch.tensor([3.0, 4.0, 0.0, 0.0], dtype=torch.float64)  # norm 5
    state = opt.init([p])
    opt.apply([p], [g], state, torch.linalg.norm(g))
    torch.testing.assert_close(state["mu"][0], (1 - 0.9) * (g / 5.0),
                               rtol=1e-12, atol=0)
