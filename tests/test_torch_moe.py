"""The port's mixture of experts (`ray_tpu_torch.ops.moe`) and the MoE
Llama, held to the JAX package's (`ray_tpu/ops/moe.py`,
`ray_tpu/models/llama.py`) on the same inputs, in f32.

- routing, dispatch and the dense FFN in this process;
- `moe_ffn_ep` over groups of 2 and 4 in one spawned gang of 4 gloo
  processes (`_torch_gang.expert_ops`), against JAX's `moe_ffn_ep` under
  `shard_map`, at a capacity factor at which (token, choice) pairs drop;
- the MoE Llama's forward, aux loss and loss (JAX's `moe_ffn_dense`
  path), and three steps of `make_train_step` on an fsdp 2 mesh, in a
  gang of 2, against JAX's step on 2 of the 8 virtual CPU devices.

Mirrors `tests/test_parallel_extras.py` (MoE routes top-k, ep against
dense, ep gradients) and `tests/test_pipeline_flagship.py` (the MoE
model under `loss_fn`)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ray_tpu.models import llama as jax_llama
from ray_tpu.ops import moe as jax_moe
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.train import train_step as jax_train
from ray_tpu_torch import graft_entry
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import moe
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train import run_local_gang

import _torch_gang
from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

#: f32 on both sides; index scatters against one-hot contractions, and
#: sums in other orders.
ATOL = 2e-5
RTOL = 1e-4
#: As test_torch_sharded.py: Adam moves an element by about lr whatever
#: its gradient's size.
PARAM_ATOL = 1e-3
GANG_TIMEOUT = 150
#: Experts, width, FFN width, tokens per rank. At capacity factor 0.5 an
#: expert takes ceil(2 * 16 * 0.5 / 8) = 2 (token, choice) pairs from
#: each rank: of the 32 pairs of a rank, about half drop.
E, D, FF, T_LOCAL = 8, 16, 32, 16
CAPACITY_FACTOR = 0.5
AUX_WEIGHT = 0.3


def _params(seed=0):
    p = jax_moe.init_moe_params(jax.random.PRNGKey(seed), E, D, FF)
    return {k: np.asarray(v) for k, v in p.items()}


def _torch(tree, grad=False):
    return {k: torch.tensor(v).requires_grad_(grad) for k, v in tree.items()}


def test_init_moe_params_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(64, 128, 256, gen, device="cpu")
    assert p["router"].shape == (128, 64)
    assert p["w_in"].shape == (64, 128, 256)
    assert p["w_out"].shape == (64, 256, 128)
    for name, fan_in in (("router", 128), ("w_in", 128), ("w_out", 256)):
        assert abs(p[name].std().item() * fan_in ** 0.5 - 1.0) < 0.05, name
    again = moe.init_moe_params(64, 128, 256,
                                torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_router_matches_jax():
    logits = np.random.default_rng(1).standard_normal((40, E)).astype(
        np.float32)
    want = jax.jit(jax_moe.top_k_router, static_argnums=1)(
        jnp.asarray(logits), 2)
    got = moe.top_k_router(torch.tensor(logits), 2)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert abs(got[2].item() - float(want[2])) < 1e-6


def test_dispatch_drops_the_same_pairs_as_jax():
    """Token-major order: at capacity the later tokens' choices drop,
    whatever the JAX comment at moe.py:77 ("choice-major") says."""
    rng = np.random.default_rng(2)
    indices = np.stack([rng.permutation(E)[:2] for _ in range(24)]).astype(
        np.int32)
    gates = rng.random((24, 2)).astype(np.float32)
    for capacity in (1, 3, 48):
        dispatch, combine = jax_moe._dispatch_tensors(
            jnp.asarray(indices), jnp.asarray(gates), E, capacity)
        token, slot, gate = moe._dispatch(torch.tensor(indices).long(),
                                          torch.tensor(gates), E, capacity)
        got = np.zeros((24, E, capacity), np.float32)
        got[token.numpy(), (slot // capacity).numpy(),
            (slot % capacity).numpy()] = gate.numpy()
        np.testing.assert_array_equal(got > 0, np.asarray(dispatch) > 0)
        np.testing.assert_allclose(got, np.asarray(combine), atol=1e-7)
        kept = len(token)
        assert kept < 48 if capacity < 6 else kept == 48
    # The first token's first choice is always kept, the last's second
    # dropped at capacity 1 when an earlier token took its expert.
    token, slot, _ = moe._dispatch(torch.tensor([[0, 1], [0, 1]]),
                                   torch.ones(2, 2), 2, 1)
    assert token.tolist() == [0, 0] and slot.tolist() == [0, 1]


def test_dense_ffn_and_gradients_match_jax():
    params = _params(3)
    x = np.random.default_rng(4).standard_normal((20, D)).astype(np.float32)
    g = np.random.default_rng(5).standard_normal((20, D)).astype(np.float32)

    def objective(p, x):
        out, aux = jax_moe.moe_ffn_dense(p, x, k=2)
        return jnp.sum(out * g) + AUX_WEIGHT * aux, (out, aux)

    (_, (want, want_aux)), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    p, xt = _torch(params, grad=True), torch.tensor(x).requires_grad_()
    out, aux = moe.moe_ffn_dense(p, xt, k=2)
    ((out * torch.tensor(g)).sum() + AUX_WEIGHT * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    assert abs(aux.item() - float(want_aux)) < 1e-6
    for k in p:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(grads[0][k]),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grads[1]),
                               atol=ATOL)


@pytest.fixture(scope="module")
def ep_inputs():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, T_LOCAL, D)).astype(np.float32)
    g = rng.standard_normal((4, T_LOCAL, D)).astype(np.float32)
    return _params(7), x, g


@pytest.fixture(scope="module")
def ep_port(ep_inputs):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    return run_local_gang(_torch_gang.expert_ops, 4,
                          (*ep_inputs, CAPACITY_FACTOR, AUX_WEIGHT),
                          device="cpu", timeout=GANG_TIMEOUT)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("ep", [2, 4])
def test_expert_parallel_matches_jax_with_drops(ep_inputs, ep_port, ep):
    """Outputs, each rank's aux loss and the gradients of the router
    (summed over the ranks, whose objectives add up), of each rank's
    experts and of its tokens, at a capacity where pairs drop."""
    params, x, g = ep_inputs
    x, g = x[:ep].reshape(ep * T_LOCAL, D), g[:ep].reshape(ep * T_LOCAL, D)
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))

    def local(router, w_in, w_out, x, g):
        out, aux = jax_moe.moe_ffn_ep(
            {"router": router, "w_in": w_in, "w_out": w_out}, x, k=2,
            capacity_factor=CAPACITY_FACTOR)
        objective = lax.psum(jnp.sum(out * g) + AUX_WEIGHT * aux, "ep")
        return objective, (out, aux[None])

    run = shard_map(local, mesh=mesh,
                    in_specs=(P(), P("ep"), P("ep"), P("ep"), P("ep")),
                    out_specs=(P(), (P("ep"), P("ep"))))
    (_, (want, want_aux)), grads = jax.jit(jax.value_and_grad(
        lambda *a: run(*a, g), argnums=(0, 1, 2, 3), has_aux=True))(
            *(jnp.asarray(params[k]) for k in ("router", "w_in", "w_out")),
            jnp.asarray(x))
    dense, _ = jax.jit(jax_moe.moe_ffn_dense)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    assert np.abs(np.asarray(want) - np.asarray(dense)).max() > 0.1  # drops
    e_local = E // ep
    router_grad = sum(ep_port[r][ep][2][0] for r in range(ep))
    np.testing.assert_allclose(router_grad, np.asarray(grads[0]), atol=ATOL)
    for r in range(ep):
        out, aux, (_, g_in, g_out, g_x) = ep_port[r][ep]
        rows = slice(r * T_LOCAL, (r + 1) * T_LOCAL)
        experts = slice(r * e_local, (r + 1) * e_local)
        np.testing.assert_allclose(out, np.asarray(want)[rows], atol=ATOL)
        assert abs(aux - float(want_aux[r])) < 1e-6
        np.testing.assert_allclose(g_in, np.asarray(grads[1])[experts],
                                   atol=ATOL)
        np.testing.assert_allclose(g_out, np.asarray(grads[2])[experts],
                                   atol=ATOL)
        np.testing.assert_allclose(g_x, np.asarray(grads[3])[rows], atol=ATOL)


def _moe_configs(**kw):
    kw = dict(vocab_size=64, dim=32, n_layers=2, n_heads=2, n_kv_heads=2,
              intermediate=64, max_seq_len=32, attention="reference",
              moe_experts=4, **kw)
    return (jax_llama.LlamaConfig(dtype=jnp.float32, **kw),
            llama.LlamaConfig(dtype=torch.float32, **kw))


def test_moe_param_annotations_and_round_trip_match_jax():
    cfg_j, cfg = _moe_configs()
    tree = jax.tree.map(np.asarray, jax_llama.init_params(
        jax.random.PRNGKey(0), cfg_j))
    ann = llama.param_annotations(cfg)
    jann = jax_llama.param_annotations(cfg_j)["layers"]
    for leaf in ("router", "w_in", "w_out"):
        for i in range(cfg.n_layers):
            assert ann[f"layers.{i}.{leaf}"].logical_axes == \
                jann[leaf].logical_axes[1:]
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    back = llama.to_jax_params(model.state_dict(), cfg)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    init = llama.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    router = init.layers[0].router
    assert router.shape == (cfg.dim, 4)
    assert abs(router.std().item() * cfg.dim ** 0.5 - 1.0) < 0.3


def test_moe_llama_loss_and_gradients_match_jax():
    """The MoE Llama through `forward_and_aux` and `loss_fn` (every
    expert local: JAX's `moe_ffn_dense` path), aux loss included."""
    cfg_j, cfg = _moe_configs()
    tree = jax.tree.map(np.asarray, jax_llama.init_params(
        jax.random.PRNGKey(1), cfg_j))
    toks = np.random.default_rng(2).integers(0, 64, (2, 17)).astype(np.int32)
    logits, aux = jax.jit(lambda p, t: jax_llama.forward_and_aux(
        p, t, cfg_j))(tree, jnp.asarray(toks[:, :-1]))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, toks[:, :-1], toks[:, 1:], cfg_j)))(
            jax.tree.map(jnp.asarray, tree))
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    t = torch.tensor(toks).long()
    got_logits, got_aux = llama.forward_and_aux(model, t[:, :-1])
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), atol=1e-4)
    assert abs(got_aux.item() - float(aux)) < 1e-5 and float(aux) > 1.0
    got = llama.loss_fn(model, t[:, :-1], t[:, 1:])
    got.backward()
    assert abs(got.item() - float(loss)) < 1e-5
    got_grads = llama.to_jax_params(
        {n: p.grad for n, p in model.named_parameters()}, cfg)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, atol=ATOL),
                 got_grads, jax.tree.map(np.asarray, grads))


@pytest.mark.timeout(300)
def test_moe_train_step_on_fsdp2_matches_jax():
    """Three steps of `make_train_step` with MoE over fsdp 2 (the expert
    weights [E, d, f] sharded on d): each data shard takes the router's
    load-balancing statistics over the whole batch, as JAX's GSPMD does,
    and the losses, norms and final parameters are JAX's."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    cfg_j, cfg = _moe_configs()
    mesh = JaxMeshSpec(fsdp=2).build(jax.devices()[:2])
    init_fn, step_fn = jax_train.make_train_step(
        lambda p, t, y: jax_llama.loss_fn(p, t, y, cfg_j),
        jax_train.default_optimizer(learning_rate=1e-2, total_steps=20),
        mesh, jax_llama.param_annotations(cfg_j), donate=False)
    state = init_fn(jax.random.PRNGKey(3),
                    lambda k: jax_llama.init_params(k, cfg_j))
    initial = jax.tree.map(np.array, state.params)
    tokens = np.random.default_rng(8).integers(0, 64, (4, 17))
    put = lambda x: jax_train.shard_batch(  # noqa: E731
        jnp.asarray(x, jnp.int32), mesh, logical_axes=("batch", None))
    losses, norms = [], []
    for _ in range(3):
        state, metrics = step_fn(state, put(tokens[:, :-1]),
                                 put(tokens[:, 1:]))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    start = {k: v.numpy() for k, v in
             llama.load_jax_params(initial, cfg).items()}
    got = run_local_gang(graft_entry.train_on_meshes, 2,
                         (cfg, [(MeshSpec(fsdp=2), tokens, 3)], start, 1e-2,
                          20), device="cpu", timeout=GANG_TIMEOUT)[0][0]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=RTOL)
    final = llama.to_jax_params(
        {k: torch.from_numpy(v) for k, v in got["final"].items()}, cfg)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=RTOL, atol=PARAM_ATOL), final,
        jax.tree.map(np.array, state.params))
