"""Sequence parallelism and MoE under tensor parallelism in the port's
`make_train_step`, held to the JAX package's `make_train_step` on the
same mesh over the 8 virtual CPU devices (`tests/conftest.py`), where
GSPMD shards the activations' sequence over `sp` and the experts' `mlp`
dim over `tp`. The port runs in one spawned gang of 8 gloo processes
(`_torch_gang.sequence_and_expert_meshes`, through
`graft_entry.train_on_meshes`), `LlamaConfig.tiny()` in f32 on both
sides, on the same parameters (JAX init through `load_jax_params`) and
batch, 3 steps of `default_optimizer(learning_rate=1e-2,
total_steps=20)`, at `test_torch_sharded.py`'s bars. Two-rank unit
tests hold Ulysses over the flash op and the tp-split expert products
to the JAX package's functions, and pin the refusal of "flash" off the
CPU where sp does not divide the heads."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.ops import attention as jax_attention
from ray_tpu.ops import moe as jax_moe
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.train import train_step as jax_train
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.moe import init_moe_params
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train import run_local_gang

import _torch_gang
from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

STEPS = 3
#: `test_torch_sharded.py`'s bars: f32 on both sides, the sums sharded
#: in other orders.
RTOL, PARAM_ATOL = 1e-4, 1e-3
GANG_TIMEOUT = 200

DENSE, RING, MOE = {}, {"attention": "ring"}, {"moe_experts": 4}
DOTS_FLASH = {"remat_policy": "dots_flash"}
#: name -> (config keywords, mesh axes, targets masked). tiny has 4
#: heads: at tp 2 x sp 4 the 2 local heads do not split over sp, and
#: "flash" on CPU tensors takes the ring route there.
CASES = {
    "fsdp2_sp2_tp2": (DENSE, {"fsdp": 2, "sp": 2, "tp": 2}, False),
    "dp2_sp4": (DENSE, {"dp": 2, "sp": 4}, False),
    "tp2_sp4_ring_route": (DENSE, {"tp": 2, "sp": 4}, False),
    "masked_fsdp2_sp2_tp2": (DENSE, {"fsdp": 2, "sp": 2, "tp": 2}, True),
    "ring_fsdp4_sp2": (RING, {"fsdp": 4, "sp": 2}, False),
    "moe_fsdp4_tp2": (MOE, {"fsdp": 4, "tp": 2}, False),
    "moe_fsdp2_sp2_tp2": (MOE, {"fsdp": 2, "sp": 2, "tp": 2}, False),
}
#: Port runs held to a JAX run of another config on the same mesh: the
#: remat policy changes what the backward recomputes, not the numbers.
SAME_AS = {"dots_flash_fsdp2_sp2_tp2": ("fsdp2_sp2_tp2", DOTS_FLASH)}


def _tokens(seed=7):
    return np.random.default_rng(seed).integers(0, 256, (8, 33))


def _masked_targets(tokens):
    """The batch's targets masked unevenly across the sequence halves of
    fsdp 2 x sp 2 (four rows by 16 positions each): rows 0-3 keep none
    of their second halves, rows 4-5 lose parts of their first."""
    targets = tokens[:, 1:].copy()
    targets[:4, 16:] = -1
    targets[4, :12] = -1
    targets[5, 3:16] = -1
    return targets


def _targets(tokens, masked):
    return _masked_targets(tokens) if masked else tokens[:, 1:]


@functools.cache
def _initial(config):
    cfg = jax_llama.LlamaConfig.tiny(**dict(config))
    return jax.tree.map(np.array,
                        jax_llama.init_params(jax.random.PRNGKey(0), cfg))


def _start(config):
    """The JAX initial parameters as the port's state dict of arrays."""
    cfg = llama.LlamaConfig.tiny(**config)
    return {k: v.numpy() for k, v in llama.load_jax_params(
        _initial(tuple(sorted(config.items()))), cfg).items()}


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the losses, grad norms and final parameters of JAX's
    step on the case's mesh, the batch sharded as `shard_batch` shards it
    (rows over the data axes, the sequence over sp)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tokens = _tokens()
    out, steps = {}, {}
    for name, (config, axes, masked) in CASES.items():
        key = (tuple(sorted(config.items())), tuple(sorted(axes.items())))
        if key not in steps:
            cfg = jax_llama.LlamaConfig.tiny(**config)
            mesh = JaxMeshSpec(**axes).build(jax.devices()[:8])
            init_fn, step_fn = jax_train.make_train_step(
                lambda p, t, y, cfg=cfg: jax_llama.loss_fn(p, t, y, cfg),
                jax_train.default_optimizer(learning_rate=1e-2,
                                            total_steps=20),
                mesh, jax_llama.param_annotations(cfg), donate=False)
            initial = _initial(key[0])
            state = init_fn(jax.random.PRNGKey(0), lambda k, p=initial:
                            jax.tree.map(jnp.asarray, p))
            steps[key] = (mesh, state, step_fn)
        mesh, state, step_fn = steps[key]
        losses, norms = [], []
        for _ in range(STEPS):
            state, metrics = step_fn(state, *(
                jax_train.shard_batch(jnp.asarray(x, jnp.int32), mesh)
                for x in (tokens[:, :-1], _targets(tokens, masked))))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out[name] = (losses, norms, jax.tree.map(np.array, state.params))
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The gang of 8: every case's run and the `SAME_AS` runs, grouped
    by config into `train_on_meshes` calls; then the MoE checkpoint
    round trip on fsdp 2 x sp 2 x tp 2. Returns ({name: (rank 0's
    result, routes)}, every rank's checkpoint result)."""
    tokens = _tokens()
    named = {name: (config, axes, masked)
             for name, (config, axes, masked) in CASES.items()}
    named.update({name: (config, CASES[base][1], CASES[base][2])
                  for name, (base, config) in SAME_AS.items()})
    jobs, names = [], []
    for config in (DENSE, RING, MOE, DOTS_FLASH):
        mine = [n for n, (c, _, _) in named.items() if c == config]
        runs = [(MeshSpec(**named[n][1]), tokens, STEPS,
                 _targets(tokens, named[n][2])) for n in mine]
        start = _start(DENSE if config == DOTS_FLASH else config)
        jobs.append((config, runs, start))
        names.append(mine)
    path = str(tmp_path_factory.mktemp("seq_moe") / "ckpt")
    ranks = run_local_gang(_torch_gang.sequence_and_expert_meshes, 8,
                           (jobs, path, _tokens(seed=13)), device="cpu",
                           timeout=GANG_TIMEOUT)
    by_name = {}
    for job, mine in zip(ranks[0][0], names):
        results, routes = job
        for n, result in zip(mine, results):
            by_name[n] = (result, routes)
    return by_name, [r[1] for r in ranks]


def _held_to_jax(got, losses, norms, final, config):
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=RTOL)
    params = llama.to_jax_params(
        {k: torch.from_numpy(v) for k, v in got["final"].items()},
        llama.LlamaConfig.tiny(**config))
    jax.tree.map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=RTOL,
                                                atol=PARAM_ATOL),
        params, final)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", list(CASES) + list(SAME_AS))
def test_step_matches_jax_on_the_same_mesh(jax_runs, port_runs, name):
    """Losses, grad norms and parameters after 3 steps equal JAX's on
    the same mesh: the sequence shards' gradients summed over sp once,
    the norms' too, RoPE at each shard's own positions, the router's
    statistics over every token, the experts' partial sums over tp."""
    base, config = SAME_AS[name] if name in SAME_AS else (name,
                                                          CASES[name][0])
    got = port_runs[0][name][0]
    want_axes = {"dcn_dp": 1, "pp": 1, "dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    want_axes.update(CASES[base][1])
    assert got["mesh"] == want_axes
    _held_to_jax(got, *jax_runs[base], config)


@pytest.mark.timeout(300)
def test_unevenly_masked_sequence_halves_change_the_loss(jax_runs):
    """The mask bites: the four (fsdp, sp) shards of the masked batch
    keep 64, 0, 39 and 64 of their 64 targets, so a mean of the shards'
    means would weigh them wrongly, and the loss differs from the
    unmasked one's."""
    masked = jax_runs["masked_fsdp2_sp2_tp2"][0][0]
    assert abs(masked - jax_runs["fsdp2_sp2_tp2"][0][0]) > 1e-3


@pytest.mark.timeout(300)
def test_flash_runs_ulysses_or_the_ring_route(port_runs):
    """Under sp, "flash" runs Ulysses over the flash op wherever sp
    divides the local heads, and on CPU tensors ring attention where it
    does not (tiny's 4 heads at tp 2 x sp 4); "ring" runs ring
    attention."""
    by_name = port_runs[0]
    # The dense job ran fsdp2_sp2_tp2 and dp2_sp4 (Ulysses) and
    # tp2_sp4 (ring): both routes.
    dense_routes = by_name["fsdp2_sp2_tp2"][1]
    assert dense_routes["ulysses_attention"] > 0
    assert dense_routes["ring_attention"] > 0
    ring_routes = by_name["ring_fsdp4_sp2"][1]
    assert ring_routes["ulysses_attention"] == 0
    assert ring_routes["ring_attention"] > 0
    flash_routes = by_name["dots_flash_fsdp2_sp2_tp2"][1]
    assert flash_routes["ring_attention"] == 0
    assert flash_routes["ulysses_attention"] > 0


@pytest.mark.timeout(300)
def test_moe_checkpoint_on_sp_tp_mesh_restores_bit_for_bit(port_runs):
    for r in port_runs[1]:
        assert r["bitwise"] and not r["jax_loaded"]
        assert r["step"] == 2 and r["count"] == 2
        assert r["losses"][0] == r["losses"][1]
    assert port_runs[1][0]["files"] == [".metadata"] + [
        f"__{i}_0.distcp" for i in range(8)]


@pytest.fixture(scope="module")
def pair():
    """`_torch_gang.ulysses_flash_and_tp_experts` in a gang of 2, and
    its inputs."""
    rng = np.random.default_rng(3)
    qkv = [rng.standard_normal((2, 4, 32, 16), dtype=np.float32)
           for _ in range(3)]
    do = rng.standard_normal((2, 4, 32, 16), dtype=np.float32)
    params = {k: v.numpy() for k, v in init_moe_params(
        4, 16, 32, torch.Generator().manual_seed(0), device="cpu").items()}
    x = rng.standard_normal((24, 16), dtype=np.float32)
    g = rng.standard_normal((24, 16), dtype=np.float32)
    inputs = (qkv, do, params, x, g, 0.01)
    return inputs, run_local_gang(_torch_gang.ulysses_flash_and_tp_experts,
                                  2, inputs, device="cpu",
                                  timeout=GANG_TIMEOUT)


@pytest.mark.timeout(300)
def test_ulysses_over_the_flash_op_equals_mha_reference(pair):
    """Each rank's output and q/k/v gradients are its sequence shard of
    JAX's `mha_reference` over the whole sequence and of its vjp."""
    (qkv, do, *_), ranks = pair
    out, vjp = jax.vjp(
        lambda q, k, v: jax_attention.mha_reference(q, k, v, causal=True),
        *(jnp.asarray(a) for a in qkv))
    grads = vjp(jnp.asarray(do))
    for rank, (attention, _, _) in enumerate(ranks):
        got_out, got_grads = attention
        shard = slice(rank * 16, (rank + 1) * 16)
        np.testing.assert_allclose(got_out, np.asarray(out)[:, :, shard],
                                   rtol=1e-5, atol=1e-5)
        for got, want in zip(got_grads, grads):
            np.testing.assert_allclose(got, np.asarray(want)[:, :, shard],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.timeout(300)
def test_tp_split_expert_products_equal_moe_ffn_dense(pair):
    """Output, aux loss and every gradient of `moe_ffn_dense` with its
    experts split over a tp group of 2 ranks equal the JAX package's
    `moe_ffn_dense` and its vjp: the router's and x's whole on each
    rank (the tp convention: every rank holds the same loss, x's
    gradient is summed over the ranks' partial products exactly once),
    w_in's and w_out's the rank's mlp shards."""
    (_, _, params, x, g, aux_weight), ranks = pair
    (out, aux), vjp = jax.vjp(
        lambda p, x: jax_moe.moe_ffn_dense(p, x, k=2),
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    grad_params, grad_x = vjp((jnp.asarray(g), jnp.float32(aux_weight)))
    full = [np.asarray(grad_params[k]) for k in ("router", "w_in", "w_out")]
    for rank, (_, experts, _) in enumerate(ranks):
        got_out, got_aux, got_grads = experts
        np.testing.assert_allclose(got_out, np.asarray(out), rtol=1e-5,
                                   atol=1e-5)
        assert abs(got_aux - float(aux)) < 1e-6
        shards = [full[0], np.split(full[1], 2, axis=2)[rank],
                  np.split(full[2], 2, axis=1)[rank], np.asarray(grad_x)]
        for got, want in zip(got_grads, shards):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.timeout(300)
def test_flash_refuses_the_ring_route_off_the_cpu(pair):
    """Where sp does not divide the local heads, "flash" on tensors off
    the CPU raises rather than run the ring's plain products in place of
    the flash kernels."""
    for _, _, refused in pair[1]:
        assert refused is not None and "sp=2" in refused
        assert "3 local heads" in refused
