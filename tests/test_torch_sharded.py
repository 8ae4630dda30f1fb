"""The port's sharded train step in real process groups: spawned gangs
of gloo processes on the CPU (`ray_tpu_torch.train.run_local_gang`),
each rank running port code only (`ray_tpu_torch.graft_entry.
train_on_meshes`, `_torch_gang.py`), held to the JAX package's
`make_train_step` on the same mesh shape over the 8 virtual CPU devices
(`tests/conftest.py`), in f32, on the same parameters (JAX init through
`load_jax_params`) and batch, with `default_optimizer(learning_rate=
1e-2, total_steps=20)` on both sides.

Each gang has its own timeout (the marker's is above it): a hung rank
fails its test, and every process is joined or killed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.train import train_step as jax_train
from ray_tpu_torch import graft_entry
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train import restore_checkpoint, run_local_gang

import _torch_gang
from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

STEPS = 3
#: f32 on both sides, as `test_torch_train.py`: the losses and norms to
#: f32 summation order. Adam moves every element by about lr (1e-2)
#: whatever its gradient's size, so an element whose gradient is near 0,
#: where the two frameworks' sharded f32 sums differ most (four data
#: shards and the tp partial sums, added in different orders), may
#: differ by a tenth of lr (one of 16,384 in wq reads 2.5e-4).
RTOL, PARAM_ATOL = 1e-4, 1e-3
#: JAX's bar for the two-slice check (`__graft_entry__.py`).
TWO_SLICE_TOL = 5e-4
GANG_TIMEOUT = 200


def _tokens(rows, vocab, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (rows, 33))


def _masked_targets(tokens):
    """The batch's targets, masked unevenly across the four data shards
    of dp 2 x fsdp 2 (two rows each): they keep 4, 64, 48 and 64 of
    their 64 targets."""
    targets = tokens[:, 1:].copy()
    targets[0, 4:] = -1
    targets[1, :] = -1
    targets[4, 16:] = -1
    return targets


@pytest.fixture(scope="module")
def jax_run():
    """Initial parameters (as the port's state dict), and per-step
    metrics and final parameters of three JAX steps on dp 2 x fsdp 2 x
    tp 2: on the batch's shifted tokens, then from the same start on
    `_masked_targets`."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg = jax_llama.LlamaConfig.tiny()
    mesh = JaxMeshSpec(dp=2, fsdp=2, tp=2).build(jax.devices()[:8])
    init_fn, step_fn = jax_train.make_train_step(
        lambda p, t, y: jax_llama.loss_fn(p, t, y, cfg),
        jax_train.default_optimizer(learning_rate=1e-2, total_steps=20),
        mesh, jax_llama.param_annotations(cfg), donate=False)
    start_state = init_fn(jax.random.PRNGKey(0),
                          lambda k: jax_llama.init_params(k, cfg))
    initial = jax.tree.map(np.array, start_state.params)
    tokens = _tokens(8, cfg.vocab_size)

    def put(x):
        return jax_train.shard_batch(jnp.asarray(x, jnp.int32), mesh,
                                     logical_axes=("batch", None))

    def steps(inputs, targets):
        state, losses, norms = start_state, [], []
        for _ in range(STEPS):
            state, metrics = step_fn(state, put(inputs), put(targets))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        return losses, norms, jax.tree.map(np.array, state.params)

    port_cfg = llama.LlamaConfig.tiny()
    start = {k: v.numpy() for k, v in
             llama.load_jax_params(initial, port_cfg).items()}
    return (start, tokens, *steps(tokens[:, :-1], tokens[:, 1:]),
            steps(tokens[:, :-1], _masked_targets(tokens)))


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's three steps in a gang of 8, on the shifted tokens and
    on the masked targets: one result per rank, one entry per run."""
    start, tokens = jax_run[:2]
    runs = [(MeshSpec(dp=2, fsdp=2, tp=2), tokens, STEPS),
            (MeshSpec(dp=2, fsdp=2, tp=2), tokens, STEPS,
             _masked_targets(tokens))]
    return run_local_gang(graft_entry.train_on_meshes, 8,
                          (llama.LlamaConfig.tiny(), runs, start, 1e-2, 20),
                          device="cpu", timeout=GANG_TIMEOUT)


def _held_to_jax(got, losses, norms, final):
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=RTOL)
    cfg = llama.LlamaConfig.tiny()
    params = llama.to_jax_params(
        {k: torch.from_numpy(v) for k, v in got["final"].items()}, cfg)
    jax.tree.map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=RTOL,
                                                atol=PARAM_ATOL),
        params, final)


@pytest.mark.timeout(300)
def test_dp_fsdp_tp_step_matches_jax(jax_run, port_run):
    _, _, losses, norms, final, _ = jax_run
    got = port_run[0][0]
    assert got["mesh"] == {"dcn_dp": 1, "pp": 1, "dp": 2, "fsdp": 2,
                           "sp": 1, "tp": 2}
    _held_to_jax(got, losses, norms, final)


@pytest.mark.timeout(300)
def test_unevenly_masked_targets_match_jax(jax_run, port_run):
    """Each data shard takes the loss of its own rows, JAX one masked
    mean over the whole batch: the port weights each shard by its share
    of the unmasked targets (4, 64, 48 and 64 here), and its losses,
    norms and parameters must come out as JAX's. The mean of the four
    shards' means would put 16 times too much weight on the first."""
    masked, unmasked = jax_run[5], jax_run[2]
    assert abs(masked[0][0] - unmasked[0]) > 1e-3  # the mask bites
    _held_to_jax(port_run[0][1], *masked)


@pytest.mark.timeout(300)
def test_each_rank_holds_its_share_of_the_parameters(port_run):
    """About 1/(fsdp * tp) of the parameter bytes per rank: every weight
    is split 4 ways; the norms (0.3% of the bytes) only over fsdp."""
    cfg = llama.LlamaConfig.tiny()
    whole = cfg.num_params() * 4
    norms = (2 * cfg.n_layers + 1) * cfg.dim * 4
    for rank in port_run:
        local = rank[0]["param_bytes"]
        assert local == (whole - norms) // 4 + norms // 2
        assert abs(local / whole - 0.25) < 0.01


@pytest.mark.timeout(300)
def test_hybrid_two_slice_mesh_equals_flat(tmp_path):
    """dcn_dp=2 x fsdp=2 against fsdp=4, in one gang of 4: pure data
    parallelism across slices changes nothing but summation order."""
    cfg = llama.LlamaConfig.tiny()
    tokens = _tokens(4, cfg.vocab_size, seed=11)
    runs = [(MeshSpec(dcn_dp=2, fsdp=2), tokens, STEPS),
            (MeshSpec(fsdp=4), tokens, STEPS)]
    hybrid, flat = run_local_gang(graft_entry.train_on_meshes, 4,
                                  (cfg, runs, None, 1e-2, 20),
                                  device="cpu", timeout=GANG_TIMEOUT)[0]
    assert hybrid["mesh"]["dcn_dp"] == 2 and flat["mesh"]["fsdp"] == 4
    np.testing.assert_allclose(hybrid["losses"], flat["losses"], rtol=0,
                               atol=TWO_SLICE_TOL)
    assert hybrid["losses"][-1] < hybrid["losses"][0]
    for name, value in hybrid["final"].items():
        np.testing.assert_allclose(value, flat["final"][name], rtol=0,
                                   atol=TWO_SLICE_TOL)


@pytest.mark.timeout(300)
def test_dtensor_checkpoint_of_two_ranks_restores_bit_for_bit(tmp_path):
    path = str(tmp_path / "ckpt")
    tokens = _tokens(4, 256, seed=13)
    results = run_local_gang(_torch_gang.checkpoint_round_trip, 2,
                             (path, tokens), device="cpu",
                             timeout=GANG_TIMEOUT)
    for r in results:
        assert r["bitwise"] and not r["jax_loaded"]
        assert r["step"] == 2 and r["count"] == 2
        assert r["losses"][0] == r["losses"][1]
    # One file of shards per rank, DCP's metadata, and ours last.
    assert results[0]["files"] == [".metadata", "__0_0.distcp",
                                   "__1_0.distcp"]
    assert (tmp_path / "ckpt" / "metadata.json").read_text() == '{"step": 2}'
    # Resharded on the way in: this process, outside any process group,
    # reads both ranks' shards into whole tensors.
    cfg = llama.LlamaConfig.tiny()
    target = {"params": {k: v.clone() for k, v in
                         llama.Llama(cfg, device="cpu").state_dict().items()}}
    whole = restore_checkpoint(path, target)["params"]
    assert all(v.shape == target["params"][k].shape for k, v in whole.items())
    assert not all(bool((v == 0).all()) for v in whole.values())


def test_gang_failure_reports_the_rank_and_joins_every_process():
    with pytest.raises(RuntimeError, match="rank 1"):
        run_local_gang(_torch_gang.fail_on_rank_one, 2, device="cpu",
                       timeout=60)


def test_gang_timeout_kills_a_hung_rank():
    with pytest.raises(TimeoutError):
        run_local_gang(_torch_gang.hang, 2, (30.0,), device="cpu",
                       timeout=8)
