"""The port's pipeline (`ray_tpu_torch.parallel.pipeline`) and its
pipeline-parallel step (`ray_tpu_torch.train.make_pp_train_step`) in
one spawned gang of 8 gloo processes (`_torch_gang.pipelines`), held to
the JAX package's under `shard_map` on the 8 virtual CPU devices
(`tests/conftest.py`), in f32, on the same parameters and batch.

- `spmd_pipeline` against the sequential stages, and its gradients, at
  2 and 4 stages;
- three steps of `make_pp_train_step` at (pp, sp, ep) = (2, 1, 1),
  (2, 2, 1) with ring attention, (2, 1, 2) with 4 experts and (2, 2, 2)
  with both: losses and grad norms at RTOL, final parameters as
  `test_torch_sharded.py` holds them (microbatches of different rows,
  so that two microbatches' gradients swapped would show);
- the pp loss against the whole model's `loss_fn`, Gemma conventions
  included;
- `graft_entry.dryrun_pp_sp_ep(8)`.

Mirrors `tests/test_parallel_extras.py` (pipeline against sequential,
pipeline differentiable) and `tests/test_pipeline_flagship.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import pipeline as jax_pipeline
from ray_tpu.parallel.sharding import checked_shard_map
from ray_tpu.train.pipeline_step import make_pp_train_step as jax_pp_step
from ray_tpu.train.train_step import default_optimizer as jax_optimizer
from ray_tpu_torch import graft_entry
from ray_tpu_torch.models import llama
from ray_tpu_torch.train import run_local_gang

import _torch_gang
from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

STEPS = 3
RTOL, PARAM_ATOL = 1e-4, 1e-3
#: The pp loss against the whole model's loss_fn (`tests/
#: test_pipeline_flagship.py`'s bar).
LOSS_TOL = 1e-4
GANG_TIMEOUT = 200
#: (pp, sp, ep, attention, experts, family knobs).
CONFIGS = {
    "pp2": (2, 1, 1, "reference", 0, {}),
    "pp2_sp2_ring": (2, 2, 1, "ring", 0, {}),
    "pp2_ep2_moe": (2, 1, 2, "reference", 4, {}),
    "pp2_sp2_ep2": (2, 2, 2, "ring", 4, {}),
    "pp2_gemma": (2, 1, 1, "reference", 0, dict(
        n_kv_heads=2, custom_head_dim=32, act="gelu_tanh",
        norm_offset=True, embed_scale=True)),
}
#: Configurations also run by the JAX step (the Gemma one is held to
#: loss_fn only, as in `tests/test_pipeline_flagship.py`).
STEPPED = ("pp2", "pp2_sp2_ring", "pp2_ep2_moe", "pp2_sp2_ep2")


def _configs(name):
    _, _, _, attention, experts, knobs = CONFIGS[name]
    kw = dict(vocab_size=128, dim=64, n_layers=4, n_heads=4, n_kv_heads=4,
              intermediate=128, max_seq_len=64, attention=attention,
              moe_experts=experts)
    kw.update(knobs)
    return (jax_llama.LlamaConfig(dtype=jnp.float32, **kw),
            llama.LlamaConfig(dtype=torch.float32, **kw))


def _case(name):
    """JAX's initial parameters and the batch of a configuration: B = 4
    ep rows of 32 tokens, 2 microbatches a data shard."""
    pp, sp, ep, *_ = CONFIGS[name]
    cfg_j, _ = _configs(name)
    tree = jax.tree.map(np.asarray, jax_llama.init_params(
        jax.random.PRNGKey(0), cfg_j))
    tokens = np.random.default_rng(7).integers(0, 128, (4 * ep, 33))
    return tree, tokens


def _stages(n, d=16):
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((d, d)) * 0.3).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def port():
    """Rank by rank: the pipeline primitives, and one result per run."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    runs = []
    for name in CONFIGS:
        pp, sp, ep, *_ = CONFIGS[name]
        tree, tokens = _case(name)
        cfg = _configs(name)[1]
        start = {k: v.numpy() for k, v in
                 llama.load_jax_params(tree, cfg).items()}
        runs.append((pp, sp, ep, cfg, start, tokens, STEPS, 2, 1e-2, 10))
    x = np.random.default_rng(4).standard_normal((8, 2, 16)).astype(
        np.float32)
    return x, run_local_gang(_torch_gang.pipelines, 8, (_stages(4), x, runs),
                             device="cpu", timeout=GANG_TIMEOUT)


def _jax_pp_run(name):
    pp, sp, ep, *_ = CONFIGS[name]
    cfg_j, _ = _configs(name)
    tree, tokens = _case(name)
    mesh = Mesh(np.array(jax.devices()[:pp * sp * ep]).reshape(pp, sp, ep),
                ("pp", "sp", "ep"))
    init_fn, step_fn = jax_pp_step(
        cfg_j, mesh, jax_optimizer(learning_rate=1e-2, total_steps=10),
        num_microbatches=2, donate=False)
    state = init_fn(jax.random.PRNGKey(0),
                    lambda k: jax.tree.map(jnp.asarray, tree))
    t = jnp.asarray(tokens, jnp.int32)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step_fn(state, t[:, :-1], t[:, 1:])
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    params = jax.tree.map(np.array, state.params)
    params["layers"] = {k: v.reshape(-1, *v.shape[2:])
                        for k, v in params["layers"].items()}
    return losses, norms, params


def _stitch(results, cfg, pp):
    """The whole model's state from the stages of the ranks of sp
    coordinate 0: layers renumbered, experts concatenated over ep."""
    per = cfg.n_layers // pp
    state, experts = {}, {}
    for r in results:
        if r is None or r["stage"] is None:
            continue
        p, _, e = r["coord"]
        for k, v in r["stage"].items():
            if not k.startswith("layers."):
                state[k] = v
                continue
            _, j, leaf = k.split(".", 2)
            name = f"layers.{p * per + int(j)}.{leaf}"
            if leaf in ("w_in", "w_out"):
                experts.setdefault(name, {})[e] = v
            else:
                state[name] = v
    for name, parts in experts.items():
        state[name] = np.concatenate([parts[e] for e in sorted(parts)])
    return {k: torch.from_numpy(v) for k, v in state.items()}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n", [2, 4])
def test_spmd_pipeline_matches_sequential_and_jax_gradients(port, n):
    x, results = port
    stages = _stages(4)[:n]
    want = x
    for w in stages:
        want = np.tanh(want @ w)
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))

    def loss(params, mb):
        out = jax_pipeline.spmd_pipeline(
            lambda p, h: jnp.tanh(h @ p["w"]), params, mb)
        return jnp.mean(jax_pipeline.broadcast_from_last_stage(out) ** 2)

    stacked = jax_pipeline.stack_stage_params(
        [{"w": jnp.asarray(w)} for w in stages])
    grads = jax.jit(jax.grad(lambda p: checked_shard_map(
        loss, mesh, (P("pp"), P()), P())(p, jnp.asarray(x))))(stacked)
    for r in range(n):
        out, grad, elsewhere = results[r][0][n]
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(grad, np.asarray(grads["w"][r]), rtol=2e-4,
                                   atol=2e-6)
        assert elsewhere == 0.0  # a rank's gradient stays on its stage


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", STEPPED)
def test_pp_step_matches_jax(port, name):
    pp, sp, ep, *_ = CONFIGS[name]
    losses, norms, final = _jax_pp_run(name)
    runs = [rank[1][list(CONFIGS).index(name)] for rank in port[1]]
    got = runs[0]
    assert got["coord"] == [0, 0, 0] and not got["jax_loaded"]
    for r in runs[:pp * sp * ep]:
        np.testing.assert_allclose(r["losses"], losses, rtol=RTOL)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=RTOL)
    assert all(r is None for r in runs[pp * sp * ep:])
    cfg = _configs(name)[1]
    params = llama.to_jax_params(_stitch(runs, cfg, pp), cfg)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, w, rtol=RTOL, atol=PARAM_ATOL), params, final)
    assert losses[-1] < losses[0]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["pp2", "pp2_sp2_ring", "pp2_gemma"])
def test_pp_loss_matches_whole_model_loss_fn(port, name):
    """Step 1's pp loss is the whole model's `loss_fn` on the same
    parameters and batch (dense models: a MoE aux loss is averaged over
    the shards' own statistics, as JAX's pp step averages it); the Gemma
    configuration's is also JAX's `loss_fn`."""
    got = port[1][0][1][list(CONFIGS).index(name)]
    assert abs(got["losses"][0] - got["loss_fn"]) < LOSS_TOL
    if name == "pp2_gemma":
        cfg_j, _ = _configs(name)
        tree, tokens = _case(name)
        want = float(jax.jit(lambda p, t, y: jax_llama.loss_fn(
            p, t, y, cfg_j))(tree, tokens[:, :-1], tokens[:, 1:]))
        assert abs(got["losses"][0] - want) < LOSS_TOL


@pytest.fixture
def world4():
    """A fake world of 4 ranks: its meshes build every process group and
    move no data."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape,kw,match", [
    # JAX's step would attend within each sequence shard only.
    ((1, 2, 1), {"attention": "reference"}, "ring"),
    ((1, 2, 1), {"attention": "flash"}, "ring"),
    ((4, 1, 1), {}, "divisible"),  # 2 layers over 4 stages
])
def test_pp_step_refuses(world4, shape, kw, match):
    from ray_tpu_torch.parallel import pipeline_mesh
    from ray_tpu_torch.train import default_optimizer, make_pp_train_step

    cfg = llama.LlamaConfig.tiny(**kw)
    with pytest.raises(ValueError, match=match):
        make_pp_train_step(cfg, pipeline_mesh(*shape, device="cpu"),
                           default_optimizer())


def test_pipeline_mesh_spans_the_whole_of_a_bound_group(world4):
    """A NCCL group bound to its card (`init_torch_distributed`) splits
    a mesh's groups on their members only, after which the ranks' later
    groups differ (a four-card run hung so): there a mesh over part of
    the group is refused. Unbound (gloo) it is built."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import pipeline_mesh

    assert list(pipeline_mesh(1, 2, 1, device="cpu").get_coordinate()) == [0, 0, 0]
    group = dist.distributed_c10d._get_default_group()
    group.bound_device_id = torch.device("cuda", 0)
    try:
        with pytest.raises(ValueError, match="whole group"):
            pipeline_mesh(1, 2, 1, device="cpu")
        assert pipeline_mesh(2, 2, 1, device="cpu").size() == 4
    finally:
        group.bound_device_id = None


def test_pp_step_refuses_a_batch_that_does_not_split(world4):
    from ray_tpu_torch.parallel import pipeline_mesh
    from ray_tpu_torch.train import default_optimizer, make_pp_train_step

    cfg = llama.LlamaConfig.tiny()
    mesh = pipeline_mesh(1, 1, 4, device="cpu")
    init_fn, step_fn = make_pp_train_step(cfg, mesh, default_optimizer(),
                                          num_microbatches=2)
    state = init_fn(llama.Llama(cfg, device="cpu"))
    tokens = torch.zeros(4, 8, dtype=torch.long)  # 4 rows, 8 needed
    with pytest.raises(ValueError, match="divide"):
        step_fn(state, tokens, tokens)


@pytest.mark.timeout(300)
def test_dryrun_pp_sp_ep_runs_on_eight_ranks(capsys):
    """`graft_entry.dryrun_multichip`'s pp/sp/ep part: the flagship at
    pp 2 x sp 2 x ep 2 with ring attention and 4 experts, whose loss
    falls over 3 steps, and the pipeline, ring/Ulysses and MoE
    primitives on 4 ranks."""
    flagship, parts = graft_entry.dryrun_pp_sp_ep(8, timeout=GANG_TIMEOUT)
    assert flagship["mesh"] == {"pp": 2, "sp": 2, "ep": 2}
    assert flagship["moe_experts"] == 4
    assert flagship["losses"][-1] < flagship["losses"][0]
    assert set(parts) == {"pp_grad", "sp_out", "ep_grad"}
    out = capsys.readouterr().out
    assert "dryrun flagship OK" in out and "dryrun pp/sp/ep OK" in out
