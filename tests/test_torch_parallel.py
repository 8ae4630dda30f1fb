"""The port's mesh and sharding layer (`ray_tpu_torch.parallel`) beside
the JAX package's (`tests/test_parallel.py`), and the layout
`make_train_step` gives the Llama parameters on a dp 2 x fsdp 2 x tp 2
mesh.

Layout only: the port's meshes here live in a single-process fake world
of 8 ranks (`init_process_group("fake", ...)`), which builds every
process group and moves no data; this process is rank 5. The sharded
step's numbers are held to JAX's in `test_torch_sharded.py`, in real
gloo worlds."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import (
    ACT_RULES,
    AXES,
    PARAM_RULES,
    MeshSpec,
    annotate,
    batch_size_per_host,
    placements_for,
    shard_tree,
    spec_for,
)
from ray_tpu_torch.parallel.mesh import data_axes, group_by_slice, model_axes
from ray_tpu_torch.train import default_optimizer, make_train_step

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

RANK, WORLD = 5, 8


@pytest.fixture(scope="module")
def world8():
    dist.init_process_group("fake", store=FakeStore(), rank=RANK,
                            world_size=WORLD)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_axes_match_jax():
    from ray_tpu.parallel import mesh as jax_mesh

    assert AXES == jax_mesh.AXES
    assert data_axes() == jax_mesh.data_axes()
    assert model_axes() == jax_mesh.model_axes()
    assert PARAM_RULES == jax_sharding.PARAM_RULES
    assert ACT_RULES == jax_sharding.ACT_RULES


def test_mesh_spec_build(world8):
    mesh = MeshSpec(fsdp=4, tp=2).build("cpu")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    assert mesh.mesh_dim_names == AXES and mesh.device_type == "cpu"
    assert sizes["fsdp"] == 4 and sizes["tp"] == 2 and sizes["dp"] == 1
    # Row-major: rank 5 is fsdp 2, tp 1.
    assert list(mesh.get_coordinate()) == [0, 0, 0, 2, 0, 1]


def test_mesh_spec_build_spans_the_whole_of_a_bound_group(world8):
    """A NCCL group bound to its card (`init_torch_distributed`) splits
    a mesh's groups on their members only, after which the ranks' later
    groups differ (a four-card run hung so): there `MeshSpec.build`
    refuses a mesh over part of the group, before it makes any group.
    Unbound (gloo) it is built."""
    groups = dist.distributed_c10d._world.pg_map
    assert MeshSpec(fsdp=4).build("cpu").get_coordinate() is None  # rank 5
    group = dist.distributed_c10d._get_default_group()
    group.bound_device_id = torch.device("cuda", 0)
    try:
        before = len(groups)
        with pytest.raises(ValueError, match="whole group"):
            MeshSpec(fsdp=4).build("cpu")
        with pytest.raises(ValueError, match="whole group"):
            MeshSpec(fsdp=2, tp=2).build("cpu", ranks=range(8))
        assert len(groups) == before
        assert MeshSpec(fsdp=4, tp=2).build("cpu").size() == 8
    finally:
        group.bound_device_id = None


def test_a_dropped_fsdp2_model_is_freed_when_the_next_is_laid_out(world8):
    """FSDP2 ties a sharded model into reference cycles, so `del` alone
    does not free it (JAX frees by refcount); laying out the next model
    (`shard_module`, here through `make_train_step`'s init) frees it
    first. With the collector off and no `gc.collect()` here."""
    import gc
    import weakref

    cfg = llama.LlamaConfig.tiny()
    mesh = MeshSpec(fsdp=8).build("cpu")

    def laid_out():
        model = llama.Llama(cfg, device="cpu")
        init_fn, _ = make_train_step(llama.loss_fn, default_optimizer(), mesh,
                                     llama.param_annotations(cfg))
        init_fn(model)
        return weakref.ref(model)

    enabled = gc.isenabled()
    gc.disable()
    try:
        first = laid_out()
        assert first() is not None  # the cycles outlive the last reference
        second = laid_out()
        assert first() is None
        assert second() is not None
    finally:
        if enabled:
            gc.enable()


def test_mesh_auto(world8):
    spec = MeshSpec.auto(8, tp=2)
    assert spec.fsdp == 4
    assert spec.num_devices() == 8
    assert MeshSpec.auto(tp=2) == spec  # the world's size
    with pytest.raises(ValueError, match="divisible"):
        MeshSpec.auto(8, tp=3)


def test_mesh_too_many_devices(world8):
    with pytest.raises(ValueError, match="needs 1024 devices, have 8"):
        MeshSpec(fsdp=1024).build("cpu")


@pytest.mark.parametrize("axes,rules", [
    (("batch", "seq", None), "ACT_RULES"),
    (("embed", "mlp"), "PARAM_RULES"),
    (("vocab", "embed"), "PARAM_RULES"),
    (("layers", "heads", "embed"), "PARAM_RULES"),
    (("batch", "seq", "heads", "head_dim"), "ACT_RULES"),
])
def test_spec_for_rules_match_jax(axes, rules):
    got = spec_for(axes, getattr(jax_sharding, rules))
    assert P(*got) == jax_sharding.spec_for(axes, getattr(jax_sharding, rules))


def test_spec_for_rules():
    assert spec_for(("batch", "seq", None), ACT_RULES) == (
        ("dcn_dp", "dp", "fsdp"), "sp", None)
    assert spec_for(("embed", "mlp"), PARAM_RULES) == ("fsdp", "tp")


def test_placements_for(world8):
    mesh = MeshSpec(dp=2, fsdp=2, tp=2).build("cpu")
    assert placements_for(mesh, ("embed", "mlp"), PARAM_RULES) == [
        Replicate(), Replicate(), Replicate(), Shard(0), Replicate(), Shard(1)]
    # The batch dim is split over every data axis, major to minor.
    assert placements_for(mesh, ("batch", "seq"), ACT_RULES) == [
        Shard(0), Replicate(), Shard(0), Shard(0), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        placements_for(mesh, ("batch",), {"batch": ("fsdp", "dp")})
    with pytest.raises(ValueError, match="more than one dim"):
        placements_for(mesh, ("embed", "mlp"), {"embed": "tp", "mlp": "tp"})


def test_shard_tree(world8):
    mesh = MeshSpec(fsdp=8).build("cpu")
    params = {"w": torch.ones(16, 4), "b": torch.zeros(4)}
    ann = {"w": annotate("embed", "mlp"), "b": annotate("mlp")}
    sharded = shard_tree(mesh, params, ann, PARAM_RULES)
    # w's first dim is sharded 8 ways over fsdp; tp is 1.
    assert isinstance(sharded["w"], DTensor)
    assert sharded["w"].placements[AXES.index("fsdp")] == Shard(0)
    assert sharded["w"].shape == (16, 4)
    assert sharded["w"].to_local().shape == (2, 4)
    torch.testing.assert_close(sharded["w"].to_local(), torch.ones(2, 4))
    assert sharded["b"].to_local().shape == (4,)


def test_hybrid_mesh_dcn_dp(world8):
    """dcn_dp > 1: outer axis = slices (contiguous rank blocks without a
    slice topology), inner axes within one slice."""
    mesh = MeshSpec(dcn_dp=2, fsdp=2, tp=2).build("cpu")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    assert sizes["dcn_dp"] == 2 and sizes["fsdp"] == 2 and sizes["tp"] == 2
    grid = mesh.mesh
    assert set(grid[0].flatten().tolist()) == {0, 1, 2, 3}
    assert set(grid[1].flatten().tolist()) == {4, 5, 6, 7}


def test_hybrid_mesh_follows_the_slices_it_is_given(world8):
    """With a slice topology the outer axis takes one slice per entry,
    whatever the rank order."""
    slice_of = {0: 1, 1: 0, 2: 1, 3: 0, 4: 1, 5: 0, 6: 1, 7: 0}.__getitem__
    mesh = MeshSpec(dcn_dp=2, fsdp=4).build("cpu", slice_of=slice_of)
    grid = mesh.mesh
    assert grid[0].flatten().tolist() == [1, 3, 5, 7]
    assert grid[1].flatten().tolist() == [0, 2, 4, 6]


def test_hybrid_mesh_too_few_devices(world8):
    with pytest.raises(ValueError):
        MeshSpec(dcn_dp=4, fsdp=1024).build("cpu")


def test_hybrid_mesh_uneven_slices_rejected():
    """Too few slices for dcn_dp, and a slice that cannot cover its
    share, both fail before any mesh is made."""
    slices = {0: 0, 1: 0, 2: 1, 3: 0}
    assert [len(g) for g in group_by_slice([0, 1, 2], slices.get)] == [2, 1]
    with pytest.raises(ValueError, match="slices"):
        MeshSpec(dcn_dp=3, fsdp=1).build("cpu", ranks=[0, 1, 2],
                                          slice_of=slices.get)
    with pytest.raises(ValueError, match="per slice"):
        # slice 1 contributes 1 rank, need 2.
        MeshSpec(dcn_dp=2, fsdp=2).build("cpu", ranks=[0, 1, 2, 3],
                                          slice_of=slices.get)


def test_batch_size_per_host(world8):
    mesh = MeshSpec(dp=2, fsdp=2, tp=2).build("cpu")
    assert batch_size_per_host(16, mesh) == 4
    with pytest.raises(ValueError, match="not divisible"):
        batch_size_per_host(6, mesh)


def _jax_leaves():
    cfg = jax_llama.LlamaConfig.tiny(attn_bias=True, qk_norm=True)
    ann = jax_llama.param_annotations(cfg)
    leaves = [(leaf, a) for leaf, a in ann.items() if leaf != "layers"]
    return leaves + list(ann["layers"].items())


@pytest.mark.parametrize("leaf,ann", _jax_leaves(), ids=lambda x: (
    x if isinstance(x, str) else ""))
def test_param_annotations_match_jax(leaf, ann):
    """Each port parameter carries the JAX leaf's logical axes, in the
    port's [out, in] layout and without the stacked layer axis."""
    cfg = llama.LlamaConfig.tiny(attn_bias=True, qk_norm=True)
    port = llama.param_annotations(cfg)
    assert set(port) == set(llama.Llama(cfg, device="meta").state_dict())
    axes = ann.logical_axes
    if leaf in jax_llama.param_annotations(cfg)["layers"]:
        name, transpose = llama._LAYER_LEAVES[leaf]
        axes = axes[1:]
        names = [f"layers.{i}.{name}" for i in range(cfg.n_layers)]
    else:
        name, transpose = {"embed": ("embed.weight", False),
                           "final_norm": ("final_norm", False),
                           "lm_head": ("lm_head.weight", True)}[leaf]
        names = [name]
    want = axes[::-1] if transpose else axes
    for n in names:
        assert port[n].logical_axes == tuple(want), n


def test_train_step_layout_on_dp_fsdp_tp(world8):
    """Each weight is split over fsdp on its embed dim and over tp on its
    heads / mlp / vocab dim, and replicated over dp; the norms, which the
    rules replicate, are left out of FSDP2 and whole on every rank. The
    moments are placed like their parameters."""
    cfg = llama.LlamaConfig.tiny()
    mesh = MeshSpec(dp=2, fsdp=2, tp=2).build("cpu")
    init_fn, _ = make_train_step(llama.loss_fn, default_optimizer(), mesh,
                                 llama.param_annotations(cfg))
    state = init_fn(llama.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
    params = dict(state.params.named_parameters())
    want = {
        "layers.0.wq.weight": ((Replicate(), Shard(1), Shard(0)), (32, 32)),
        "layers.0.wo.weight": ((Replicate(), Shard(0), Shard(1)), (32, 32)),
        "layers.1.w1.weight": ((Replicate(), Shard(1), Shard(0)), (64, 32)),
        "layers.1.w2.weight": ((Replicate(), Shard(0), Shard(1)), (32, 64)),
        "embed.weight": ((Replicate(), Shard(1), Shard(0)), (128, 32)),
        "lm_head.weight": ((Replicate(), Shard(1), Shard(0)), (128, 32)),
    }
    for name, (placements, local) in want.items():
        p = params[name]
        assert isinstance(p, DTensor) and p.device_mesh.device_type == "cpu"
        assert tuple(p.placements) == placements, name
        assert tuple(p.to_local().shape) == local, name
    for name in ("final_norm", "layers.0.attn_norm", "layers.1.mlp_norm"):
        p = params[name]
        assert not isinstance(p, DTensor) and p.shape == (cfg.dim,), name
    for p, mu, nu in zip(params.values(), state.opt_state["mu"],
                         state.opt_state["nu"]):
        assert isinstance(mu, DTensor) == isinstance(p, DTensor) == \
            isinstance(nu, DTensor)
        if isinstance(p, DTensor):
            assert mu.placements == p.placements == nu.placements
            assert mu.to_local().shape == p.to_local().shape
        else:
            assert mu.shape == p.shape == nu.shape


def test_train_step_layout_of_moe_on_fsdp_sp_tp(world8):
    """MoE under tp and sp (`shard_module`): the experts' w_in [E, embed,
    mlp] and w_out [E, mlp, embed] split over fsdp on embed and over tp
    on mlp, the router [embed, E] over fsdp only; the model gets its
    data shards' groups and the sp group of its sequence shard (rank 5
    is fsdp 1, sp 0, tp 1 of fsdp 2 x sp 2 x tp 2)."""
    cfg = llama.LlamaConfig.tiny(moe_experts=4)
    mesh = MeshSpec(fsdp=2, sp=2, tp=2).build("cpu")
    init_fn, _ = make_train_step(llama.loss_fn, default_optimizer(), mesh,
                                 llama.param_annotations(cfg))
    state = init_fn(llama.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
    params = dict(state.params.named_parameters())
    want = {
        "layers.0.w_in": ((Shard(1), Shard(2)), (4, 32, 64)),
        "layers.1.w_out": ((Shard(2), Shard(1)), (4, 64, 32)),
        "layers.0.router": ((Shard(0),), (32, 4)),
        "layers.0.wq.weight": ((Shard(1), Shard(0)), (32, 32)),
    }
    for name, (placements, local) in want.items():
        p = params[name]
        assert isinstance(p, DTensor), name
        assert tuple(p.placements) == placements, name
        assert tuple(p.to_local().shape) == local, name
    model = state.params
    assert dist.get_process_group_ranks(model.seq_group) == [5, 7]
    assert [dist.get_process_group_ranks(g) for g in model.batch_groups] \
        == [[1, 5]]


@pytest.mark.parametrize("spec,error", [
    (MeshSpec(fsdp=4, pp=2), NotImplementedError),
    (MeshSpec(fsdp=4), ValueError),  # a mesh of 4 in a world of 8
])
def test_train_step_refuses_what_it_cannot_run(world8, spec, error):
    with pytest.raises(error):
        make_train_step(llama.loss_fn, default_optimizer(), spec.build("cpu"),
                        llama.param_annotations(llama.LlamaConfig.tiny()))


def test_jax_mesh_layout_is_the_same_rank_order():
    """JAX's mesh over the 8 virtual devices and the port's over 8 ranks
    put the same index at each coordinate."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec

    for kw in ({"dp": 2, "fsdp": 2, "tp": 2}, {"dcn_dp": 2, "fsdp": 2, "tp": 2}):
        jmesh = JaxMeshSpec(**kw).build(jax.devices()[:8])
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        grid = MeshSpec(**kw)._hybrid_grid(list(range(8)), None) \
            if kw.get("dcn_dp", 1) > 1 else np.arange(8).reshape(ids.shape)
        np.testing.assert_array_equal(grid, ids - ids.min())
