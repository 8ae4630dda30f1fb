"""The port's MPMD pipeline (`ray_tpu_torch/train/mpmd_pipeline.py`,
`ray_tpu_torch/parallel/schedule.py`) against the JAX package's, on the
CPU: the mirror of `tests/test_pipeline_mpmd.py`.

The schedules of the copy hold every invariant and equal the JAX
module's. The port's multi-process step (`device="cpu"` stage actors of
the port's runtime) is held to the JAX package's single-program loss
and gradients on the same parameters (the JAX init, converted with
`load_jax_params`) and the same numpy batch, in f32: the loss within
2e-5 absolute, the parameters after one SGD step within rtol 2e-4 /
atol 2e-5 (the reference test's bars). Then the GPipe baseline (the
port's `make_pp_train_step` at pp 2 on a gloo gang of 2), the
asynchronous checkpoint round trip, the edges in `diagnose()`, stage
death, a bf16 record through an edge, and the refusal of the card
without one."""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import schedule as jax_schedule
import ray_tpu_torch as rt
from ray_tpu_torch.dag.channels import ChannelTimeoutError, ShmChannel
from ray_tpu_torch.dag.edges import Edge
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel.schedule import (
    interleaved_1f1b,
    max_stash_depth,
    one_f_one_b,
    partition_layers,
    simulate_schedule,
    theoretical_efficiency,
    validate_schedule,
)
from ray_tpu_torch.train import SGD, MPMDPipeline, MPMDPipelineError
from ray_tpu_torch.train.mpmd_pipeline import _channel_capacity
from ray_tpu_torch.train.train_step import AdamW
from ray_tpu_torch.train import run_local_gang

import _torch_gang
from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

#: The reference test's bars (`tests/test_pipeline_mpmd.py`).
LOSS_ABS = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
GPIPE_ABS = 2e-4
#: Later steps of an Adam trajectory: Adam moves every element by about
#: lr whatever its gradient's size, so f32 summation order shows in the
#: later losses more than in the first (ROADMAP queue 3 holds AdamW
#: trajectories' parameters at 1e-4).
ADAM_LOSS_ABS = 1e-4


def _tiny(**kw):
    """(JAX config, port config) of the reference test's `_tiny_cfg`."""
    fields = dict(vocab_size=64, dim=32, n_layers=4, n_heads=2, n_kv_heads=2,
                  intermediate=64, max_seq_len=32)
    fields.update(kw)
    attention = fields.pop("attention", "reference")
    return (jax_llama.LlamaConfig(dtype=jnp.float32, attention="reference",
                                  **fields),
            llama.LlamaConfig(dtype=torch.float32, attention=attention,
                              **fields))


def _jax_params(cfg_j):
    return jax.tree.map(np.asarray,
                        jax_llama.init_params(jax.random.PRNGKey(0), cfg_j))


def _batch(vocab, B, T, seed=1):
    tokens = np.random.default_rng(seed).integers(0, vocab, (B, T + 1))
    return tokens[:, :-1], tokens[:, 1:]


@pytest.fixture
def rt_port():
    """A fresh session of the port's runtime per test."""
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def _build_pipe(cfg, n, m, mb, seq, params, **kw):
    kw.setdefault("hop_timeout_s", 60)
    kw.setdefault("step_timeout_s", 120)
    return MPMDPipeline(cfg, n, num_microbatches=m, microbatch_size=mb,
                        seq_len=seq, params=params, device="cpu", **kw)


# ---------------------------------------------------------------------------
# schedule invariants (pure, no cluster), on the copy
# ---------------------------------------------------------------------------

class TestSchedule:
    @pytest.mark.parametrize(
        "n,m", [(2, 2), (2, 8), (3, 7), (4, 16), (4, 3), (8, 2)]
    )
    def test_1f1b_complete_and_deadlock_free(self, n, m):
        schedules = one_f_one_b(n, m)
        validate_schedule(schedules, n, m)

    @pytest.mark.parametrize(
        "n,m", [(2, 4), (2, 8), (4, 8), (4, 16)]
    )
    def test_1f1b_stash_depth_bounded_by_stages(self, n, m):
        """The 1F1B property: the activation stash stays O(n_stages),
        not O(num_microbatches) like GPipe."""
        for ops in one_f_one_b(n, m):
            assert max_stash_depth(ops) <= n
        if m > n:
            gpipe_stage0 = [("F", 0, i) for i in range(m)] + [
                ("B", 0, i) for i in range(m)
            ]
            assert max_stash_depth(gpipe_stage0) == m

    @pytest.mark.parametrize("n,m", [(4, 1), (4, 2), (8, 3)])
    def test_no_deadlock_when_fewer_microbatches_than_stages(self, n, m):
        schedules = one_f_one_b(n, m)
        validate_schedule(schedules, n, m)

    @pytest.mark.parametrize(
        "n,m,v", [(2, 4, 2), (2, 8, 3), (4, 8, 2), (3, 5, 2)]
    )
    def test_interleaved_complete_and_deadlock_free(self, n, m, v):
        schedules = interleaved_1f1b(n, m, v)
        validate_schedule(schedules, n, m, v)

    def test_interleaved_v1_degenerates_to_1f1b(self):
        assert interleaved_1f1b(4, 8, 1) == one_f_one_b(4, 8)

    def test_validator_rejects_deadlock_and_duplicates(self):
        good = one_f_one_b(2, 2)
        bad = [list(ops) for ops in good]
        bad[1] = [bad[1][1], bad[1][0]] + bad[1][2:]
        with pytest.raises(ValueError):
            validate_schedule(bad, 2, 2)
        dup = [list(ops) for ops in good]
        dup[0][1] = dup[0][0]
        with pytest.raises(ValueError):
            validate_schedule(dup, 2, 2)

    def test_bounded_depth_deadlock_dies_at_validation(self):
        deep = interleaved_1f1b(2, 16, 5)
        with pytest.raises(ValueError, match="channel_depth"):
            validate_schedule(deep, 2, 16, 5, channel_depth=4)
        validate_schedule(deep, 2, 16, 5, channel_depth=8)
        for n, m, v in [(2, 8, 1), (4, 16, 1), (2, 8, 2)]:
            validate_schedule(
                interleaved_1f1b(n, m, v), n, m, v, channel_depth=4
            )
        validate_schedule(one_f_one_b(4, 8), 4, 8, channel_depth=1)

    def test_driver_rejects_undeep_channels_at_construction(self):
        """MPMDPipeline refuses to build (no actors, no channels, no
        runtime needed) when the schedule cannot execute under the
        configured channel depth; the geometry is checked before the
        device."""
        _, cfg = _tiny(n_layers=10)
        with pytest.raises(ValueError, match="channel_depth"):
            MPMDPipeline(
                cfg, 2, num_microbatches=16, microbatch_size=2,
                seq_len=16, chunks_per_stage=5, channel_depth=4,
            )

    def test_replay_matches_theoretical_bound_at_uniform_cost(self):
        for n, m in [(2, 8), (4, 16), (3, 9)]:
            sim = simulate_schedule(
                one_f_one_b(n, m), lambda k, c, mb: 1.0
            )
            assert sim["efficiency"] == pytest.approx(
                theoretical_efficiency(n, m), rel=1e-9
            )

    def test_partition_balances_asymmetric_ends(self):
        assert partition_layers(8, 2) == [(0, 4), (4, 8)]
        bounds = partition_layers(8, 2, head_ms=3.0)
        assert bounds[1][1] - bounds[1][0] < 4
        costs = [1, 1, 4, 1, 1, 1]
        bounds = partition_layers(6, 2, costs)
        spans = [sum(costs[lo:hi]) for lo, hi in bounds]
        assert max(spans) <= 6

    @pytest.mark.parametrize("n,m,v", [
        (n, m, v) for n in (2, 3, 4) for m in (1, 3, 4, 8)
        for v in (1, 2, 3)])
    def test_schedules_equal_the_jax_modules(self, n, m, v):
        assert interleaved_1f1b(n, m, v) == jax_schedule.interleaved_1f1b(
            n, m, v)
        if v == 1:
            assert one_f_one_b(n, m) == jax_schedule.one_f_one_b(n, m)
        assert theoretical_efficiency(n, m, v) == \
            jax_schedule.theoretical_efficiency(n, m, v)
        layers = 2 * n * v + 1
        assert partition_layers(layers, n * v, head_ms=1.5) == \
            jax_schedule.partition_layers(layers, n * v, head_ms=1.5)


# ---------------------------------------------------------------------------
# the MPMD step against the JAX package's single-program truths
# ---------------------------------------------------------------------------

def _assert_params(got_state, want_tree, cfg):
    got = llama.to_jax_params(got_state, cfg)
    for key in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(got[key], want_tree[key], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=key)
    assert set(got["layers"]) == set(want_tree["layers"])
    for key, want in want_tree["layers"].items():
        np.testing.assert_allclose(got["layers"][key], want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_mpmd_loss_and_grad_parity_vs_jax_single_program(rt_port, attention):
    """Loss and gradients of the port's 1F1B multi-process step equal the
    JAX package's single-program `loss_fn` and `jax.grad` on the same
    parameters: the gradients through one SGD update (params - lr *
    grad, leaf for leaf). Under "flash" the port's chunks run the flash
    op (its plain version on the CPU)."""
    cfg_j, cfg = _tiny(attention=attention)
    B, T, m = 4, 16, 2
    params = _jax_params(cfg_j)
    pipe = _build_pipe(cfg, 2, m, B // m, T,
                       llama.load_jax_params(params, cfg),
                       optimizer_factory=functools.partial(SGD, 0.1))
    try:
        inp, tgt = _batch(cfg.vocab_size, B, T)
        out = pipe.step(inp, tgt)
        ref_loss = float(jax_llama.loss_fn(params, inp, tgt, cfg_j))
        assert out["loss"] == pytest.approx(ref_loss, abs=LOSS_ABS)
        for stage in out["stages"]:
            assert stage["stash_peak"] <= pipe.stash_bound <= 2
            assert stage["busy_ms"] > 0
            assert isinstance(stage["edges"], list)
        grads = jax.grad(lambda p: jax_llama.loss_fn(p, inp, tgt, cfg_j))(
            params)
        want = jax.tree.map(lambda p, g: p - 0.1 * np.asarray(g), params,
                            grads)
        _assert_params(pipe.collect_params(), want, cfg)
    finally:
        pipe.shutdown()


def test_mpmd_matches_single_program_gpipe_baseline(rt_port):
    """The same loss as the port's `make_pp_train_step` (GPipe in one
    SPMD program) at pp 2 on a gloo gang of 2, at identical geometry."""
    _, cfg = _tiny()
    B, T, m = 4, 16, 2
    state = llama.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu").state_dict()
    pipe = _build_pipe(cfg, 2, m, B // m, T, state)
    try:
        inp, tgt = _batch(cfg.vocab_size, B, T)
        mpmd_loss = pipe.step(inp, tgt)["loss"]
    finally:
        pipe.shutdown()
    tokens = np.concatenate([inp, tgt[:, -1:]], axis=1)
    start = {k: v.numpy() for k, v in state.items()}
    runs = [(2, 1, 1, cfg, start, tokens, 1, m, 3e-4, 10)]
    ranks = run_local_gang(_torch_gang.pipeline_runs, 2, (runs,),
                           device="cpu", timeout=100)
    for (run,) in ranks:
        assert not run["jax_loaded"]
        assert mpmd_loss == pytest.approx(run["losses"][0], abs=GPIPE_ABS)
        assert mpmd_loss == pytest.approx(run["loss_fn"], abs=LOSS_ABS)


def test_mpmd_interleaved_parity_over_four_steps(rt_port):
    """The interleaved schedule (2 stages of 2 chunks) follows the JAX
    package's single-program trajectory under the same Adam (optax
    `adamw(5e-3)`: no global clip, so a stage's own update is the
    whole program's) for 4 steps, and the loss falls. Edges are reused
    across steps: a rewiring bug shows as a desync here."""
    cfg_j, cfg = _tiny()
    B, T, m = 4, 16, 4
    params = _jax_params(cfg_j)
    def factory():
        return AdamW(lambda count: 5e-3, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=1e-4, grad_clip=float("inf"))
    pipe = _build_pipe(cfg, 2, m, B // m, T,
                       llama.load_jax_params(params, cfg),
                       chunks_per_stage=2, optimizer_factory=factory)
    try:
        assert pipe.V == 4 and len(pipe.bounds) == 4
        inp, tgt = _batch(cfg.vocab_size, B, T)
        losses = [pipe.step(inp, tgt)["loss"] for _ in range(4)]
    finally:
        pipe.shutdown()
    opt = optax.adamw(5e-3)
    p, opt_state = params, opt.init(params)
    want = []
    for _ in range(4):
        loss, g = jax.value_and_grad(
            lambda q: jax_llama.loss_fn(q, inp, tgt, cfg_j))(p)
        want.append(float(loss))
        updates, opt_state = opt.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)
    assert losses[0] == pytest.approx(want[0], abs=LOSS_ABS)
    assert losses == pytest.approx(want, abs=ADAM_LOSS_ABS)
    assert losses[-1] < losses[0]


def test_mpmd_stage_programs_keep_one_signature_each(rt_port):
    """Every stage program is registered with the compile watch in its
    stage's process under the JAX package's names, and keeps the
    signatures of its first step over every step (2 stages x 2 chunks,
    3 steps): one each, but `acc`'s, one per chunk's gradient list, as
    the JAX package's one `acc` program compiles per chunk."""
    cfg_j, cfg = _tiny()
    B, T, m = 4, 16, 4
    pipe = _build_pipe(cfg, 2, m, B // m, T,
                       llama.load_jax_params(_jax_params(cfg_j), cfg),
                       chunks_per_stage=2,
                       optimizer_factory=functools.partial(SGD, 0.1))
    try:
        inp, tgt = _batch(cfg.vocab_size, B, T)
        for _ in range(3):
            pipe.step(inp, tgt)
        counts = rt.get([s.compile_counts.remote() for s in pipe.stages],
                        timeout=60)
    finally:
        pipe.shutdown()
    assert [sorted(c) for c in counts] == [
        ["acc", "bwd:0", "bwd:2", "fwd:0", "fwd:2", "opt"],
        ["acc", "bwd:1", "bwd:3", "fwd:1", "opt"]]
    for stage in counts:
        for key, row in stage.items():
            n = 2 if key == "acc" else 1
            assert row == {"compiles": n, "distinct_shapes": n,
                           "signatures": n}, (key, row)


def test_mpmd_checkpoint_roundtrip_async_barrier(rt_port, tmp_path):
    """save_checkpoint(async) + wait_for_checkpoints (the durability
    barrier) + restore: parameters survive byte-exact across further
    training."""
    cfg_j, cfg = _tiny(n_layers=2)
    B, T, m = 4, 16, 2
    pipe = _build_pipe(cfg, 2, m, B // m, T,
                       llama.load_jax_params(_jax_params(cfg_j), cfg),
                       optimizer_factory=functools.partial(SGD, 0.1))
    try:
        inp, tgt = _batch(cfg.vocab_size, B, T)
        pipe.step(inp, tgt)
        snap = pipe.collect_params()
        save_step = pipe._step_index
        root = str(tmp_path / "ckpt")
        pipe.save_checkpoint(root, async_save=True)
        # Keep training while the save persists in the background.
        pipe.step(inp, tgt)
        pipe.wait_for_checkpoints()
        drifted = pipe.collect_params()
        assert not torch.allclose(drifted["lm_head.weight"],
                                  snap["lm_head.weight"])
        pipe.restore_checkpoint(root, save_step)
        restored = pipe.collect_params()
        assert torch.equal(restored["lm_head.weight"], snap["lm_head.weight"])
        assert torch.equal(restored["layers.0.wq.weight"],
                           snap["layers.0.wq.weight"])
        assert (tmp_path / "ckpt" / f"step-{save_step:08d}" / "stage-1"
                / "metadata.json").is_file()
    finally:
        pipe.shutdown()


def test_mpmd_edges_visible_in_doctor(rt_port):
    """Per-edge channel counters (dag/edges.py) reach the head and fold
    into the doctor verdict — a straggler stage is nameable."""
    _, cfg = _tiny(n_layers=2)
    B, T, m = 4, 16, 4
    pipe = _build_pipe(cfg, 2, m, B // m, T, None)
    try:
        inp, tgt = _batch(cfg.vocab_size, B, T)
        for _ in range(2):
            pipe.step(inp, tgt)
        deadline = time.monotonic() + 20
        dag = {}
        while time.monotonic() < deadline:
            dag = rt.diagnose(capture_stacks=False).get("dag", {})
            row = dag.get("edges", {}).get("s0->s1:b0", {})
            if row.get("hops", 0) >= 2 * m:
                break
            time.sleep(0.5)
        edges = dag.get("edges", {})
        assert "s0->s1:b0" in edges and "s1->s0:b0" in edges
        row = edges["s0->s1:b0"]
        assert row["hops"] >= 2 * m
        assert row["bytes"] > 0
        assert "recv_wait_ms" in row or "send_wait_ms" in row
    finally:
        pipe.shutdown()


def test_mpmd_stage_death_fails_step_cleanly(rt_port):
    """Chaos: killing a stage worker mid-step fails the step with
    MPMDPipelineError — the surviving stage unblocks via edge closure
    instead of hanging on its channel peer. The kill waits for the
    step's first hop on edge s0->s1:b0 (its ring's head moves), so it
    lands inside the step however loaded the machine is."""
    _, cfg = _tiny(n_layers=2, dim=64, intermediate=128)
    B, T, m = 64, 32, 32
    pipe = _build_pipe(cfg, 2, m, B // m, T, None, hop_timeout_s=30,
                       step_timeout_s=45)
    try:
        inp, tgt = _batch(cfg.vocab_size, B, T)
        pipe.step(inp, tgt)  # warm the stages
        ring = pipe._edges_by_boundary[(0, "fwd")].channel
        head = ring._u64[0]
        result = {}

        def stepper():
            try:
                pipe.step(inp, tgt)
                result["ok"] = True
            except BaseException as e:  # noqa: BLE001 — recorded
                result["err"] = e

        thread = threading.Thread(target=stepper)
        thread.start()
        deadline = time.monotonic() + 30
        while ring._u64[0] == head and time.monotonic() < deadline:
            time.sleep(0.001)
        assert ring._u64[0] != head, "the step made no first hop"
        rt.kill(pipe.stages[1])
        thread.join(timeout=60)
        assert not thread.is_alive(), "step hung after stage death"
        assert isinstance(result.get("err"), MPMDPipelineError), result
        # The pipeline is marked broken — further steps refuse fast.
        with pytest.raises(MPMDPipelineError):
            pipe.step(inp, tgt)
    finally:
        pipe.shutdown()


def test_a_killed_stage_frees_its_share_for_the_next_stages(rt_port):
    """Stage actors created while the killed stages of the last pipeline
    still hold the node's resources start once those die: the share a
    dead actor frees is dispatched to queued creations at once (the
    copied runtime dispatched only at the next unrelated event, so a
    pipeline built right after `shutdown()` waited out its ping)."""
    class Holder:  # local: pickled by value, the workers cannot import us
        def ping(self):
            return True

    cls = rt.remote(num_cpus=2)(Holder)
    old = [cls.remote() for _ in range(2)]
    assert rt.get([a.ping.remote() for a in old], timeout=60) == [True] * 2
    new = [cls.remote() for _ in range(2)]
    refs = [a.ping.remote() for a in new]
    ready, _ = rt.wait(refs, num_returns=2, timeout=1.0)
    assert not ready  # queued: the node's 4 CPUs are held
    for a in old:
        rt.kill(a)
    assert rt.get(refs, timeout=30) == [True] * 2
    for a in new:
        rt.kill(a)


def test_bf16_record_crosses_an_edge_and_fits_its_capacity():
    """An activation record in bf16 (a CPU tensor: numpy has no
    bfloat16) crosses an edge with its dtype and values, `depth` such
    records fit `_channel_capacity`, and one more blocks (the bounded
    depth is the backpressure)."""
    cfg = llama.LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=2,
                            n_kv_heads=2, intermediate=64,
                            dtype=torch.bfloat16)
    # A record larger than the slack of the whole ring, as at every
    # real width (at the 7B width one is 32 MiB against 20 KiB).
    mb, seq, depth = 2, 256, 3
    ring = ShmChannel(_channel_capacity(cfg, mb, seq, depth))
    edge = Edge(ring, "s0->s1:b0", "fwd")
    try:
        g = torch.Generator().manual_seed(3)
        sent = [torch.randn(mb, seq, cfg.dim, generator=g).to(torch.bfloat16)
                for _ in range(depth)]
        for i, y in enumerate(sent):
            edge.put_value((("F", 1, i), y), timeout=5)
        with pytest.raises(ChannelTimeoutError):
            edge.put_value((("F", 1, depth), sent[0]), timeout=0.2)
        for i, y in enumerate(sent):
            tag, got = edge.get_value(timeout=5)
            assert tag == ("F", 1, i)
            assert got.dtype == torch.bfloat16 and torch.equal(got, y)
    finally:
        edge.close()
        edge.unlink()


def test_cuda_device_without_a_card_raises_at_construction():
    """`device="cuda"`, the default, on a machine without a card: the
    constructor raises before any actor or channel exists."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    _, cfg = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        MPMDPipeline(cfg, 2, num_microbatches=2, microbatch_size=2,
                     seq_len=16)
