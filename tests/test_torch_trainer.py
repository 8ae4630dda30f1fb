"""The port's trainer, checkpoints, sessions and device prefetch
(`ray_tpu_torch.train`), mirroring `tests/test_train.py`'s
`TestCheckpoint`, `TestAsyncCheckpoint`, the local tests of
`TestJaxTrainer` and `test_prefetch_to_device_order_and_residency`, on
the CPU, in this process (no process group: DCP writes as one process).
The trainer's loss trajectory is held to the JAX package's
`JaxTrainer` on the same parameters."""

import os
import pathlib
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.train import JaxTrainer
from ray_tpu.train import report as jax_report
from ray_tpu.train import train_step as jax_train
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train import (
    CheckpointManager,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
    TorchBackend,
    TorchTrainer,
    default_optimizer,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_device_batches,
    load_metadata,
    make_train_step,
    prefetch_to_device,
    report,
    restore_checkpoint,
    save_checkpoint,
)
from ray_tpu_torch.train import checkpoint as ck

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)


def _state():
    return {"w": torch.arange(16.0).reshape(4, 4), "step": 7,
            "opt": {"mu": torch.ones(3, dtype=torch.bfloat16)}}


def _zeros():
    return {"w": torch.zeros(4, 4), "step": 0,
            "opt": {"mu": torch.zeros(3, dtype=torch.bfloat16)}}


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, _state(), {"note": "test"})
        restored = restore_checkpoint(path, _zeros())
        torch.testing.assert_close(restored["w"], _state()["w"], rtol=0, atol=0)
        assert restored["step"] == 7
        assert torch.equal(restored["opt"]["mu"], _state()["opt"]["mu"])
        assert load_metadata(path) == {"note": "test"}

    def test_restore_writes_into_the_target_in_place(self, tmp_path):
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, _state())
        target = _zeros()
        w = target["w"]
        restore_checkpoint(path, target)
        assert target["w"] is w and torch.equal(w, _state()["w"])

    def test_manager_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), num_to_keep=2)
        for step in [1, 2, 3]:
            mgr.save(step, {"x": torch.tensor(float(step))})
        dirs = sorted(os.listdir(tmp_path))
        assert dirs == ["checkpoint_00000002", "checkpoint_00000003"]
        assert mgr.latest().endswith("checkpoint_00000003")
        assert load_metadata(mgr.latest()) == {"step": 3}


class TestAsyncCheckpoint:
    def test_async_save_restore_roundtrip(self, tmp_path):
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, _state(), {"note": "async"}, async_save=True)
        # restore_checkpoint waits for the in-flight write internally.
        restored = restore_checkpoint(path, _zeros())
        torch.testing.assert_close(restored["w"], _state()["w"], rtol=0, atol=0)
        assert restored["step"] == 7
        assert load_metadata(path)["note"] == "async"

    def test_snapshot_is_taken_before_save_returns(self, tmp_path):
        """The next step updates parameters in place the moment the save
        returns: the checkpoint holds the values at the call."""
        state = {"w": torch.zeros(8)}
        path = str(tmp_path / "ck")
        save_checkpoint(path, state, async_save=True)
        state["w"].add_(1.0)
        assert torch.equal(restore_checkpoint(path, {"w": torch.ones(8)})["w"],
                           torch.zeros(8))

    def test_step_n_plus_1_runs_while_save_n_persists(
        self, tmp_path, monkeypatch
    ):
        """The overlap proof: gate the background write on an event, run
        (and finish) a train step while the writer is provably still
        inside the save, then release it and assert the barrier delivers
        a durable checkpoint."""
        write_started = threading.Event()
        release_write = threading.Event()
        real_write = ck._write_payload

        def gated_write(path, state, metadata):
            write_started.set()
            assert release_write.wait(timeout=30), "writer never released"
            real_write(path, state, metadata)

        monkeypatch.setattr(ck, "_write_payload", gated_write)
        cfg = llama.LlamaConfig.tiny()
        init_fn, step_fn = make_train_step(
            llama.loss_fn, default_optimizer(learning_rate=1e-2, total_steps=20),
            device="cpu")
        state = init_fn(llama.init_params(cfg, torch.Generator().manual_seed(0),
                                          device="cpu"))
        toks = torch.randint(0, cfg.vocab_size, (2, 17),
                             generator=torch.Generator().manual_seed(1))
        path = str(tmp_path / "ck0")
        t0 = time.perf_counter()
        save_checkpoint(path, state.state_dict(), {"step": 0}, async_save=True)
        # save N returned without waiting on the (gated) disk write.
        assert time.perf_counter() - t0 < 5.0
        assert write_started.wait(timeout=10)

        # Step N+1, completed to a host value while the save persists.
        state, metrics = step_fn(state, toks[:, :-1], toks[:, 1:])
        assert metrics["loss"].item() > 0
        assert ck.pending_checkpoints() == [path], (
            "save must still be in flight when step N+1 retires"
        )

        release_write.set()
        ck.wait_for_checkpoints()
        assert ck.pending_checkpoints() == []
        assert (tmp_path / "ck0" / "metadata.json").exists()

    def test_fit_exit_barrier_makes_final_checkpoint_durable(
        self, tmp_path, monkeypatch
    ):
        """fit() must not return while an async save is still in flight:
        the loop issues a slow async save as its final act, and the
        checkpoint must be fully on disk (metadata.json is written last)
        the moment fit() hands back."""
        real_write = ck._write_payload

        def slow_write(path, state, metadata):
            time.sleep(0.8)
            real_write(path, state, metadata)

        monkeypatch.setattr(ck, "_write_payload", slow_write)
        ckpt_dir = str(tmp_path / "final_ck")

        def loop():
            save_checkpoint(ckpt_dir, {"w": torch.ones(8)}, {"step": 1},
                            async_save=True)
            report({"step": 1}, checkpoint=ckpt_dir)

        result = TorchTrainer(loop).fit()
        assert result.error is None
        assert result.checkpoint_path == ckpt_dir
        assert ck.pending_checkpoints() == []
        assert os.path.exists(os.path.join(ckpt_dir, "metadata.json"))

    def test_write_error_surfaces_at_barrier(self, tmp_path, monkeypatch):
        def boom(path, state, metadata):
            raise RuntimeError("disk full")

        monkeypatch.setattr(ck, "_write_payload", boom)
        save_checkpoint(str(tmp_path / "x"), {"w": torch.ones(2)},
                        async_save=True)
        with pytest.raises(RuntimeError, match="disk full"):
            ck.wait_for_checkpoints()
        assert ck.pending_checkpoints() == []

    def test_manager_async_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), num_to_keep=2)
        for step in [1, 2, 3]:
            mgr.save(step, {"x": torch.tensor(float(step))}, async_save=True)
        mgr.wait()
        dirs = sorted(d for d in os.listdir(tmp_path)
                      if d.startswith("checkpoint_"))
        assert dirs == ["checkpoint_00000002", "checkpoint_00000003"]
        assert mgr.latest().endswith("checkpoint_00000003")

    def test_train_state_round_trip(self, tmp_path):
        """A TrainState's state dict (model, moments, counts) restores
        into a fresh state bit for bit, and both then step alike."""
        cfg = llama.LlamaConfig.tiny()
        toks = torch.randint(0, cfg.vocab_size, (2, 17),
                             generator=torch.Generator().manual_seed(2))

        def make(seed):
            init_fn, step_fn = make_train_step(
                llama.loss_fn,
                default_optimizer(learning_rate=1e-2, total_steps=20),
                device="cpu")
            return init_fn(llama.init_params(
                cfg, torch.Generator().manual_seed(seed), device="cpu")), step_fn

        state, step_fn = make(0)
        for _ in range(2):
            state, _ = step_fn(state, toks[:, :-1], toks[:, 1:])
        path = str(tmp_path / "ts")
        save_checkpoint(path, state.state_dict(), async_save=True)
        fresh, _ = make(1)
        fresh.load_state_dict(restore_checkpoint(path, fresh.state_dict()))
        assert fresh.step == 2 and fresh.opt_state["count"] == 2
        for a, b in zip(state.params.state_dict().values(),
                        fresh.params.state_dict().values()):
            assert torch.equal(a, b)
        for key in ("mu", "nu"):
            for a, b in zip(state.opt_state[key], fresh.opt_state[key]):
                assert torch.equal(a, b)
        _, m1 = step_fn(state, toks[:, :-1], toks[:, 1:])
        _, m2 = step_fn(fresh, toks[:, :-1], toks[:, 1:])
        assert m1["loss"].item() == m2["loss"].item()


def _jax_loop_losses(cfg, tokens, steps):
    mesh = JaxMeshSpec(fsdp=1).build(jax.devices()[:1])
    init_fn, step_fn = jax_train.make_train_step(
        lambda p, t, y: jax_llama.loss_fn(p, t, y, cfg),
        jax_train.default_optimizer(learning_rate=1e-2, total_steps=20),
        mesh, jax_llama.param_annotations(cfg), donate=False)
    state = init_fn(jax.random.PRNGKey(0),
                    lambda k: jax_llama.init_params(k, cfg))
    initial = jax.tree.map(np.array, state.params)
    for step in range(steps):
        state, metrics = step_fn(state, tokens[:, :-1], tokens[:, 1:])
        jax_report({"loss": float(metrics["loss"]), "step": step})
    return initial


class TestTorchTrainer:
    def test_fit_local_reports_and_matches_jax_trainer(self):
        cfg_j = jax_llama.LlamaConfig.tiny()
        tokens = np.random.default_rng(1).integers(
            0, cfg_j.vocab_size, (2, 33)).astype(np.int32)
        initial = {}

        def jax_loop(config):
            initial["tree"] = _jax_loop_losses(cfg_j, tokens, config["steps"])

        want = JaxTrainer(jax_loop, train_loop_config={"steps": 3}).fit()
        assert want.error is None
        cfg = llama.LlamaConfig.tiny()

        def train_loop(config):
            model = llama.Llama(cfg, device="cpu")
            model.load_state_dict(llama.load_jax_params(initial["tree"], cfg))
            init_fn, step_fn = make_train_step(
                llama.loss_fn,
                default_optimizer(learning_rate=1e-2, total_steps=20),
                device="cpu")
            state = init_fn(model)
            toks = torch.from_numpy(tokens).long()
            for step in range(config["steps"]):
                state, metrics = step_fn(state, toks[:, :-1], toks[:, 1:])
                report({"loss": metrics["loss"].item(), "step": step})

        result = TorchTrainer(
            train_loop,
            train_loop_config={"steps": 3},
            scaling_config=ScalingConfig(num_workers=1),
        ).fit()
        assert isinstance(result, Result)
        assert result.error is None
        assert len(result.metrics_history) == 3
        assert result.metrics["step"] == 2
        np.testing.assert_allclose(
            [m["loss"] for m in result.metrics_history],
            [m["loss"] for m in want.metrics_history], rtol=1e-4)

    def test_fit_failure_captured(self):
        def bad_loop():
            raise RuntimeError("train loop exploded")

        result = TorchTrainer(bad_loop).fit()
        assert result.error is not None
        assert "exploded" in str(result.error)

    def test_fit_retry_resumes_from_checkpoint(self, tmp_path):
        """A retried attempt restores from the previous attempt's latest
        checkpoint, not from scratch."""
        marker = tmp_path / "attempts"
        marker.write_text("0")

        def loop():
            attempt = int(marker.read_text())
            marker.write_text(str(attempt + 1))
            ckpt = get_checkpoint()
            start = 0
            if ckpt is not None:
                start = int((pathlib.Path(ckpt) / "step").read_text())
            assert not (attempt > 0 and start == 0), (
                "retry did not see the previous attempt's checkpoint")
            for step in range(start, 5):
                d = tmp_path / f"ck{step}"
                d.mkdir(exist_ok=True)
                (d / "step").write_text(str(step + 1))
                report({"step": step}, checkpoint=str(d))
                if step == 2 and attempt == 0:
                    raise RuntimeError("boom at step 2")

        result = TorchTrainer(
            loop,
            run_config=RunConfig(
                storage_path=str(tmp_path / "storage"),
                failure_config=FailureConfig(max_failures=1),
            ),
        ).fit()
        assert result.error is None
        assert result.metrics["step"] == 4
        # Second attempt resumed at step 3: reported only steps 3, 4.
        assert [m["step"] for m in result.metrics_history] == [3, 4]

    def test_context_inside_and_outside_a_fit(self):
        seen = {}

        def loop():
            seen["ctx"] = get_context()

        TorchTrainer(loop, run_config=RunConfig(name="ctx")).fit()
        assert seen["ctx"].world_size == 1
        assert seen["ctx"].experiment_name == "ctx"
        assert get_context().trial_dir is None
        with pytest.raises(RuntimeError, match="outside"):
            report({"x": 1})

    def test_get_dataset_shard_outside_a_fit_raises_key_error(self):
        with pytest.raises(KeyError, match="train"):
            get_dataset_shard("train")

    def test_get_dataset_shard_of_an_unknown_name_raises_key_error(self):
        """Inside a fit given no dataset of that name: the loop's
        KeyError is the fit's error."""

        def loop():
            get_dataset_shard("eval")

        result = TorchTrainer(loop).fit()
        assert isinstance(result.error, KeyError)
        assert "eval" in str(result.error)

    def test_a_failed_attempts_mesh_model_is_freed_by_the_retry(
            self, world_of_one):
        """A retried fit frees the failed attempt's FSDP2 model, which
        its reference cycles would keep alive until the collector ran:
        with the collector off and no `gc.collect()` here."""
        import gc
        import weakref

        cfg = llama.LlamaConfig.tiny()
        dropped = []

        def loop():
            if not dropped:
                model = llama.Llama(cfg, device="cpu")
                init_fn, _ = make_train_step(
                    llama.loss_fn, default_optimizer(),
                    MeshSpec(fsdp=1).build("cpu"),
                    llama.param_annotations(cfg))
                init_fn(model)
                dropped.append(weakref.ref(model))
                raise RuntimeError("first attempt fails")
            report({"ok": 1})

        enabled = gc.isenabled()
        gc.disable()
        try:
            result = TorchTrainer(loop, run_config=RunConfig(
                failure_config=FailureConfig(max_failures=1))).fit()
            assert result.error is None and result.metrics == {"ok": 1}
            assert dropped[0]() is None
        finally:
            if enabled:
                gc.enable()


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone, for a CPU mesh."""
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


class TestDeviceBatchPrefetch:
    def test_prefetch_to_device_order_and_residency(self, world_of_one):
        mesh = MeshSpec(fsdp=1).build("cpu")
        host = [{"id": np.full((4,), i, dtype=np.int32)} for i in range(7)]
        out = list(prefetch_to_device(iter(host), mesh, buffer_size=2,
                                      logical_axes=("batch",)))
        assert len(out) == 7
        for i, batch in enumerate(out):
            assert isinstance(batch["id"], DTensor)  # on the mesh
            np.testing.assert_array_equal(batch["id"].to_local().numpy(),
                                          np.full((4,), i))

    def test_prefetch_bills_h2d_and_data_wait(self, world_of_one):
        from ray_tpu_torch._private import step_telemetry

        mesh = MeshSpec(fsdp=1).build("cpu")
        step_telemetry.take_phases()
        out = list(prefetch_to_device(iter([np.zeros(2)] * 3), mesh,
                                      buffer_size=1, logical_axes=("batch",)))
        phases = step_telemetry.take_phases()
        assert len(out) == 3
        assert set(phases) == {"h2d_ms", "data_wait_ms"}
        with pytest.raises(ValueError, match="buffer_size"):
            next(prefetch_to_device(iter([]), mesh, buffer_size=0))

    def test_mesh_step_in_a_world_of_one_equals_the_plain_step(
            self, world_of_one):
        cfg = llama.LlamaConfig.tiny(remat_policy="dots_flash")
        toks = torch.randint(0, cfg.vocab_size, (2, 17),
                             generator=torch.Generator().manual_seed(3))
        losses = []
        for mesh in (None, MeshSpec(fsdp=1).build("cpu")):
            model = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
            args = () if mesh is None else (mesh, llama.param_annotations(cfg))
            init_fn, step_fn = make_train_step(
                llama.loss_fn,
                default_optimizer(learning_rate=1e-2, total_steps=20), *args,
                device="cpu")
            state = init_fn(model)
            losses.append([step_fn(state, toks[:, :-1], toks[:, 1:])[1]
                           ["loss"].item() for _ in range(3)])
        assert losses[0] == losses[1]


def _jax_data_loop():
    """JaxTrainer's loop over its dataset shard: the JAX package's step
    on `LlamaConfig.tiny()` from `config["params"]`, one step a batch of
    2 rows, each loss reported. Built here so cloudpickle
    sends it by value."""

    def loop(config):
        import jax

        from ray_tpu.models import llama as jax_llama
        from ray_tpu.parallel import MeshSpec as JaxMeshSpec
        from ray_tpu.train import get_dataset_shard as jax_shard
        from ray_tpu.train import report as jax_report
        from ray_tpu.train import train_step as jax_train

        cfg = jax_llama.LlamaConfig.tiny()
        mesh = JaxMeshSpec(fsdp=1).build(jax.devices()[:1])
        init_fn, step_fn = jax_train.make_train_step(
            lambda p, t, y: jax_llama.loss_fn(p, t, y, cfg),
            jax_train.default_optimizer(learning_rate=config["lr"],
                                        total_steps=20),
            mesh, jax_llama.param_annotations(cfg), donate=False)
        state = init_fn(jax.random.PRNGKey(0), lambda k: jax.tree.map(
            jax.numpy.asarray, config["params"]))
        for batch in jax_shard("train").iter_batches(batch_size=2):
            state, metrics = step_fn(state, batch["tokens"],
                                     batch["targets"])
            jax_report({"loss": float(metrics["loss"]),
                        "rows": batch["row"].tolist()})

    return loop


def _port_data_loop():
    """TorchTrainer's counterpart of `_jax_data_loop`: the same weights
    through `load_jax_params`, fed by `get_device_batches` on a
    `MeshSpec(fsdp=1)` mesh (a gloo world of one made here when the
    process has none)."""

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.models import llama
        from ray_tpu_torch.parallel import MeshSpec
        from ray_tpu_torch.train import (
            default_optimizer,
            get_device_batches,
            init_torch_distributed,
            make_train_step,
            report,
        )
        from ray_tpu_torch.train.backend import free_port

        own = not dist.is_initialized()
        if own:
            init_torch_distributed(0, 1, f"localhost:{free_port()}",
                                   device="cpu")
        try:
            cfg = llama.LlamaConfig.tiny()
            model = llama.Llama(cfg, device="cpu")
            model.load_state_dict(llama.load_jax_params(config["params"],
                                                        cfg))
            mesh = MeshSpec(fsdp=1).build("cpu")
            init_fn, step_fn = make_train_step(
                llama.loss_fn,
                default_optimizer(learning_rate=config["lr"],
                                  total_steps=20),
                mesh, llama.param_annotations(cfg))
            state = init_fn(model)
            for batch in get_device_batches("train", mesh=mesh,
                                            batch_size=2):
                state, metrics = step_fn(state, batch["tokens"],
                                         batch["targets"])
                report({"loss": metrics["loss"].item(),
                        "rows": batch["row"].to_local().tolist()})
        finally:
            if own:
                dist.destroy_process_group()

    return loop


def _token_rows(n=8):
    """Columns of `n` rows (int64 tokens and targets of 32, a row id)
    and the JAX package's tiny init as numpy."""
    cfg = jax_llama.LlamaConfig.tiny()
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (n, 33))
    params = jax.tree.map(np.array, jax_llama.init_params(
        jax.random.PRNGKey(0), cfg))
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
            "row": np.arange(n)}, params


def _fit_both(columns, params, lr=1e-2):
    """The JaxTrainer's and the TorchTrainer's reports over the same
    rows, each runtime shut down before the other starts."""
    import ray_tpu as jax_rt
    import ray_tpu_torch as rt
    from ray_tpu import data as jax_data
    from ray_tpu_torch import data

    jax_rt.init(num_cpus=4)
    try:
        want = JaxTrainer(
            _jax_data_loop(), train_loop_config={"params": params, "lr": lr},
            datasets={"train": jax_data.from_numpy(columns)}).fit()
    finally:
        jax_rt.shutdown()
    rt.init(num_cpus=4)
    try:
        got = TorchTrainer(
            _port_data_loop(), train_loop_config={"params": params, "lr": lr},
            scaling_config=ScalingConfig(use_gpu=False),
            datasets={"train": data.from_numpy(columns)}).fit()
    finally:
        rt.shutdown()
    return want, got


class TestTrainerDatasets:
    """`TorchTrainer(datasets=...)`, `get_dataset_shard` and
    `get_device_batches` against `JaxTrainer(datasets=...)`, and a
    `Tuner` over each: the same rows in the same order, and the loss
    trajectories of the same weights (JAX init through
    `load_jax_params`) at `test_fit_local_reports_and_matches_jax_trainer`'s
    rtol 1e-4. Each test starts the runtimes it needs and shuts each
    down before the next starts."""

    def test_trainer_device_batches_end_to_end(self):
        """As tests/test_train.py's: the host prefetch thread and the
        device double buffer feed the loop every row once."""
        import ray_tpu_torch as rt
        from ray_tpu_torch import data

        def loop():
            store = dist.HashStore()
            dist.init_process_group("gloo", store=store, rank=0,
                                    world_size=1)
            try:
                mesh = MeshSpec(fsdp=1).build("cpu")
                total, count = 0, 0
                for batch in get_device_batches(
                        "train", mesh=mesh, batch_size=32,
                        prefetch_batches=2, buffer_size=2):
                    assert isinstance(batch["id"], DTensor)
                    total += int(batch["id"].to_local().sum())
                    count += int(batch["id"].shape[0])
            finally:
                dist.destroy_process_group()
            report({"total": total, "count": count})

        rt.init(num_cpus=4)
        try:
            result = TorchTrainer(
                loop, datasets={"train": data.range(96, parallelism=4)}
            ).fit()
        finally:
            rt.shutdown()
        assert result.error is None, result.error
        assert result.metrics == {"count": 96, "total": sum(range(96))}

    def test_fit_over_a_dataset_matches_jax_trainer(self):
        columns, params = _token_rows()
        want, got = _fit_both(columns, params)
        assert want.error is None and got.error is None, (want.error,
                                                          got.error)
        assert len(got.metrics_history) == 4
        assert ([m["rows"] for m in got.metrics_history]
                == [m["rows"] for m in want.metrics_history]
                == [[0, 1], [2, 3], [4, 5], [6, 7]])
        np.testing.assert_allclose(
            [m["loss"] for m in got.metrics_history],
            [m["loss"] for m in want.metrics_history], rtol=1e-4)

    @pytest.mark.timeout(300)
    def test_tuner_over_torch_trainer_matches_tuner_over_jax_trainer(self):
        """Each trial's actor gets the trainer's clone with its dataset,
        and reports the last loss of its learning rate."""
        import ray_tpu as jax_rt
        import ray_tpu_torch as rt
        from ray_tpu import data as jax_data
        from ray_tpu import tune as jax_tune
        from ray_tpu_torch import data, tune

        columns, params = _token_rows()
        lrs = [1e-3, 1e-2]

        def fit(t, trainer):
            grid = t.Tuner(
                trainer, param_space={"lr": t.grid_search(lrs)},
                tune_config=t.TuneConfig(metric="loss", mode="min",
                                         max_concurrent_trials=2)).fit()
            assert not grid.errors, [r.error for r in grid.errors]
            return {r.config["lr"]: r.metrics["loss"] for r in grid}

        jax_rt.init(num_cpus=4)
        try:
            want = fit(jax_tune, JaxTrainer(
                _jax_data_loop(), train_loop_config={"params": params},
                datasets={"train": jax_data.from_numpy(columns)}))
        finally:
            jax_rt.shutdown()
        rt.init(num_cpus=4)
        try:
            got = fit(tune, TorchTrainer(
                _port_data_loop(), train_loop_config={"params": params},
                scaling_config=ScalingConfig(use_gpu=False),
                datasets={"train": data.from_numpy(columns)}))
        finally:
            rt.shutdown()
        assert sorted(got) == sorted(want) == lrs
        np.testing.assert_allclose([got[lr] for lr in lrs],
                                   [want[lr] for lr in lrs], rtol=1e-4)

    def test_a_card_trial_on_a_cardless_box_lands_in_errors(self):
        """`TorchTrainer(use_gpu=True)` in a trial that asked for no
        card raises there; it does not fall back to the CPU."""
        import ray_tpu_torch as rt
        from ray_tpu_torch import tune

        def loop():
            report({"loss": 1.0})

        rt.init(num_cpus=2)
        try:
            grid = tune.Tuner(
                TorchTrainer(loop,
                             scaling_config=ScalingConfig(use_gpu=True)),
                tune_config=tune.TuneConfig(metric="loss", mode="min"),
            ).fit()
        finally:
            rt.shutdown()
        assert len(grid) == 1 and len(grid.errors) == 1
        assert "no CUDA device is visible" in grid.errors[0].error
        assert grid[0].metrics == {}


@pytest.fixture(scope="module")
def cluster():
    """The port's runtime, for the trainer gang: one per module."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


class TestTrainerGang:
    """`TorchTrainer(num_workers=2)` on a gang of the port's runtime
    actors, joined by `TorchBackend` into a gloo group (`use_gpu=False`),
    against JAX's `make_train_step` on a 2-device CPU mesh: the same
    parameters (JAX init through `load_jax_params`) and batch, f32, under
    `test_torch_sharded.py`'s bars (rtol 1e-4 on the losses)."""

    STEPS = 3

    @pytest.mark.timeout(300)
    def test_gang_of_two_matches_jax_fsdp2(self, cluster, tmp_path):
        cfg_j = jax_llama.LlamaConfig.tiny()
        mesh_j = JaxMeshSpec(fsdp=2).build(jax.devices()[:2])
        init_fn, step_fn = jax_train.make_train_step(
            lambda p, t, y: jax_llama.loss_fn(p, t, y, cfg_j),
            jax_train.default_optimizer(learning_rate=1e-2, total_steps=20),
            mesh_j, jax_llama.param_annotations(cfg_j), donate=False)
        state = init_fn(jax.random.PRNGKey(0),
                        lambda k: jax_llama.init_params(k, cfg_j))
        start = {k: v.numpy() for k, v in llama.load_jax_params(
            jax.tree.map(np.array, state.params),
            llama.LlamaConfig.tiny()).items()}
        tokens = np.random.default_rng(4).integers(
            0, cfg_j.vocab_size, (4, 33)).astype(np.int32)
        want = []
        for _ in range(self.STEPS):
            state, metrics = step_fn(state, tokens[:, :-1], tokens[:, 1:])
            want.append(float(metrics["loss"]))

        def loop(config):
            # Runs in each gang actor: port code only, no JAX.
            import torch

            from ray_tpu_torch.models import llama
            from ray_tpu_torch.parallel import MeshSpec
            from ray_tpu_torch.train import (
                default_optimizer,
                get_context,
                make_train_step,
                report,
                save_checkpoint,
                shard_batch,
            )

            cfg = llama.LlamaConfig.tiny()
            mesh = MeshSpec(fsdp=2).build("cpu")
            model = llama.Llama(cfg, device="cpu")
            model.load_state_dict({k: torch.from_numpy(v.copy())
                                   for k, v in config["start"].items()})
            init_fn, step_fn = make_train_step(
                llama.loss_fn,
                default_optimizer(learning_rate=1e-2, total_steps=20),
                mesh, llama.param_annotations(cfg))
            st = init_fn(model)
            batch = torch.from_numpy(config["tokens"]).long()
            inputs = shard_batch(batch[:, :-1], mesh)
            labels = shard_batch(batch[:, 1:], mesh)
            for step in range(config["steps"]):
                st, metrics = step_fn(st, inputs, labels)
                ckpt = None
                if step == config["steps"] - 1:
                    ckpt = config["path"]
                    save_checkpoint(ckpt, st.state_dict(), {"step": step})
                report({"loss": metrics["loss"].item(), "step": step,
                        "rank": get_context().world_rank,
                        "world": get_context().world_size}, checkpoint=ckpt)

        path = str(tmp_path / "ckpt")
        result = TorchTrainer(
            loop, train_loop_config={"start": start, "tokens": tokens,
                                     "steps": self.STEPS, "path": path},
            scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
            backend=TorchBackend(),
            run_config=RunConfig(storage_path=str(tmp_path / "storage")),
        ).fit()
        assert result.error is None, result.error
        assert len(result.metrics_by_rank) == 2
        for rank, history in enumerate(result.metrics_by_rank):
            assert [m["rank"] for m in history] == [rank] * self.STEPS
            assert all(m["world"] == 2 for m in history)
            np.testing.assert_allclose([m["loss"] for m in history], want,
                                       rtol=1e-4)
        assert result.metrics_history == result.metrics_by_rank[0]
        assert result.checkpoint_path == path
        assert load_metadata(path) == {"step": self.STEPS - 1}

    @pytest.mark.timeout(200)
    def test_gang_of_two_reads_equal_shards_of_every_row(self, cluster):
        """`datasets=` on a gang: each rank's `get_device_batches` shard
        is its own rows (6 blocks of 20 split 3 and 3), the global batch
        on the fsdp 2 mesh both ranks' 10, and the shards together every
        row once."""
        from ray_tpu_torch import data

        def loop():
            from ray_tpu_torch.parallel import MeshSpec
            from ray_tpu_torch.train import (
                get_context,
                get_device_batches,
                report,
            )

            mesh = MeshSpec(fsdp=2).build("cpu")
            for batch in get_device_batches("train", mesh=mesh,
                                            batch_size=10):
                report({"rows": batch["id"].to_local().tolist(),
                        "global": list(batch["id"].shape),
                        "rank": get_context().world_rank})

        result = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
            datasets={"train": data.range(120, parallelism=6)}).fit()
        assert result.error is None, result.error
        seen = [[r for m in h for r in m["rows"]]
                for h in result.metrics_by_rank]
        assert [len(s) for s in seen] == [60, 60]
        assert sorted(seen[0] + seen[1]) == list(range(120))
        assert all(m["global"] == [20] for h in result.metrics_by_rank
                   for m in h)
        assert [h[0]["rank"] for h in result.metrics_by_rank] == [0, 1]

    @pytest.mark.timeout(200)
    def test_a_failing_rank_fails_the_fit(self, cluster):
        """A rank's error comes back as the fit's error (no retry left),
        and the gang is torn down: the next fit starts a fresh one."""

        def loop():
            from ray_tpu_torch.train import get_context, report

            if get_context().world_rank == 1:
                raise ValueError("rank one fails")
            report({"ok": 1})

        scaling = ScalingConfig(num_workers=2, use_gpu=False)
        result = TorchTrainer(loop, scaling_config=scaling).fit()
        assert isinstance(result.error, ValueError)
        assert "rank one fails" in str(result.error)

        def fine():
            from ray_tpu_torch.train import get_context, report

            report({"rank": get_context().world_rank})

        result = TorchTrainer(fine, scaling_config=scaling).fit()
        assert result.error is None
        assert [h[0]["rank"] for h in result.metrics_by_rank] == [0, 1]
