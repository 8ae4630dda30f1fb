"""The port's Tune (`ray_tpu_torch.tune`, copied from `ray_tpu/tune`),
held to the JAX package's: the same variants and TPE suggestions for
the same seed and observations, the same ASHA, median-stopping and PBT
decisions on the same report sequences; and `tests/test_tune.py`'s
cases on the port's runtime (trials, errors, ASHA, PBT, resume, TPE).
The JAX package's Tune needs no runtime here; the port's runtime is
one for the module."""

import math
import random

import pytest

from ray_tpu import tune as jax_tune
from ray_tpu.tune import tuner as jax_tuner
from ray_tpu_torch import tune
from ray_tpu_torch.tune import tuner as port_tuner

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)


def _space(t):
    return {"lr": t.loguniform(1e-5, 1e-1), "x": t.uniform(-1.0, 1.0),
            "layers": t.grid_search([1, 2, 3]), "width": t.randint(4, 64),
            "act": t.choice(["relu", "gelu", "silu"]), "fixed": "x"}


@pytest.mark.parametrize("seed", [0, 7])
def test_variants_equal_the_jax_packages(seed):
    want = jax_tune.BasicVariantGenerator(seed).generate(
        _space(jax_tune), num_samples=3)
    got = tune.BasicVariantGenerator(seed).generate(_space(tune),
                                                    num_samples=3)
    assert len(got) == 9
    assert got == want


def _tpe_run(t, seed, rounds=30):
    """TPE over a 2-D quadratic with a categorical axis: the configs it
    suggests, each observed before the next is asked."""
    from importlib import import_module

    search = import_module(t.__name__ + ".search")
    s = search.TPESearcher(n_startup=8)
    s.setup({"x": t.uniform(0.0, 1.0), "lr": t.loguniform(1e-5, 1e-1),
             "act": t.choice(["a", "b", "c"])}, metric="loss", mode="min",
            seed=seed)
    configs = []
    for _ in range(rounds):
        cfg = s.suggest()
        configs.append(cfg)
        loss = ((cfg["x"] - 0.7) ** 2 + (math.log10(cfg["lr"]) + 3) ** 2
                + (0.0 if cfg["act"] == "b" else 1.0))
        s.record(cfg, {"loss": loss})
    return configs


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_suggests_what_the_jax_package_suggests(seed):
    assert _tpe_run(tune, seed) == _tpe_run(jax_tune, seed)


def _decisions(t, trial_cls, scheduler, reports):
    trials = {}
    out = []
    for trial_id, config, result in reports:
        trial = trials.setdefault(trial_id, trial_cls(trial_id=trial_id,
                                                      config=dict(config)))
        trial.checkpoint = {"at": result["training_iteration"]}
        decision = scheduler.on_result(trial, dict(result))
        exploit = None
        if hasattr(scheduler, "pop_exploit"):
            exploit = scheduler.pop_exploit(trial_id)
        out.append((trial_id, decision, exploit))
    return out


def _reports(steps=24, seed=5):
    """Interleaved reports, in an order drawn from one seed, of trials
    whose score grows at their own slope, with noise from the seed."""
    rng = random.Random(seed)
    slopes = [0.1, 0.2, 0.5, 1.0, 1.5, 2.0]
    reports = []
    for step in range(1, steps + 1):
        for i in rng.sample(range(len(slopes)), len(slopes)):
            score = slopes[i] * step + rng.gauss(0.0, 0.3)
            reports.append((f"t{i}", {"rate": slopes[i]},
                            {"training_iteration": step, "score": score}))
    return reports


@pytest.mark.parametrize("kind", ["asha", "median", "pbt"])
def test_schedulers_decide_as_the_jax_packages_do(kind):
    def make(t):
        if kind == "asha":
            return t.AsyncHyperBandScheduler(
                metric="score", mode="max", grace_period=2,
                reduction_factor=2, max_t=24)
        if kind == "median":
            return t.MedianStoppingRule(metric="score", mode="max",
                                        grace_period=3)
        return t.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=4,
            hyperparam_mutations={"rate": [0.5, 1.0, 2.0]},
            quantile_fraction=0.34, seed=0)

    reports = _reports()
    want = _decisions(jax_tune, jax_tuner.Trial, make(jax_tune), reports)
    got = _decisions(tune, port_tuner.Trial, make(tune), reports)
    assert got == want
    # The sequence exercises the scheduler: something was decided.
    assert any(d == "STOP" or e is not None for _, d, e in got)


def test_tpe_rejects_grid_axes():
    from ray_tpu_torch.tune.search import TPESearcher, grid_search

    s = TPESearcher()
    with pytest.raises(ValueError, match="grid_search"):
        s.setup({"x": grid_search([1, 2])}, "score", "max")


def test_tpe_converges_on_quadratic():
    """tests/test_tune.py's bar on the port's copy: TPE beats random
    search on the same budget and seeds, and its late suggestions sit
    nearer the optimum than its early ones."""
    from ray_tpu_torch.tune.search import TPESearcher, uniform

    space = {"x": uniform(0.0, 1.0), "y": uniform(0.0, 1.0)}

    def score(cfg):
        return -((cfg["x"] - 0.7) ** 2 + (cfg["y"] - 0.2) ** 2)

    def run(adaptive, seed):
        if not adaptive:
            rng = random.Random(seed)
            return max(
                score({"x": rng.uniform(0, 1), "y": rng.uniform(0, 1)})
                for _ in range(40)), []
        s = TPESearcher()
        s.setup(space, metric="score", mode="max", seed=seed)
        best, xs = -1e9, []
        for _ in range(40):
            cfg = s.suggest()
            xs.append(cfg["x"])
            val = score(cfg)
            best = max(best, val)
            s.record(cfg, {"score": val})
        return best, xs

    tpe_runs = [run(True, s) for s in range(5)]
    rand_runs = [run(False, s) for s in range(5)]
    assert (sum(b for b, _ in tpe_runs) / 5
            >= sum(b for b, _ in rand_runs) / 5)
    assert all(b > -0.02 for b, _ in tpe_runs), tpe_runs
    for _, xs in tpe_runs:
        early = sum(abs(x - 0.7) for x in xs[:10]) / 10
        late = sum(abs(x - 0.7) for x in xs[-10:]) / 10
        assert late < early, (early, late)


@pytest.fixture(scope="module")
def port_rt():
    import ray_tpu_torch as rt

    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def test_tuner_runs_trials_and_picks_best(port_rt):
    def trainable(config):
        score = -((config["x"] - 3.0) ** 2)
        tune.report({"score": score, "x": config["x"]})

    results = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
    ).fit()
    assert len(results) == 4
    assert not results.errors
    assert results.get_best_result("score", "max").config["x"] == 3.0


def test_trial_error_is_captured(port_rt):
    def trainable(config):
        if config["x"] == 1:
            raise RuntimeError("boom")
        tune.report({"score": config["x"]})

    results = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([0, 1])}).fit()
    assert len(results.errors) == 1
    assert "boom" in results.errors[0].error


def test_asha_stops_bad_trials(port_rt):
    def trainable(config):
        for step in range(20):
            tune.report({"score": config["slope"] * (step + 1)})

    scheduler = tune.AsyncHyperBandScheduler(
        metric="score", mode="max", grace_period=2, reduction_factor=2,
        max_t=20)
    results = tune.Tuner(
        trainable,
        param_space={"slope": tune.grid_search([2.0, 1.0, 0.2, 0.1])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=scheduler,
                                    max_concurrent_trials=2),
    ).fit()
    iters = {r.config["slope"]: r.metrics.get("training_iteration", 0)
             for r in results}
    assert iters[2.0] == 20
    assert iters[0.1] < 20
    assert iters[0.2] < 20


def test_pbt_exploits_and_mutates(port_rt):
    def trainable(config):
        ckpt = tune.get_checkpoint()
        value = ckpt["value"] if ckpt else 0.0
        for _ in range(50):
            value += config["rate"]
            tune.report({"score": value}, checkpoint={"value": value})

    scheduler = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=5,
        hyperparam_mutations={"rate": [0.5, 1.0, 2.0]},
        quantile_fraction=0.5, seed=0)
    results = tune.Tuner(
        trainable, param_space={"rate": tune.grid_search([0.01, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=scheduler),
    ).fit()
    assert not results.errors
    scores = sorted(r.metrics["score"] for r in results)
    assert scores[0] > 5.0


def test_experiment_resume(port_rt, tmp_path):
    """A finished experiment restored from its storage keeps its trials'
    results; an unfinished trial in the saved state runs again."""
    import json
    import os

    from ray_tpu_torch.train import RunConfig

    storage = str(tmp_path / "exp")

    def trainable(config):
        tune.report({"score": config["x"] * 2})

    results = tune.Tuner(
        trainable, param_space={"x": tune.grid_search([1, 2])},
        run_config=RunConfig(storage_path=storage)).fit()
    assert len(results) == 2
    restored = tune.Tuner.restore(storage, trainable)
    assert {r.metrics["score"] for r in restored.fit()} == {2, 4}
    # Mark one trial unfinished, as an interrupted run leaves it.
    path = os.path.join(storage, "experiment_state.json")
    with open(path) as f:
        state = json.load(f)
    state["trials"][0].update(state="PENDING", last_result={})
    with open(path, "w") as f:
        json.dump(state, f)
    again = tune.Tuner.restore(storage, trainable).fit()
    assert len(again) == 2 and not again.errors
    assert {r.metrics["score"] for r in again} == {2, 4}


def test_tuner_with_tpe_search_alg(port_rt):
    from ray_tpu_torch.tune.search import TPESearcher, uniform

    def trainable(config):
        tune.report({"score": -((config["x"] - 0.3) ** 2)})

    grid = tune.Tuner(
        trainable, param_space={"x": uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=20,
            max_concurrent_trials=2, search_alg=TPESearcher(n_startup=6),
            seed=3),
    ).fit()
    assert len(grid) == 20
    best = grid.get_best_result(metric="score", mode="max")
    assert abs(best.config["x"] - 0.3) < 0.15, best.config


def test_tuner_wraps_torch_trainer(port_rt):
    """Trainer-as-trainable, as `test_tuner_wraps_jax_trainer`: each
    trial fits a clone of the `TorchTrainer` with its config merged into
    the loop's."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train import report as train_report

    def train_loop(config):
        train_report({"loss": 10.0 / config["lr_scale"]})

    trainer = TorchTrainer(train_loop, train_loop_config={"lr_scale": 1.0},
                           scaling_config=ScalingConfig(use_gpu=False))
    results = tune.Tuner(
        trainer, param_space={"lr_scale": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min")).fit()
    assert not results.errors
    assert results.get_best_result("loss", "min").config["lr_scale"] == 2.0
