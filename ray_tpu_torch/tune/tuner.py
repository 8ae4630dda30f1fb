# Copied from ray_tpu/tune/tuner.py (JAX-free).
"""Tuner + trial controller.

Reference: python/ray/tune — Tuner (tune/tuner.py) wraps an experiment;
TuneController (tune/execution/tune_controller.py:68) is the event loop
that launches trial actors, polls their results, and enacts scheduler
decisions; experiment state snapshots enable resume
(tune/execution/experiment_state.py). Trials run the function
trainable on a thread inside an actor and stream results through
tune.report (trainable/function_trainable.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from .schedulers import (
    CONTINUE,
    STOP,
    FIFOScheduler,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import BasicVariantGenerator
from .session import StopTrial, TrialRuntime, set_active

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class _TrialActor:
    """Runs the trainable on a background thread; the controller polls
    `next_results` (reference: function_trainable's RunnerThread)."""

    def __init__(self):
        self._runtime: Optional[TrialRuntime] = None
        self._thread: Optional[threading.Thread] = None
        self._done: Optional[tuple] = None

    def start(self, fn, config, checkpoint=None):
        self._runtime = TrialRuntime(checkpoint)
        self._done = None

        def run():
            set_active(self._runtime)
            try:
                fn(config)
                status, error = "ok", None
            except StopTrial:
                status, error = "stopped", None
            except BaseException as e:  # noqa: BLE001 — reported back
                status, error = "error", e
            finally:
                set_active(None)
            self._done = (status, error)  # rt: noqa[RT201] — single-producer handoff: the store is GIL-atomic and published via the results-queue sentinel
            self._runtime.results.put({"__done__": status})

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return True

    def next_results(self, timeout=0.2):
        """Drain available results; returns (results, done_status)."""
        assert self._runtime is not None
        results: List[dict] = []
        deadline = time.time() + timeout
        done = None
        while True:
            remaining = deadline - time.time()
            try:
                item = self._runtime.results.get(
                    timeout=max(0.0, remaining)
                )
            except Exception:
                break
            if "__done__" in item:
                done = item["__done__"]
                break
            results.append(item)
            if not self._runtime.results.qsize():
                break
        if done == "error":
            error = self._done[1]
        else:
            error = None
        return {"results": results, "done": done, "error": error}

    def request_stop(self):
        assert self._runtime is not None
        self._runtime.stop_requested.set()
        return True

    def latest_checkpoint(self):
        assert self._runtime is not None
        return self._runtime.latest_checkpoint


@dataclasses.dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    state: str = PENDING
    last_result: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics_history: List[dict] = dataclasses.field(default_factory=list)
    checkpoint: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    actor: Any = None

    def snapshot(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "state": self.state
            if self.state in (TERMINATED, ERROR)
            else PENDING,
            "last_result": self.last_result,
            "checkpoint": self.checkpoint,
            "error": self.error,
        }


@dataclasses.dataclass
class TuneConfig:
    """(reference: tune/tune_config.py)."""

    metric: str = "score"
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Optional[TrialScheduler] = None
    #: Adaptive searcher (e.g. search.TPESearcher). None = grid/random
    #: via BasicVariantGenerator. Composes with any scheduler (TPE +
    #: ASHA = the BOHB recipe).
    search_alg: Optional[Any] = None
    resources_per_trial: Optional[Dict[str, float]] = None
    seed: Optional[int] = None


class TrialResult:
    def __init__(self, trial: Trial):
        self.config = trial.config
        self.metrics = trial.last_result
        self.metrics_history = trial.metrics_history
        self.checkpoint = trial.checkpoint
        self.error = trial.error
        self.trial_id = trial.trial_id


class ResultGrid:
    def __init__(self, trials: List[Trial]):
        self._results = [TrialResult(t) for t in trials]

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self):
        return [r for r in self._results if r.error]

    def get_best_result(
        self, metric: Optional[str] = None, mode: str = "max"
    ) -> TrialResult:
        scored = [
            r for r in self._results if metric is None or metric in r.metrics
        ]
        if not scored:
            raise ValueError("no trial reported the target metric")
        key = (
            (lambda r: r.metrics[metric]) if metric else (lambda r: 0)
        )
        return (
            max(scored, key=key) if mode == "max" else min(scored, key=key)
        )


class Tuner:
    def __init__(
        self,
        trainable: Callable[[dict], Any],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config=None,  # train.RunConfig (name + storage_path)
    ):
        self._trainable = _as_function_trainable(trainable)
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config
        self._trials: List[Trial] = []

    # -- experiment state ---------------------------------------------
    def _storage_dir(self) -> str:
        if self._run_config is not None and getattr(
            self._run_config, "storage_path", None
        ):
            path = self._run_config.storage_path
        else:
            path = tempfile.mkdtemp(prefix="rt_tune_")
        os.makedirs(path, exist_ok=True)
        return path

    @staticmethod
    def restore(
        path: str,
        trainable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        search_alg=None,
        scheduler=None,
    ) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        results; unfinished ones run again from their last checkpoint
        (reference: Tuner.restore + experiment_state.py). Live objects
        (search_alg, scheduler) and the param_space are not serialized
        — re-pass them here to resume an adaptive search: fit() replays
        every finished trial into the searcher before suggesting the
        remaining num_samples."""
        with open(os.path.join(path, "experiment_state.json")) as f:
            state = json.load(f)
        tuner = Tuner(
            trainable,
            param_space=param_space,
            tune_config=TuneConfig(**state["tune_config"]),
        )
        tuner._tune_config.search_alg = search_alg
        tuner._tune_config.scheduler = scheduler
        tuner._storage_override = path  # type: ignore[attr-defined]
        for snap in state["trials"]:
            tuner._trials.append(Trial(**snap))
        return tuner

    def _save_state(self, path: str) -> None:
        cfg = dataclasses.asdict(self._tune_config)
        cfg.pop("scheduler", None)
        cfg.pop("search_alg", None)  # live object; re-passed on restore
        cfg.pop("resources_per_trial", None)
        state = {
            "tune_config": cfg,
            "trials": [t.snapshot() for t in self._trials],
        }
        tmp = os.path.join(path, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, default=str)
        os.replace(tmp, os.path.join(path, "experiment_state.json"))

    # -- main loop -----------------------------------------------------
    def fit(self) -> ResultGrid:
        import ray_tpu_torch as rt

        cfg = self._tune_config
        storage = getattr(self, "_storage_override", None) or (
            self._storage_dir()
        )
        scheduler = cfg.scheduler or FIFOScheduler()
        searcher = cfg.search_alg
        if searcher is not None:
            searcher.setup(
                self._param_space, cfg.metric, cfg.mode, cfg.seed
            )
            # Resumed experiments replay finished trials into the
            # searcher so its model starts where the run left off.
            for t in self._trials:
                if t.state in (TERMINATED, ERROR):
                    searcher.record(
                        t.config, t.last_result, error=(t.state == ERROR)
                    )
        elif not self._trials:
            generator = BasicVariantGenerator(cfg.seed)
            for config in generator.generate(
                self._param_space, cfg.num_samples
            ):
                self._trials.append(
                    Trial(trial_id=uuid.uuid4().hex[:10], config=config)
                )
        actor_cls = rt.remote(
            **(cfg.resources_per_trial or {"num_cpus": 1})
        )(_TrialActor)

        def launch(trial: Trial, checkpoint=None):
            trial.actor = actor_cls.remote()
            rt.get(
                trial.actor.start.remote(
                    self._trainable,
                    trial.config,
                    checkpoint if checkpoint is not None else trial.checkpoint,
                ),
                timeout=60,
            )
            trial.state = RUNNING

        pending = [t for t in self._trials if t.state == PENDING]
        running: List[Trial] = []
        suggested = len(self._trials)

        def next_trial() -> Optional[Trial]:
            nonlocal suggested
            if pending:
                return pending.pop(0)
            if searcher is not None and suggested < cfg.num_samples:
                suggested += 1
                trial = Trial(
                    trial_id=uuid.uuid4().hex[:10],
                    config=searcher.suggest(),
                )
                self._trials.append(trial)
                return trial
            return None

        def trial_finished(trial: Trial) -> None:
            if searcher is not None:
                searcher.record(
                    trial.config, trial.last_result,
                    error=(trial.state == ERROR),
                )

        try:
            while (
                pending or running
                or (searcher is not None and suggested < cfg.num_samples)
            ):
                while len(running) < cfg.max_concurrent_trials:
                    trial = next_trial()
                    if trial is None:
                        break
                    launch(trial)
                    running.append(trial)
                for trial in list(running):
                    reply = rt.get(
                        trial.actor.next_results.remote(0.15), timeout=60
                    )
                    decision = CONTINUE
                    for result in reply["results"]:
                        has_ckpt = result.pop("__has_checkpoint__", False)
                        trial.last_result = result
                        trial.metrics_history.append(result)
                        if has_ckpt:
                            trial.checkpoint = rt.get(
                                trial.actor.latest_checkpoint.remote(),
                                timeout=60,
                            )
                        decision = scheduler.on_result(trial, result)
                        if decision == STOP:
                            break
                    if decision == STOP:
                        rt.get(
                            trial.actor.request_stop.remote(), timeout=60
                        )
                        trial.checkpoint = rt.get(
                            trial.actor.latest_checkpoint.remote(),
                            timeout=60,
                        )
                        rt.kill(trial.actor)
                        running.remove(trial)
                        exploit = None
                        if isinstance(scheduler, PopulationBasedTraining):
                            exploit = scheduler.pop_exploit(trial.trial_id)
                        if exploit is not None:
                            trial.config = exploit["config"]
                            launch(trial, checkpoint=exploit["checkpoint"])
                            running.append(trial)
                        else:
                            trial.state = TERMINATED
                            trial_finished(trial)
                        self._save_state(storage)
                        continue
                    if reply["done"] is not None:
                        trial.checkpoint = rt.get(
                            trial.actor.latest_checkpoint.remote(),
                            timeout=60,
                        )
                        rt.kill(trial.actor)
                        running.remove(trial)
                        if reply["done"] == "error":
                            trial.state = ERROR
                            trial.error = repr(reply["error"])
                        else:
                            trial.state = TERMINATED
                        trial_finished(trial)
                        self._save_state(storage)
        finally:
            for trial in running:
                try:
                    rt.kill(trial.actor)
                except Exception:
                    pass
            self._save_state(storage)
        return ResultGrid(self._trials)


def _as_function_trainable(trainable) -> Callable[[dict], Any]:
    """Accept a plain function or a TorchTrainer (reference:
    BaseTrainer.fit wraps the trainer as a one-trial Tune trainable,
    base_trainer.py:819). A `TorchTrainer(use_gpu=True)` whose loop
    runs in the trial (`num_workers=1`) raises there when the trial
    sees no card: ask for the card through
    `resources_per_trial={"num_gpus": 1}`. It never falls back to the
    CPU."""
    from ..train.trainer import TorchTrainer

    if isinstance(trainable, TorchTrainer):
        trainer = trainable

        def run_trainer(config: dict):
            import torch

            from . import session as tune_session

            scaling = trainer.scaling_config
            if scaling.use_gpu and scaling.num_workers <= 1 and (
                not torch.cuda.is_available()
            ):
                raise RuntimeError(
                    "TorchTrainer(use_gpu=True) in a trial that sees no "
                    "card: no CUDA device is visible here; ask for one "
                    "with resources_per_trial={'num_gpus': 1}, or pass "
                    "ScalingConfig(use_gpu=False)"
                )
            merged = dict(trainer._train_loop_config or {})
            merged.update(config)
            clone = TorchTrainer(
                trainer._train_loop,
                train_loop_config=merged,
                scaling_config=trainer.scaling_config,
                run_config=trainer.run_config,
                backend=trainer.backend,
                backend_config=trainer.backend_config,
                datasets=trainer.datasets,
            )
            result = clone.fit()
            if result.error is not None:
                raise result.error
            tune_session.report(dict(result.metrics))

        return run_trainer
    if callable(trainable):
        return trainable
    raise TypeError(f"unsupported trainable: {trainable!r}")
