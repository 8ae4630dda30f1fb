# Copied from ray_tpu/tune/schedulers.py (JAX-free).
"""Trial schedulers.

Reference: python/ray/tune/schedulers/ — FIFOScheduler (trial_scheduler
.py), AsyncHyperBandScheduler/ASHA (async_hyperband.py: rungs at
reduction_factor spacing, cutoff at the top 1/rf quantile per rung),
MedianStoppingRule (median_stopping_rule.py), PopulationBasedTraining
(pbt.py: at perturbation_interval the bottom quantile clones the top
quantile's checkpoint and mutates its config).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"

_UNSET = object()


class TrialScheduler:
    def on_result(self, trial, result: dict) -> str:
        return CONTINUE

    def on_complete(self, trial, result: dict) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: stop a trial at a rung if its metric falls outside the top
    1/reduction_factor of results recorded at that rung."""

    def __init__(
        self,
        metric: str = "score",
        mode: str = "max",
        grace_period: int = 1,
        reduction_factor: int = 3,
        max_t: int = 100,
        time_attr: str = "training_iteration",
    ):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # Rungs top-down (reference: _Bracket checks the highest rung
        # first and records a trial at most once per rung).
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rungs.reverse()
        self._rung_records: Dict[int, Dict[str, float]] = defaultdict(dict)

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        value = float(value) if self.mode == "max" else -float(value)
        action = CONTINUE
        for rung in self.rungs:
            recorded = self._rung_records[rung]
            if t >= rung and trial.trial_id not in recorded:
                if recorded:
                    import numpy as np

                    cutoff = float(
                        np.nanpercentile(
                            list(recorded.values()),
                            (1 - 1 / self.rf) * 100,
                        )
                    )
                    if value < cutoff:
                        action = STOP
                recorded[trial.trial_id] = value
                break
        if t >= self.max_t:
            action = STOP
        return action


class MedianStoppingRule(TrialScheduler):
    """Stop when a trial's best result falls below the median of other
    trials' running averages at the same step."""

    def __init__(
        self,
        metric: str = "score",
        mode: str = "max",
        grace_period: int = 1,
        min_samples_required: int = 3,
        time_attr: str = "training_iteration",
    ):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self._history: Dict[str, List[float]] = defaultdict(list)

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        value = float(value) if self.mode == "max" else -float(value)
        self._history[trial.trial_id].append(value)
        if t <= self.grace:
            return CONTINUE
        others = [
            sum(h) / len(h)
            for tid, h in self._history.items()
            if tid != trial.trial_id and h
        ]
        if len(others) < self.min_samples:
            return CONTINUE
        ordered = sorted(others)
        median = ordered[len(ordered) // 2]
        best = max(self._history[trial.trial_id])
        if best < median:
            return STOP
        return CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT: periodically the bottom quantile exploits (clones config +
    checkpoint of) the top quantile, then explores (mutates).

    The controller enacts the decision: `on_result` returns STOP for
    the victim and records an exploit directive the controller reads
    via `pop_exploit` (restart same trial from donor checkpoint with
    mutated config)."""

    def __init__(
        self,
        metric: str = "score",
        mode: str = "max",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[
            Dict[str, Callable[[Any], Any] | List[Any]]
        ] = None,
        quantile_fraction: float = 0.25,
        time_attr: str = "training_iteration",
        seed: Optional[int] = None,
    ):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._last_score: Dict[str, float] = {}
        self._last_perturb: Dict[str, int] = defaultdict(int)
        self._exploits: Dict[str, dict] = {}
        self._trials: Dict[str, Any] = {}

    def _ranked(self) -> List[str]:
        pairs = sorted(
            self._last_score.items(),
            key=lambda kv: kv[1],
            reverse=True,
        )
        return [tid for tid, _ in pairs]

    def on_result(self, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        self._trials[trial.trial_id] = trial
        self._last_score[trial.trial_id] = (
            float(value) if self.mode == "max" else -float(value)
        )
        if t - self._last_perturb[trial.trial_id] < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        ranked = self._ranked()
        if len(ranked) < 2:
            return CONTINUE
        k = max(1, int(len(ranked) * self.quantile))
        bottom = ranked[-k:]
        top = ranked[:k]
        if trial.trial_id not in bottom or trial.trial_id in top:
            return CONTINUE
        donor_id = self._rng.choice(top)
        donor = self._trials.get(donor_id)
        if donor is None or donor.checkpoint is None:
            return CONTINUE
        self._exploits[trial.trial_id] = {
            "config": self._explore(dict(donor.config)),
            "checkpoint": donor.checkpoint,
        }
        return STOP

    def _explore(self, config: dict) -> dict:
        for key, mutation in self.mutations.items():
            if isinstance(mutation, list):
                config[key] = self._rng.choice(mutation)
            elif callable(mutation):
                config[key] = mutation(config.get(key))
            else:
                raise TypeError(
                    "hyperparam_mutations values must be lists or "
                    "callables"
                )
        return config

    def pop_exploit(self, trial_id: str) -> Optional[dict]:
        return self._exploits.pop(trial_id, None)
