# Copied from ray_tpu/tune/__init__.py (JAX-free).
"""Hyperparameter tuning (reference: python/ray/tune)."""

from .schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import (
    BasicVariantGenerator,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from .session import get_checkpoint, report
from .tuner import ResultGrid, TrialResult, TuneConfig, Tuner

__all__ = [
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "TrialResult",
    "report",
    "get_checkpoint",
    "uniform",
    "loguniform",
    "randint",
    "choice",
    "grid_search",
    "BasicVariantGenerator",
    "TrialScheduler",
    "FIFOScheduler",
    "AsyncHyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
]
