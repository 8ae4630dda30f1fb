# Copied from ray_tpu/tune/search.py (JAX-free).
"""Search spaces and suggestion generation.

Reference: python/ray/tune/search/ — sample domains
(tune/search/sample.py: uniform/loguniform/randint/choice,
grid_search), and BasicVariantGenerator (basic_variant.py) which
crosses grid axes and samples stochastic axes num_samples times.
"""

from __future__ import annotations

import math
import random
from itertools import product
from typing import Any, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        if low <= 0 or high <= 0:
            raise ValueError("loguniform bounds must be positive")
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(
            rng.uniform(math.log(self.low), math.log(self.high))
        )


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high  # [low, high) like the reference

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(categories: List[Any]) -> Choice:
    return Choice(categories)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    return {"grid_search": list(values)}


def _is_grid(value: Any) -> bool:
    return (
        isinstance(value, dict)
        and set(value.keys()) == {"grid_search"}
    )


class BasicVariantGenerator:
    """Cross product of grid axes × num_samples of stochastic axes
    (reference: tune/search/basic_variant.py)."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def generate(
        self, param_space: Dict[str, Any], num_samples: int
    ) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in param_space.items() if _is_grid(v)]
        grid_values = [param_space[k]["grid_search"] for k in grid_keys]
        combos = list(product(*grid_values)) if grid_keys else [()]
        configs = []
        for _ in range(num_samples):
            for combo in combos:
                config: Dict[str, Any] = {}
                for key, value in param_space.items():
                    if key in grid_keys:
                        config[key] = combo[grid_keys.index(key)]
                    elif isinstance(value, Domain):
                        config[key] = value.sample(self._rng)
                    else:
                        config[key] = value
                configs.append(config)
        return configs


# ---------------------------------------------------------------------
# Adaptive searchers (reference slot: tune/search/optuna, hyperopt —
# the suggest/observe Searcher contract of tune/search/searcher.py:34.
# Implemented natively: TPE is the algorithm behind both HyperOpt and
# Optuna's default sampler, so one honest implementation covers the
# role the reference fills with external libraries.)
# ---------------------------------------------------------------------


class Searcher:
    """Sequential suggest/observe protocol (reference:
    tune/search/searcher.py Searcher.suggest/on_trial_complete)."""

    def setup(
        self,
        param_space: Dict[str, Any],
        metric: str,
        mode: str,
        seed: Optional[int] = None,
    ) -> None:
        for key, value in param_space.items():
            if _is_grid(value):
                raise ValueError(
                    f"grid_search axis {key!r} is incompatible with an "
                    "adaptive searcher; use BasicVariantGenerator "
                    "(search_alg=None) for grids"
                )
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.rng = random.Random(seed)

    def suggest(self) -> Dict[str, Any]:
        raise NotImplementedError

    def record(
        self,
        config: Dict[str, Any],
        result: Optional[Dict[str, Any]],
        error: bool = False,
    ) -> None:
        """Observe a finished trial (reference:
        Searcher.on_trial_complete)."""
        raise NotImplementedError


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (Bergstra et al. 2011).

    Observations split at the gamma-quantile into good/bad sets; each
    numeric dimension gets a Parzen mixture (gaussians at observed
    points, bandwidth from the observed spread), categorical dims get
    smoothed frequency tables. Candidates sample from the good model
    and the one maximizing l(x)/g(x) is suggested. LogUniform dims are
    modeled in log space.
    """

    def __init__(
        self,
        n_startup: int = 10,
        gamma: float = 0.15,
        n_candidates: int = 64,
    ):
        self._n_startup = n_startup
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._obs: List[tuple] = []  # (config, objective: higher=better)

    # -- observation ---------------------------------------------------
    def record(self, config: Dict[str, Any], result, error=False):
        if error or not result or self.metric not in result:
            return
        value = float(result[self.metric])
        if self.mode == "min":
            value = -value
        self._obs.append((config, value))

    # -- modeling ------------------------------------------------------
    def _to_unit(self, key: str, value: Any) -> Optional[float]:
        dom = self.param_space[key]
        if isinstance(dom, LogUniform):
            lo, hi = math.log(dom.low), math.log(dom.high)
            return (math.log(value) - lo) / (hi - lo)
        if isinstance(dom, Uniform):
            return (value - dom.low) / (dom.high - dom.low)
        if isinstance(dom, RandInt):
            return (value - dom.low) / max(1, dom.high - 1 - dom.low)
        return None  # categorical

    def _from_unit(self, key: str, u: float) -> Any:
        dom = self.param_space[key]
        u = min(1.0, max(0.0, u))
        if isinstance(dom, LogUniform):
            lo, hi = math.log(dom.low), math.log(dom.high)
            return min(dom.high, max(dom.low, math.exp(lo + u * (hi - lo))))
        if isinstance(dom, Uniform):
            return min(
                dom.high, max(dom.low, dom.low + u * (dom.high - dom.low))
            )
        if isinstance(dom, RandInt):
            return dom.low + round(u * max(0, dom.high - 1 - dom.low))
        raise TypeError(key)

    @staticmethod
    def _bandwidths(points: List[float]) -> List[float]:
        """Per-point bandwidths = distance to the farther neighbor
        (Bergstra 2011 §4: adaptive Parzen estimator) — tight clusters
        refine, isolated points keep exploring."""
        order = sorted(range(len(points)), key=lambda i: points[i])
        bws = [0.0] * len(points)
        for pos, i in enumerate(order):
            left = points[order[pos - 1]] if pos > 0 else 0.0
            right = (
                points[order[pos + 1]] if pos + 1 < len(order) else 1.0
            )
            bws[i] = min(
                1.0, max(points[i] - left, right - points[i], 0.01)
            )
        return bws

    @staticmethod
    def _parzen_logpdf(
        points: List[float], bws: List[float], x: float
    ) -> float:
        """Mixture of per-point gaussians + a uniform prior component
        (weight 1/(n+1)), matching l(x)/g(x) of the paper."""
        if not points:
            return 0.0
        total = 1.0  # uniform prior: pdf 1 on the unit interval
        for p, bw in zip(points, bws):
            z = (x - p) / bw
            total += math.exp(-0.5 * z * z) / (bw * 2.5066282746310002)
        return math.log(total / (len(points) + 1) + 1e-12)

    def suggest(self) -> Dict[str, Any]:
        sampled = {
            k: (v.sample(self.rng) if isinstance(v, Domain) else v)
            for k, v in self.param_space.items()
        }
        if len(self._obs) < self._n_startup:
            return sampled
        # Deduplicate before modeling: repeated suggestions of the
        # same point otherwise flood the elite set with clones, the
        # spread collapses, and the model freezes on a mediocre
        # optimum (premature convergence).
        seen = set()
        distinct = []
        for cfg, val in sorted(self._obs, key=lambda o: -o[1]):
            key = tuple(
                round(v, 6) if isinstance(v, float) else v
                for v in (cfg[k] for k in sorted(cfg))
            )
            if key not in seen:
                seen.add(key)
                distinct.append((cfg, val))
        ranked = distinct
        # Optuna-style tightening: the good set grows sublinearly and
        # caps, so late-stage models sharpen around the elite instead
        # of dragging early random points along forever.
        n_good = max(2, min(25, int(math.ceil(self._gamma * len(ranked)))))
        good = [c for c, _ in ranked[:n_good]]
        bad = [c for c, _ in ranked[n_good:]] or good
        # Per-dimension models depend only on the good/bad split —
        # build once, then score all candidates against them.
        models: Dict[str, tuple] = {}
        for key, dom in self.param_space.items():
            if not isinstance(dom, Domain):
                continue
            if isinstance(dom, Choice):
                counts_g = {c: 1.0 for c in dom.categories}
                counts_b = {c: 1.0 for c in dom.categories}
                for g in good:
                    counts_g[g[key]] = counts_g.get(g[key], 1.0) + 1
                for b in bad:
                    counts_b[b[key]] = counts_b.get(b[key], 1.0) + 1
                models[key] = (
                    "choice",
                    counts_g, sum(counts_g.values()),
                    counts_b, sum(counts_b.values()),
                )
            else:
                g_pts = [self._to_unit(key, g[key]) for g in good]
                b_pts = [self._to_unit(key, b[key]) for b in bad]
                models[key] = (
                    "num",
                    g_pts, self._bandwidths(g_pts),
                    b_pts, self._bandwidths(b_pts),
                )
        best, best_score = sampled, -math.inf
        for _ in range(self._n_candidates):
            cand: Dict[str, Any] = {}
            score = 0.0
            for key, dom in self.param_space.items():
                if not isinstance(dom, Domain):
                    cand[key] = dom
                    continue
                model = models[key]
                if model[0] == "choice":
                    _, counts_g, total_g, counts_b, total_b = model
                    cats = list(counts_g)
                    pick = self.rng.choices(
                        cats, weights=[counts_g[c] for c in cats]
                    )[0]
                    cand[key] = pick
                    score += math.log(counts_g[pick] / total_g)
                    score -= math.log(counts_b[pick] / total_b)
                    continue
                _, g_pts, g_bws, b_pts, b_bws = model
                # Sample from l(x): the per-point-bandwidth mixture
                # plus its uniform prior component.
                if self.rng.random() < 1.0 / (len(g_pts) + 1):
                    u = self.rng.random()
                else:
                    i = self.rng.randrange(len(g_pts))
                    u = self.rng.gauss(g_pts[i], g_bws[i])
                u = min(1.0, max(0.0, u))
                cand[key] = self._from_unit(key, u)
                score += self._parzen_logpdf(g_pts, g_bws, u)
                score -= self._parzen_logpdf(b_pts, b_bws, u)
            if score > best_score:
                best, best_score = cand, score
        return best
