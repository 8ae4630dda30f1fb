"""The one traffic generator: every cell's inputs come from its mix file's
parameters and the run's seed.

Training feeds uniform token ids, batch k of a run drawn from (seed, k).
Serving sends an open loop of chat requests. Their sizes and gaps are
taken at evenly spaced quantiles of the mix's distributions and put in
the order the mix's `schedule_seed` draws: every run offers the same
work at the same times (with 60 requests in a window, the order alone
moved the TTFT tail by a third from seed to seed). The run's seed draws
what the requests say: the system prefixes' and the user parts' token
ids.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def train_batch(seed: int, k: int, batch: int, seq: int, vocab: int
                ) -> np.ndarray:
    """Batch k (1-based) of a run: [batch, seq + 1] int64 token ids,
    uniform over the vocabulary. Inputs are [:, :-1], targets [:, 1:]."""
    return _rng(seed, 1, k).integers(0, vocab, size=(batch, seq + 1),
                                     dtype=np.int64)


@dataclasses.dataclass
class Request:
    index: int
    due_s: float        #: seconds after the window opens
    prefix: int         #: which system prefix, -1 for none
    prompt: List[int]
    output_tokens: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lognormal(spec: dict, n: int) -> np.ndarray:
    """n lengths at evenly spaced quantiles of a lognormal with the
    spec's median and sigma, rounded and clipped to [min, max]."""
    z = np.array([NormalDist().inv_cdf(u) for u in _quantiles(n)])
    x = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def _shares(shares: List[float], n: int) -> np.ndarray:
    """n labels 0..len(shares)-1 in the given shares (largest
    remainders take the leftovers)."""
    exact = np.array(shares, dtype=np.float64) / sum(shares) * n
    counts = np.floor(exact).astype(np.int64)
    for i in np.argsort(-(exact - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return np.repeat(np.arange(len(shares)), counts)


def request_count(mix: dict, seconds: float) -> int:
    return max(1, int(math.floor(mix["rate_per_s"] * seconds)))


def serve_requests(mix: dict, seed: int, seconds: float, vocab: int
                   ) -> List[Request]:
    """The window's requests, in order of their due times, all due
    within [0, seconds]: Poisson arrivals at the mix's rate (exponential
    gaps), a shared system prefix by the mix's shares, a lognormal user
    part and a lognormal output length."""
    n = request_count(mix, seconds)
    rng = _rng(mix["schedule_seed"], 2)
    gaps = -np.log1p(-_quantiles(n)) / mix["rate_per_s"]
    gaps *= (n / mix["rate_per_s"]) / gaps.sum()
    gaps = rng.permutation(gaps)
    user = rng.permutation(_lognormal(mix["user_tokens"], n))
    out = rng.permutation(_lognormal(mix["output_tokens"], n))
    pre = mix.get("prefixes")
    which = (rng.permutation(_shares(pre["shares"], n)) if pre
             else np.full(n, -1))
    prefixes = system_prefixes(mix, seed, vocab)
    due = np.minimum(np.cumsum(gaps), seconds)  # the last lands at n / rate
    words = _rng(seed, 5)
    reqs = []
    for i in range(n):
        head = prefixes[which[i]] if which[i] >= 0 else []
        body = words.integers(0, vocab, size=int(user[i])).tolist()
        reqs.append(Request(i, float(due[i]), int(which[i]), head + body,
                            int(out[i])))
    return reqs


def system_prefixes(mix: dict, seed: int, vocab: int) -> List[List[int]]:
    pre = mix.get("prefixes")
    if not pre:
        return []
    rng = _rng(seed, 3)
    return [rng.integers(0, vocab, size=pre["tokens"]).tolist()
            for _ in pre["shares"]]


def warmup_requests(mix: dict, seed: int, vocab: int) -> List[Request]:
    """One short request a system prefix (or one without): fills the
    prefix cache and runs every shape the window runs."""
    rng = _rng(seed, 4)
    spec = mix["warmup"]
    heads = system_prefixes(mix, seed, vocab) or [[]]
    return [Request(-1 - i, 0.0, i if mix.get("prefixes") else -1,
                    head + rng.integers(0, vocab, size=spec["user_tokens"]).tolist(),
                    spec["output_tokens"])
            for i, head in enumerate(heads)]
