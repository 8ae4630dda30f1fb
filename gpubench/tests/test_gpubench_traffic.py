"""The generator repeats per seed, and gives every seed the same work."""

import json
from collections import Counter

import numpy as np
import pytest

from gpubench import traffic
from gpubench.tests.conftest import REPO

MIX = json.loads((REPO / "gpubench" / "mixes" / "serve-chat.json").read_text())


def test_same_seed_same_requests():
    a = traffic.serve_requests(MIX, 2**33 + 1, 40, 151936)
    b = traffic.serve_requests(MIX, 2**33 + 1, 40, 151936)
    assert a == b
    c = traffic.serve_requests(MIX, 2**33 + 2, 40, 151936)
    assert [r.prompt for r in a] != [r.prompt for r in c]


def test_seeds_share_the_schedule():
    """Every seed sends the same sizes at the same times; the seed draws
    only what the requests say."""
    a = traffic.serve_requests(MIX, 7, 40, 1000)
    b = traffic.serve_requests(MIX, 2**31 + 5, 40, 1000)
    schedule = lambda rs: [(r.due_s, r.prefix, len(r.prompt), r.output_tokens)  # noqa: E731
                           for r in rs]
    assert schedule(a) == schedule(b)
    assert all(x.prompt != y.prompt for x, y in zip(a, b))
    other = dict(MIX, schedule_seed=MIX["schedule_seed"] + 1)
    c = traffic.serve_requests(other, 7, 40, 1000)
    assert schedule(c) != schedule(a)
    assert sorted(schedule(c), key=lambda s: s[1:]) != schedule(a)
    assert Counter(len(r.prompt) for r in c) == Counter(len(r.prompt) for r in a)


def test_shares_lengths_and_rate():
    n_seconds = 60
    reqs = traffic.serve_requests(MIX, 3, n_seconds, 1000)
    n = len(reqs)
    assert n == int(MIX["rate_per_s"] * n_seconds)
    assert all(0 < r.due_s <= n_seconds for r in reqs)
    assert reqs[-1].due_s == pytest.approx(n / MIX["rate_per_s"])
    assert [r.due_s for r in reqs] == sorted(r.due_s for r in reqs)
    counts = Counter(r.prefix for r in reqs)
    for i, share in enumerate(MIX["prefixes"]["shares"]):
        assert abs(counts[i] - share * n) <= 1
    user = [len(r.prompt) - MIX["prefixes"]["tokens"] for r in reqs]
    out = [r.output_tokens for r in reqs]
    for xs, spec in ((user, MIX["user_tokens"]), (out, MIX["output_tokens"])):
        assert min(xs) >= spec["min"] and max(xs) <= spec["max"]
        assert abs(np.median(xs) - spec["median"]) <= 0.02 * spec["median"]
    # every request with the same prefix starts with the same tokens
    heads = {r.prefix: tuple(r.prompt[:MIX["prefixes"]["tokens"]]) for r in reqs}
    for r in reqs:
        assert tuple(r.prompt[:MIX["prefixes"]["tokens"]]) == heads[r.prefix]
    fits = MIX["engine"]["max_len"]
    assert all(len(r.prompt) + r.output_tokens <= fits for r in reqs)


def test_train_batches_repeat_and_differ():
    a = traffic.train_batch(2**32 + 9, 1, 2, 64, 32768)
    assert a.shape == (2, 65) and a.dtype == np.int64
    assert (a == traffic.train_batch(2**32 + 9, 1, 2, 64, 32768)).all()
    assert not (a == traffic.train_batch(2**32 + 9, 2, 2, 64, 32768)).all()
    assert a.min() >= 0 and a.max() < 32768
