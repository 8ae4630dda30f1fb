"""The yardstick's counts against values worked by hand."""

import json

import pytest

from gpubench import counts, weights
from gpubench.tests.conftest import REPO


def arch(name):
    return weights.arch(json.loads(
        (REPO / "gpubench" / "configs" / f"{name}.json").read_text()))


def test_mistral_flops_per_token():
    a = arch("mistral-7b-v0.3")
    # 6 x 7.1138e9 multiplied parameters + 12 x 32 x 4096 x seq / 2
    assert counts.train_flops_per_token(a, 4096) == pytest.approx(45.9e9, rel=2e-3)
    assert counts.train_flops_per_token(a, 16384) == pytest.approx(55.56e9, rel=2e-3)
    assert counts.total_params(a) == pytest.approx(7.248e9, rel=1e-3)


def test_qwen3_params_and_decode_bytes():
    a = arch("qwen3-8b")
    assert counts.total_params(a) == pytest.approx(8.19e9, rel=1e-3)
    # every multiplied parameter once, the embedding table not
    assert counts.decode_weight_bytes(a) == 2 * (counts.total_params(a)
                                                 - 151936 * 4096)
    assert counts.kv_bytes_per_token(a) == 2 * 36 * 8 * 128 * 2


@pytest.mark.parametrize("q,kv", [(1, 1), (64, 64), (100, 37), (37, 100)])
def test_valid_pairs_closed_form(q, kv):
    loop = sum(min(r + 1, kv) for r in range(q))
    assert counts.valid_pairs(True, q, kv) == loop
    assert counts.valid_pairs(False, q, kv) == q * kv


def test_flash_bounds_match_the_kernel_table():
    # bh 64 (2 x 32) x 4096 x 128 causal bf16: 0.278 ms and 0.695 ms
    shape = (2, 32, 4096, 4096, 128)
    fwd = counts.bound_s(counts.flash_fwd_flops(*shape), counts.flash_io_bytes(*shape))
    bwd = counts.bound_s(counts.flash_bwd_flops(*shape),
                         counts.flash_io_bytes(*shape, backward=True))
    assert fwd[0] * 1e3 == pytest.approx(0.278, abs=1e-3) and fwd[1] == "operations"
    assert bwd[0] * 1e3 == pytest.approx(0.695, abs=1e-3) and bwd[1] == "operations"


def test_f32_work_takes_the_faster_of_cores_and_three_tf32_terms():
    flops = 1e12
    assert counts.bound_s(flops, 0.0, peak=None)[0] == pytest.approx(
        min(flops / counts.PEAK_F32_FLOPS, 3 * flops / counts.PEAK_TF32_FLOPS))
