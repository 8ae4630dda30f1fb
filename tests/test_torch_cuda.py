"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where there is no CUDA device (the
CPU test runs). On a machine with a card and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Every output is held to its plain version relatively: max abs error at
most 1e-2 * max|ref| and L2 error at most 1e-2 * ||ref||. The backward
runs under a random upstream gradient, so that every row of `do`
matters to dq, dk and dv. The shapes include the edges of the kernels'
128-row tiles: a partial last tile (t 192), a single partial tile
(t 64), q and KV of different lengths, kv_len inside a tile, and one
head.
"""

import math

import pytest
import torch

from ray_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.cuda

REL_TOL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)


def _within(got, ref):
    got, ref = got.float(), ref.float()
    diff = got - ref
    return (diff.abs().max() <= REL_TOL * ref.abs().max()
            and diff.norm() <= REL_TOL * ref.norm())


def _case(gen, t, tk, d, causal, q_len, kv_len, bh=4):
    q2 = attn.prescale(_randn(gen, bh, t, d), 1.0 / math.sqrt(d))
    k, v = _randn(gen, bh, tk, d), _randn(gen, bh, tk, d)
    q2[:, q_len:] = 0
    k[:, kv_len:] = 0
    v[:, kv_len:] = 0
    out, lse = attn.flash_forward(q2, k, v, causal, kv_len)
    do = _randn(gen, bh, t, d)
    do[:, q_len:] = 0
    args = (q2, k, v, out, do, lse, 1.0 / math.sqrt(d), causal, kv_len, q_len)
    return out, lse, args


@pytest.mark.parametrize("t,tk,d,causal,q_len,kv_len,bh", [
    (256, 256, 128, True, 256, 256, 4),
    (128, 512, 64, False, 128, 512, 4),
    (320, 320, 128, True, 300, 300, 4),
    (192, 192, 128, True, 192, 192, 4),
    (64, 64, 128, True, 64, 64, 4),
    (128, 384, 128, False, 128, 384, 4),
    (256, 256, 128, False, 256, 200, 4),
    (256, 256, 128, True, 256, 256, 1),
    (192, 192, 64, True, 192, 192, 4),
])
def test_kernels_match_plain_versions(gen, t, tk, d, causal, q_len, kv_len, bh):
    out, lse, args = _case(gen, t, tk, d, causal, q_len, kv_len, bh)
    q2, k, v = args[:3]
    p_out, p_lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
    assert _within(out[:, :q_len], p_out[:, :q_len])
    assert (lse[:, :q_len] - p_lse[:, :q_len]).abs().max() <= 1e-3
    rows = (q_len, kv_len, kv_len)
    got, ref = attn.flash_backward(*args), attn.flash_backward_plain(*args)
    for g, r, n in zip(got, ref, rows):
        assert _within(g[:, :n], r[:, :n])


def test_bars_reject_a_wrong_backward(gen):
    """A dq left at zero, or a backward fed `do` one row off, fails."""
    _, _, args = _case(gen, 256, 256, 128, True, 256, 256)
    dq, dk, dv = attn.flash_backward_plain(*args)
    assert not _within(torch.zeros_like(dq), dq)
    shifted = list(args)
    shifted[4] = args[4].roll(1, dims=1)  # do
    for g, r in zip(attn.flash_backward(*shifted), (dq, dk, dv)):
        assert not _within(g, r)


def test_backward_op_is_three_launches_and_returns_q_dtype(gen):
    _, _, args = _case(gen, 192, 192, 128, True, 192, 192)
    attn.reset_launch_counts()
    dq, dk, dv = attn.flash_backward(*args)
    assert attn.LAUNCHES == {"flash_fwd": 0, "flash_bwd_pre": 1,
                             "flash_bwd": 1, "flash_bwd_dq": 1}
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q = _randn(gen, 1, 64, 96)
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_forward(q, q, q, True, 64)
    with pytest.raises(ValueError, match="dtype"):
        attn.flash_forward(q.float(), q.float(), q.float(), True, 64)
