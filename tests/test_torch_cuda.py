"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where there is no CUDA device (the
CPU test runs). On a machine with a card and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Every output is held to its plain version relatively: max abs error at
most 1e-2 * max|ref| and L2 error at most 1e-2 * ||ref|| in bf16/f16,
1e-5 of each in f32, which stays f32 in the kernels (no TF32: f32 reads
about 1e-7, and a TF32 or bf16 product reads order 1e-4 or more, which
`test_f32_bar_rejects_tf32_and_bf16_products` checks). The backward
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
F32_REL_TOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)


def _within(got, ref, tol=REL_TOL):
    got, ref = got.float(), ref.float()
    diff = got - ref
    return (diff.abs().max() <= tol * ref.abs().max()
            and diff.norm() <= tol * ref.norm())


def _tol(dtype):
    return F32_REL_TOL if dtype == torch.float32 else REL_TOL


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
                             "flash_bwd": 1, "flash_bwd_dq": 1,
                             "flash_fwd_any": 0, "flash_bwd_any_pre": 0,
                             "flash_bwd_any": 0, "flash_bwd_any_dq": 0}
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    """Every head_dim up to 256 in bf16, f16 and f32 has a kernel; a
    larger head_dim or another dtype raises before any launch."""
    q = _randn(gen, 1, 64, 288)
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_forward(q, q, q, True, 64)
    q = _randn(gen, 1, 64, 96).double()
    with pytest.raises(ValueError, match="dtype"):
        attn.flash_forward(q, q, q, True, 64)


@pytest.mark.parametrize("dtype,t,tk,d,causal,q_len,kv_len,bh", [
    (torch.bfloat16, 256, 256, 256, True, 256, 256, 4),
    (torch.float32, 256, 256, 128, True, 256, 256, 4),
    (torch.float32, 192, 192, 256, False, 192, 150, 4),
    (torch.float16, 128, 384, 128, False, 128, 384, 4),
    (torch.bfloat16, 64, 64, 96, True, 64, 64, 2),
    (torch.bfloat16, 320, 320, 16, True, 300, 300, 2),
    (torch.float32, 128, 384, 256, True, 128, 384, 2),
])
def test_any_kernels_match_plain_versions(gen, monkeypatch, dtype, t, tk, d,
                                          causal, q_len, kv_len, bh):
    """The "any" kernels (csrc/flash_fwd_any.cu, flash_bwd_any.cu) in
    every dtype, at head_dims off the wgmma kernels' and the edges of
    their tiles, against their plain versions under a random `do`."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    def randn(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * 0.5).to(dtype)

    q, k, v, do = randn(bh, t, d), randn(bh, tk, d), randn(bh, tk, d), \
        randn(bh, t, d)
    q[:, q_len:] = 0
    k[:, kv_len:] = 0
    v[:, kv_len:] = 0
    do[:, q_len:] = 0
    q2 = attn.prescale(q, 1.0 / math.sqrt(d))
    attn.reset_launch_counts()
    out, lse = attn.flash_forward(q2, k, v, causal, kv_len)
    p_out, p_lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
    tol = _tol(dtype)
    assert out.dtype == dtype
    assert _within(out[:, :q_len], p_out[:, :q_len], tol)
    lse_tol = 1e-3 if dtype != torch.float32 else \
        F32_REL_TOL * p_lse[:, :q_len].abs().max()
    assert (lse[:, :q_len] - p_lse[:, :q_len]).abs().max() <= lse_tol
    args = (q2, k, v, out, do, lse, 1.0 / math.sqrt(d), causal, kv_len, q_len)
    got, ref = attn.flash_backward(*args), attn.flash_backward_plain(*args)
    for g, r, n in zip(got, ref, (q_len, kv_len, kv_len)):
        assert g.dtype == dtype and _within(g[:, :n], r[:, :n], tol)
    assert attn.LAUNCHES["flash_fwd"] == attn.LAUNCHES["flash_bwd"] == 0
    assert attn.LAUNCHES["flash_fwd_any"] == attn.LAUNCHES["flash_bwd_any"] == 1


def test_f32_bar_rejects_tf32_and_bf16_products(gen, monkeypatch):
    """Controls of the f32 bar: the plain f32 version with its products in
    TF32, or in bf16, lies outside it, so an f32 kernel that took either
    shortcut would fail `test_any_kernels_match_plain_versions`."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bh, t, d = 4, 256, 128
    q, k, v, do = ((torch.randn(bh, t, d, generator=gen, device="cuda")
                    * 0.5) for _ in range(4))
    q2 = attn.prescale(q, 1.0 / math.sqrt(d))
    out, lse = attn.flash_forward_plain(q2, k, v, True, t)
    args = (q2, k, v, out, do, lse, 1.0 / math.sqrt(d), True, t, t)
    ref = attn.flash_backward_plain(*args)
    half = [x.bfloat16().float() for x in (q2, k, v)]
    assert not _within(attn.flash_forward_plain(*half, True, t)[0], out,
                       F32_REL_TOL)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert not _within(attn.flash_forward_plain(q2, k, v, True, t)[0], out,
                       F32_REL_TOL)
    assert not all(_within(g, r, F32_REL_TOL) for g, r in
                   zip(attn.flash_backward_plain(*args), ref))
