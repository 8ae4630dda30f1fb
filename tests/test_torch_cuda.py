"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where there is no CUDA device (the
CPU test runs). On a machine with a card and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py

Every output is held to its plain version relatively: max abs error at
most 1e-2 * max|ref| and L2 error at most 1e-2 * ||ref|| in bf16/f16,
1e-5 of each in f32 (the f32 kernels multiply in three-term TF32: they
read about 1e-7 to 1e-6, while one TF32 term or a bf16 product reads
order 1e-4 or more, which `test_f32_bar_rejects_tf32_and_bf16_products` and
`test_three_term_scores_alone_meet_the_f32_bar` check). The backward
runs under a random upstream gradient, so that every row of `do`
matters to dq, dk and dv. The shapes include the edges of the kernels'
128-row q tiles and 64-row KV tiles: a partial last tile (t 192), a
single partial tile (t 64), q and KV of different lengths, kv_len inside
a tile, q rows past q_len, and one head; and head_dims that overhang a
64-column box (96, 160), and above 256 (320, 352, 512, 608, 704: the
"wide" kernels; above 512 the 16-bit forward streams Q; the 16-bit
backward streams every box but its chunk's through a ring). The f32
forward's edges: t 64 and 192 against its q tiles, kv_len inside its 64-row and
32-row KV tiles, and its 32-column last chunk of O. The f32 "wide" pair's:
a 32-column last K box, a last chunk of 64 to 192 columns, Q2 read from
global memory (d above 512), t 64, kv_len inside a 32-row KV tile, ragged
q_len and causal t_q != t_k; and the "wide" chunks agree to the bit in
every dtype.

The paged decode kernel (`csrc/paged_decode.cu`) is held to its plain
version (`ops/paged_attention.paged_attention_plain`, the scatter, gather
and f32 attention of the serving step) by the same bars on the live
rows' output, and to the byte on the pools after its append: head_dim
64/128/256, groups 1 to 12, bf16/f16/f32, scrambled tables, rows of 1,
15, 16, 17, 1535 and 1536 tokens, a dead row masked to the null block,
a live row whose table holds block 0, and a shared prefix block that no
row may write.
"""

import ctypes

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
                             "flash_bwd_any": 0, "flash_bwd_any_dq": 0,
                             "flash_fwd_wide": 0, "flash_bwd_wide": 0}
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    """Every head_dim in bf16, f16 and f32 has a kernel; an empty
    head_dim or another dtype raises before any launch."""
    attn.reset_launch_counts()
    q = _randn(gen, 1, 64, 0)
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_forward(q, q, q, True, 64)
    q = _randn(gen, 1, 64, 96).double()
    with pytest.raises(ValueError, match="dtype"):
        attn.flash_forward(q, q, q, True, 64)
    assert all(n == 0 for n in attn.LAUNCHES.values())


@pytest.mark.parametrize("dtype,t,tk,d,causal,q_len,kv_len,bh", [
    (torch.bfloat16, 256, 256, 256, True, 256, 256, 4),
    (torch.float32, 256, 256, 128, True, 256, 256, 4),
    (torch.float32, 192, 192, 256, False, 192, 150, 4),
    (torch.float16, 128, 384, 128, False, 128, 384, 4),
    (torch.bfloat16, 64, 64, 96, True, 64, 64, 2),
    (torch.bfloat16, 320, 320, 16, True, 300, 300, 2),
    (torch.float32, 128, 384, 256, True, 128, 384, 2),
    # The 16-bit wgmma kernels at the edges of their 128-row q tile and
    # 64-row KV tile, and at head_dims that overhang a 64-column box.
    (torch.float16, 256, 256, 256, True, 256, 256, 4),
    (torch.bfloat16, 64, 64, 256, True, 64, 64, 4),
    (torch.float16, 192, 192, 256, True, 192, 192, 4),
    (torch.bfloat16, 192, 192, 192, True, 192, 192, 4),
    (torch.bfloat16, 64, 64, 192, False, 64, 40, 4),
    (torch.bfloat16, 256, 256, 256, False, 256, 100, 2),
    (torch.float16, 320, 320, 256, True, 300, 300, 2),
    (torch.bfloat16, 128, 384, 256, True, 128, 384, 2),
    (torch.bfloat16, 384, 128, 192, True, 384, 128, 2),
    (torch.bfloat16, 256, 256, 160, True, 256, 256, 2),
    # The "wide" kernels, head_dim above 256.
    (torch.bfloat16, 256, 256, 320, True, 256, 256, 2),
    (torch.float16, 192, 192, 512, True, 192, 170, 2),
    (torch.float32, 128, 256, 512, True, 128, 256, 2),
    (torch.float32, 256, 256, 320, False, 250, 200, 2),
    # The f32 forward (three-term TF32) at its tiles' edges: two consumers
    # and 64-row KV tiles up to d 128, 32-row ones above, one consumer
    # above d 192; a 32-column last chunk of O at d 32, 96 and 224.
    (torch.float32, 64, 64, 128, True, 64, 64, 2),
    (torch.float32, 192, 192, 96, False, 192, 40, 2),
    (torch.float32, 320, 320, 64, True, 300, 290, 2),
    (torch.float32, 64, 64, 256, True, 64, 64, 2),
    (torch.float32, 128, 128, 192, False, 128, 72, 2),
    (torch.float32, 320, 320, 224, True, 300, 270, 2),
    (torch.float32, 384, 128, 64, True, 384, 128, 2),
    (torch.float32, 192, 192, 32, True, 192, 192, 2),
    # The 16-bit "wide" forward (wgmma): an overhanging last box and a
    # 2-box last chunk (352), Q streamed through the ring (608, 704).
    (torch.bfloat16, 256, 256, 352, True, 256, 256, 2),
    (torch.float16, 192, 192, 352, False, 192, 150, 2),
    (torch.bfloat16, 192, 192, 608, True, 192, 192, 1),
    (torch.float16, 128, 128, 704, True, 100, 128, 1),
    # The f32 "wide" pair (three-term TF32): a 32-column last K box and a
    # 96-column last chunk (352), Q2 read from global memory and three
    # chunks (608, 704), half a q tile (t 64), kv_len inside a 32-row KV
    # tile, ragged q_len, and causal t_q != t_k.
    (torch.float32, 256, 256, 352, True, 256, 256, 2),
    (torch.float32, 192, 192, 608, True, 192, 192, 1),
    (torch.float32, 128, 128, 704, True, 100, 128, 1),
    (torch.float32, 64, 64, 512, True, 64, 64, 2),
    (torch.float32, 192, 192, 512, False, 192, 170, 2),
    (torch.float32, 128, 384, 512, True, 128, 384, 2),
    (torch.float32, 320, 320, 320, True, 300, 280, 2),
    # The 16-bit "wide" backward (wgmma, 64-row KV and q tiles, boxes of
    # K, Q2, V and dO through a ring): t 64 (one tile), kv_len inside a
    # tile, ragged q_len, causal t_q != t_k both ways, at d 352 (an
    # overhanging last box, a 2-box last chunk), 512, 608 and 704.
    (torch.bfloat16, 64, 64, 352, True, 64, 64, 2),
    (torch.float16, 256, 256, 608, False, 256, 100, 1),
    (torch.bfloat16, 320, 320, 704, True, 300, 300, 1),
    (torch.float16, 128, 384, 512, True, 128, 384, 1),
    (torch.bfloat16, 384, 128, 352, True, 384, 128, 2),
    # The f32 backward up to head_dim 256 on the three-term TF32 kernel
    # (8, 16 or 32 columns a warp): t 64, kv_len inside a 32-row KV tile,
    # ragged q_len, causal t_q != t_k, at d 32, 96, 224 and 256.
    (torch.float32, 64, 64, 32, True, 64, 64, 2),
    (torch.float32, 256, 256, 96, False, 256, 100, 2),
    (torch.float32, 320, 320, 224, True, 300, 280, 2),
    (torch.float32, 384, 128, 96, True, 384, 128, 2),
    (torch.float32, 192, 192, 256, True, 170, 192, 2),
])
def test_any_kernels_match_plain_versions(gen, monkeypatch, dtype, t, tk, d,
                                          causal, q_len, kv_len, bh):
    """The "any" and "wide" kernels (csrc/flash_fwd_any.cu,
    flash_bwd_any.cu) in every dtype, at head_dims off the wgmma
    kernels' and the edges of their tiles, against their plain versions
    under a random `do`."""
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
    pair = attn._kernel_for(dtype, d)
    assert attn.LAUNCHES["flash_fwd"] == attn.LAUNCHES["flash_bwd"] == 0
    assert attn.LAUNCHES[f"flash_fwd_{pair}"] == 1
    assert attn.LAUNCHES[f"flash_bwd_{pair}"] == 1
    assert attn.LAUNCHES["flash_bwd_any_pre"] == 1
    assert attn.LAUNCHES["flash_bwd_any_dq"] == 1


@pytest.mark.parametrize("d", [512, 608])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wide_chunks_agree_to_the_bit(gen, dtype, d):
    """Every 256-column chunk of the "wide" kernels forms S (and dP) over
    all of d in one order: with q, k, v and do made of equal column
    chunks, the chunks of out, dk and dv come out equal bit for bit (their
    P, lse and dS agree; dq sums in f32 reductions of no fixed order)."""
    bh, t = 2, 256
    def chunked(rows):
        x = torch.randn(bh, rows, 256, generator=gen, device="cuda") * 0.5
        return x.repeat(1, 1, -(-d // 256))[..., :d].to(dtype).contiguous()

    q2 = attn.prescale(chunked(t), 1.0 / math.sqrt(d))
    k, v, do = chunked(t), chunked(t), chunked(t)
    out, lse = attn.flash_forward(q2, k, v, True, t)
    args = (q2, k, v, out, do, lse, 1.0 / math.sqrt(d), True, t, t)
    _, dk, dv = attn.flash_backward(*args)
    torch.cuda.synchronize()
    for x in (out, dk, dv):
        for c0 in range(256, d, 256):
            w = min(256, d - c0)
            assert torch.equal(x[..., c0:c0 + w], x[..., :w])


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


def test_three_term_scores_alone_meet_the_f32_bar(gen, monkeypatch):
    """The f32 forward's product alone, S = q2 k^T at d 256 through the
    library's check entry point (the kernel's tensor-core chains), within
    the f32 bar of the plain f32 product and equal bit for bit to the same
    product split by cvt.rna.tf32.f32; one TF32 term (the plain product in
    TF32) lies outside the bar."""
    fn = attn._build.load("flash_fwd_any").rtt_scores_tf32x3
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bh, t, d = 2, 256, 256
    q, k = (torch.randn(bh, t, d, generator=gen, device="cuda") * 0.5
            for _ in range(2))
    q2 = attn.prescale(q, 1.0 / math.sqrt(d))
    ref = torch.matmul(q2, k.transpose(1, 2))
    got = {mode: torch.empty_like(ref) for mode in (0, 2)}
    for mode, s in got.items():
        assert fn(q2.data_ptr(), k.data_ptr(), s.data_ptr(), bh, t, t, d,
                  mode, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert _within(got[0], ref, F32_REL_TOL)
    assert torch.equal(got[0], got[2])  # the split's rounding is cvt.rna's
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert not _within(torch.matmul(q2, k.transpose(1, 2)), ref, F32_REL_TOL)


# ---------------------------------------------------------------------------
# the paged decode kernel (csrc/paged_decode.cu) against its plain version
# ---------------------------------------------------------------------------

#: Row lengths (the step's token at length - 1) around a 16-token block's
#: edges and at the 96-block table's end.
PAGED_LENGTHS = (1, 15, 16, 17, 1535, 1536)


def _paged_case(gen, dtype, d, group, kv_heads=2, bl=16, nb=96,
                lengths=PAGED_LENGTHS, dead=True):
    """A decode step's inputs: one row a length on scrambled tables, rows
    3-5 sharing their first block (a prefix hit, never written), and (if
    `dead`) one dead row last whose table held that shared block and a
    stale position inside it, masked to the null block 0 as
    `_paged_decode_step_impl` masks it. Returns (args, shared block id,
    live rows)."""
    rows = len(lengths) + dead
    n_blocks = rows * nb + 1
    tables = (torch.randperm(rows * nb, generator=gen, device="cuda")
              + 1).view(rows, nb)
    shared = int(tables[3, 0])
    tables[4:, 0] = shared
    positions = torch.tensor([n - 1 for n in lengths] + [5] * dead,
                             device="cuda")
    alive = torch.arange(rows, device="cuda") < len(lengths)
    tables = torch.where(alive[:, None], tables, 0)
    pool_shape = (n_blocks, kv_heads, bl, d)

    def randn(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).to(
            dtype)

    q = randn(rows, kv_heads * group, 1, d)
    k = randn(rows, kv_heads, 1, d)
    v = randn(rows, 1, kv_heads, d).transpose(1, 2)  # the model's layout
    args = (q, k, v, randn(*pool_shape), randn(*pool_shape), tables,
            positions[:, None], positions + 1)
    return args, shared, alive


def _paged_both(args):
    """(kernel's result, its pools, plain version's result, its pools),
    each on its own copy of the pools."""
    from ray_tpu_torch.ops import paged_attention as pa

    q, k, v, kp, vp, tables, q_pos, valid = args
    kp2, vp2 = kp.clone(), vp.clone()
    kp, vp = kp.clone(), vp.clone()
    out = pa.paged_decode_attention(q, k, v, kp, vp, tables, q_pos, valid)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(q, k, v, kp2, vp2, tables, q_pos, valid)
    return out, (kp, vp), ref, (kp2, vp2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_paged_decode_matches_plain_version(gen, d, group, dtype):
    """Output within the dtype's bar of the plain version, the dead
    row's too (it reads the null block as the plain version does), the
    pools after the append equal to the byte, the shared prefix block
    untouched, one launch."""
    from ray_tpu_torch.ops import paged_attention as pa

    args, shared, alive = _paged_case(gen, dtype, d, group)
    before = (args[3][shared].clone(), args[4][shared].clone())
    pa.reset_launch_counts()
    out, pools, ref, ref_pools = _paged_both(args)
    assert pa.LAUNCHES == {"paged_decode": 1}
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    assert _within(out[alive], ref[alive], _tol(dtype))
    assert _within(out[~alive], ref[~alive], _tol(dtype))
    for got, want, old in zip(pools, ref_pools, before):
        assert torch.equal(got, want)
        assert torch.equal(got[shared], old)


@pytest.mark.parametrize("row", [0, 1, 5])
def test_paged_decode_reads_block_zero_in_a_live_row(gen, row):
    """Block 0 is a block like any other: a live row whose table holds it
    (first, where the rows of 1 and 15 tokens append into it, or inside
    the 1536-token row's table) attends over it as the plain version
    does."""
    args, _, _ = _paged_case(gen, torch.bfloat16, 128, 4, dead=False)
    tables = args[5]
    tables[row, 0 if row < 4 else 50] = 0
    out, pools, ref, ref_pools = _paged_both(args)
    assert _within(out, ref)
    for got, want in zip(pools, ref_pools):
        assert torch.equal(got, want)


@pytest.mark.parametrize("group,bl", [(2, 16), (3, 8), (8, 16), (12, 16)])
def test_paged_decode_groups_and_block_lengths(gen, group, bl):
    """Groups padded to the kernel's head width (3), at its widest (8)
    and split over two CTAs (12), and 8-token blocks, in bf16 at 128."""
    args, _, alive = _paged_case(gen, torch.bfloat16, 128, group, bl=bl,
                                 nb=1536 // bl)
    out, pools, ref, ref_pools = _paged_both(args)
    assert _within(out[alive], ref[alive])
    for got, want in zip(pools, ref_pools):
        assert torch.equal(got, want)


def test_paged_decode_bar_rejects_one_token_short(gen):
    """In f32 the kernel's output lies outside the bar of the plain
    version attending one token fewer a row."""
    from ray_tpu_torch.ops import paged_attention as pa

    args, _, alive = _paged_case(gen, torch.float32, 128, 4)
    out, _, ref, _ = _paged_both(args)
    assert _within(out[alive], ref[alive], F32_REL_TOL)
    q, k, v, kp, vp, tables, q_pos, valid = args
    short = pa.paged_attention_plain(q, k, v, kp.clone(), vp.clone(), tables,
                                     q_pos, valid - 1)
    assert not _within(out[alive], short[alive], F32_REL_TOL)


def test_paged_decode_clamps_a_stale_position_to_the_table(gen):
    """A position at or past the table's end writes into the table's last
    block (at position % block_len), and is read there, as the plain
    version does."""
    args, _, alive = _paged_case(gen, torch.bfloat16, 128, 4,
                                 lengths=(1537, 2000, 17, 40, 1536, 300))
    out, pools, ref, ref_pools = _paged_both(args)
    assert _within(out[alive], ref[alive])
    for got, want in zip(pools, ref_pools):
        assert torch.equal(got, want)


def test_paged_decode_rejects_what_the_kernel_does_not_take(gen):
    """head_dim 96, a pool that is not contiguous, int32 indices and
    mixed dtypes raise before any launch."""
    from ray_tpu_torch.ops import paged_attention as pa

    pa.reset_launch_counts()
    args, _, _ = _paged_case(gen, torch.bfloat16, 128, 4)
    q, k, v, kp, vp, tables, q_pos, valid = args
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention(q[..., :96], k[..., :96], v[..., :96],
                                  kp[..., :96].contiguous(),
                                  vp[..., :96].contiguous(), tables, q_pos,
                                  valid)
    wide = torch.cat([kp, kp], dim=2)[:, :, ::2]  # strided blocks
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(q, k, v, wide, wide, tables, q_pos, valid)
    with pytest.raises(ValueError, match="int64"):
        pa.paged_decode_attention(q, k, v, kp, vp, tables.int(), q_pos, valid)
    with pytest.raises(ValueError, match="float32"):
        pa.paged_decode_attention(q, k.float(), v, kp, vp, tables, q_pos,
                                  valid)
    assert pa.LAUNCHES == {"paged_decode": 0}


def test_paged_decode_step_launches_once_a_layer(gen, monkeypatch):
    """`paged_decode_step` on a small bf16 model: one kernel launch a
    layer, logits within the bar of the same step through the plain
    version."""
    from ray_tpu_torch.models import generate, llama
    from ray_tpu_torch.ops import paged_attention as pa

    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, intermediate=512, max_seq_len=256,
                            dtype=torch.bfloat16, remat=False)
    model = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        3), device="cuda")
    tables = torch.arange(1, 17, device="cuda").view(2, 8)
    tokens = torch.randint(0, 512, (2, 40), generator=gen, device="cuda")
    positions = torch.tensor([40, 40], device="cuda")
    alive = torch.tensor([True, True], device="cuda")
    steps = {}
    for name in ("kernel", "plain"):
        if name == "plain":
            monkeypatch.setattr(pa, "paged_decode_attention",
                                pa.paged_attention_plain)
        pool = generate.init_block_pool(cfg, 17, 16, device="cuda")
        logits, pool = generate.paged_prefill(model, cfg, tokens, pool,
                                              tables, 0, 40)
        pa.reset_launch_counts()
        steps[name] = generate.paged_decode_step(
            model, cfg, pool, tables, logits[:, -1], positions, alive)
        assert pa.LAUNCHES["paged_decode"] == (2 if name == "kernel" else 0)
    assert torch.equal(steps["kernel"][0], steps["plain"][0])
    assert _within(steps["kernel"][2], steps["plain"][2])
