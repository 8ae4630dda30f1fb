"""Parity of the PyTorch port's ops (`ray_tpu_torch.ops`) with the JAX
package's (`ray_tpu.ops`) on the CPU.

The same numpy inputs, drawn from a seed, go to both packages. On the
CPU the port's kernel wrappers run their plain versions; the JAX
kernels run in Pallas interpret mode (`_flash_forward`,
`_flash_backward_fused`, `flash_attention(force_pallas=True)`)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jax_attn
from ray_tpu.ops import norms as jax_norms
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops import norms

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

NORM_TOL = 1e-6  # f32 elementwise chains: a few ulps
FWD_TOL = 2e-5  # f32 forward, as tests/test_ops.py holds the JAX kernel
GRAD_TOL = 5e-4  # f32 gradients, as tests/test_ops.py
BF16_REL_TOL = 2e-2  # bf16 outputs: a few bf16 ulps (2^-8) of the largest


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


class TestNorms:
    @pytest.mark.parametrize("offset", [0.0, 1.0])
    def test_rms_norm(self, offset):
        x, w = _rand(0, 2, 5, 64), _rand(1, 64)
        want = jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                                  offset=offset)
        got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                             eps=1e-5, offset=offset)
        _close(got, want, NORM_TOL)

    @pytest.mark.parametrize("scaling", [
        None,
        ("linear", 4.0, 1.0, 4.0, 8192),
        ("llama3", 8.0, 1.0, 4.0, 8192),
    ])
    def test_rope(self, scaling):
        head_dim, theta = 128, 500000.0
        _close(norms.rope_frequencies(head_dim, theta, scaling),
               jax_norms.rope_frequencies(head_dim, theta, scaling), NORM_TOL)
        pos = np.arange(64, dtype=np.int32).reshape(2, 32)
        cos, sin = norms.rotary_embedding(torch.from_numpy(pos), head_dim,
                                          theta, scaling)
        jcos, jsin = jax_norms.rotary_embedding(jnp.asarray(pos), head_dim,
                                                theta, scaling)
        # Angles reach 31 rad: cos/sin of equal f32 angles, library ulps.
        _close(cos, jcos, 1e-5)
        _close(sin, jsin, 1e-5)
        x = _rand(2, 2, 3, 32, head_dim)
        _close(norms.apply_rotary(torch.from_numpy(x), cos, sin),
               jax_norms.apply_rotary(jnp.asarray(x), jcos, jsin), 1e-5)

    def test_swiglu(self):
        x, gate = _rand(4, 3, 40), _rand(5, 3, 40)
        _close(norms.swiglu(torch.from_numpy(x), torch.from_numpy(gate)),
               jax_norms.swiglu(jnp.asarray(x), jnp.asarray(gate)), NORM_TOL)


class TestReference:
    @pytest.mark.parametrize("causal,tq,tk", [
        (True, 64, 64), (False, 64, 64), (True, 32, 64), (False, 32, 96),
    ])
    def test_mha_reference(self, causal, tq, tk):
        q, k, v = _rand(6, 2, 3, tq, 16), _rand(7, 2, 3, tk, 16), _rand(8, 2, 3, tk, 16)
        want = jax_attn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal)
        got = attn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
        _close(got, want, FWD_TOL)

    @pytest.mark.parametrize("rep", [1, 3])
    def test_repeat_kv(self, rep):
        k = _rand(9, 2, 2, 5, 4)
        _close(attn.repeat_kv(torch.from_numpy(k), rep),
               jax_attn.repeat_kv(jnp.asarray(k), rep), 0.0)


class TestFlashForwardKernel:
    """The forward kernel's plain version against `_flash_forward` in
    interpret mode: out and the log2-domain lse."""

    @pytest.mark.parametrize("causal,t,tk,kv_len", [
        (True, 256, 256, 256),
        (False, 256, 256, 256),
        (True, 128, 256, 256),
        (False, 128, 256, 200),
    ])
    def test_plain_forward_matches_pallas(self, causal, t, tk, kv_len):
        q, k, v = _rand(10, 2, t, 64), _rand(11, 2, tk, 64), _rand(12, 2, tk, 64)
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        scale = 1.0 / math.sqrt(64)
        j_out, j_lse = jax_attn._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
            128, 128, kv_len)
        q2 = attn.prescale(torch.from_numpy(q), scale)
        out, lse = attn.flash_forward(q2, torch.from_numpy(k),
                                      torch.from_numpy(v), causal, kv_len)
        assert out.shape == (2, t, 64) and lse.shape == (2, t)
        _close(out, j_out, FWD_TOL)
        _close(lse, np.asarray(j_lse)[:, 0, :], FWD_TOL)


class TestFlashAttentionPublic:
    # 192 is one and a half of the kernels' 128-row tiles, 129 pads to
    # two and a half.
    @pytest.mark.parametrize("t,causal", [
        (100, True), (300, True), (300, False), (192, True), (129, True),
    ])
    def test_ragged_matches_pallas(self, t, causal):
        q, k, v = _rand(13, 1, 2, t, 64), _rand(14, 1, 2, t, 64), _rand(15, 1, 2, t, 64)
        want = jax_attn.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            force_pallas=True)
        got = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal)
        assert got.shape == q.shape
        _close(got, want, FWD_TOL)

    def test_causal_cross_lengths_follow_kernel_mask(self):
        """t_q != t_k, causal: the kernels align the mask top-left, the
        reference bottom-right; the port follows the kernels."""
        q, k, v = _rand(16, 1, 1, 128, 64), _rand(17, 1, 1, 256, 64), _rand(18, 1, 1, 256, 64)
        want = jax_attn.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            force_pallas=True)
        got = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
        _close(got, want, FWD_TOL)


class TestFlashBackwardKernel:
    @pytest.mark.parametrize("causal,t,tk,kv_len,q_len", [
        (True, 256, 256, 256, 256),
        (False, 256, 256, 256, 256),
        (True, 256, 256, 200, 200),
    ])
    def test_plain_backward_matches_pallas(self, causal, t, tk, kv_len, q_len):
        q, k, v, do = (_rand(20 + i, 2, n, 64) for i, n in enumerate((t, tk, tk, t)))
        q[:, q_len:] = 0
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        do[:, q_len:] = 0
        scale = 1.0 / math.sqrt(64)
        j_out, j_lse = jax_attn._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
            128, 128, kv_len)
        want = jax_attn._flash_backward_fused(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_out, j_lse,
            jnp.asarray(do), scale, causal, 128, 128, kv_len, q_len)
        out = torch.from_numpy(np.array(j_out))
        lse = torch.from_numpy(np.asarray(j_lse)[:, 0, :].copy())
        got = attn.flash_backward(
            attn.prescale(torch.from_numpy(q), scale), torch.from_numpy(k),
            torch.from_numpy(v), out, torch.from_numpy(do), lse, scale, causal,
            kv_len, q_len)
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=name)

    @pytest.mark.parametrize("causal,t,kv_len", [(True, 192, 192), (False, 256, 200)])
    def test_bf16_backward_op_matches_pallas(self, causal, t, kv_len):
        """In bf16 the op returns dq in q's dtype, as `_flash_backward_fused`
        does, with delta computed inside it from `out` and `do`."""
        q, k, v, do = (_rand(40 + i, 2, t, 64) for i in range(4))
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
        scale = 1.0 / math.sqrt(64)
        # 64-row blocks: the JAX kernels take whole blocks.
        j_out, j_lse = jax_attn._flash_forward(jq, jk, jv, scale, causal, 64,
                                               64, kv_len)
        want = jax_attn._flash_backward_fused(jq, jk, jv, j_out, j_lse, jdo,
                                              scale, causal, 64, 64, kv_len, t)

        def bf16(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

        got = attn.flash_backward(
            attn.prescale(bf16(jq), scale), bf16(jk), bf16(jv), bf16(j_out),
            bf16(jdo), torch.from_numpy(np.asarray(j_lse)[:, 0, :].copy()),
            scale, causal, kv_len, t)
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == torch.bfloat16, name
            w = np.asarray(w, np.float32)
            # Both round P and dS to bf16 before their products and the
            # outputs to bf16 after; the f32 sums differ in order only.
            err = np.abs(g.float().numpy() - w).max()
            assert err <= BF16_REL_TOL * np.abs(w).max(), (name, err)

    @pytest.mark.parametrize("t,tk,causal", [
        (256, 256, True), (256, 256, False), (100, 100, True), (128, 256, True),
        (192, 192, True), (129, 129, True),
    ])
    def test_autograd_matches_jax_grad(self, t, tk, causal):
        q, k, v = _rand(30, 1, 2, t, 64), _rand(31, 1, 2, tk, 64), _rand(32, 1, 2, tk, 64)

        def jax_loss(q, k, v):
            out = jax_attn.flash_attention(q, k, v, causal=causal,
                                           force_pallas=True)
            return jnp.sum(out * out)

        want = jax.grad(jax_loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = attn.flash_attention(qt, kt, vt, causal=causal)
        got = torch.autograd.grad((out * out).sum(), (qt, kt, vt))
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=name)


class TestKernelDispatch:
    """`_kernel_for` pins which kernel pair takes each (dtype, head_dim):
    the wgmma kernels take bf16 at 64 and 128, the "any" kernels every
    other head_dim up to 256 in bf16, f16 and f32, the "wide" kernels
    every head_dim above 256 in those dtypes; nothing else."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                       torch.float32])
    def test_every_head_dim_up_to_256(self, dtype):
        """Every head_dim up to 256, and on to 2 * 256 + 1, has its pair."""
        for d in range(1, 2 * attn.MAX_HEAD_DIM + 2):
            want = ("wgmma" if dtype == torch.bfloat16 and d in (64, 128)
                    else "any" if d <= attn.MAX_HEAD_DIM else "wide")
            assert attn._kernel_for(dtype, d) == want, d

    @pytest.mark.parametrize("dtype,d", [
        (torch.bfloat16, 257), (torch.float32, 512), (torch.float16, 320),
        (torch.bfloat16, 4096),
    ])
    def test_head_dims_above_256_pick_the_wide_pair(self, dtype, d):
        assert attn._kernel_for(dtype, d) == "wide"
        assert d + (-d % attn.ANY_D_STEP) in attn.WIDE_HEAD_DIMS

    @pytest.mark.parametrize("dtype,d,match", [
        (torch.float16, 0, "head_dim"), (torch.bfloat16, -32, "head_dim"),
        (torch.float64, 64, "dtype"), (torch.int32, 128, "dtype"),
        (torch.float64, 512, "dtype"),
    ])
    def test_what_no_kernel_takes_raises(self, dtype, d, match):
        with pytest.raises(ValueError, match=match):
            attn._kernel_for(dtype, d)

    def test_zero_padded_head_dim_is_exact(self):
        """The "any" wrappers pad d with zero columns to a multiple of 32
        (`_pad_d`): on the plain versions out and lse are unchanged to the
        bit, the padded columns of every output are zero, and the true
        columns of dq, dk and dv move by f32 rounding only (the CPU's
        blocked sums over d group the terms otherwise once d grows; the
        kernels add the zero columns last, which changes nothing)."""
        d, scale = 96 - 16, 1.0 / math.sqrt(80)
        q, k, v, do = (torch.from_numpy(_rand(60 + i, 2, 128, d))
                       for i in range(4))
        q2 = attn.prescale(q, scale)
        out, lse = attn.flash_forward_plain(q2, k, v, True, 128)
        grads = attn.flash_backward_plain(q2, k, v, out, do, lse, scale, True,
                                          128, 128)
        q2p, kp, vp, outp, dop = attn._pad_d(q2, k, v, out, do)
        assert q2p.shape[-1] == 96 and q2p.is_contiguous()
        out_p, lse_p = attn.flash_forward_plain(q2p, kp, vp, True, 128)
        grads_p = attn.flash_backward_plain(q2p, kp, vp, outp, dop, lse_p,
                                            scale, True, 128, 128)
        assert torch.equal(out_p[..., :d], out) and torch.equal(lse_p, lse)
        assert not out_p[..., d:].any()
        for g, gp in zip(grads, grads_p):
            torch.testing.assert_close(gp[..., :d], g, rtol=1e-5, atol=1e-6)
            assert not gp[..., d:].any()


def _split_forward(q2, k, v, causal, kv_len, chunk=256, width=32):
    """The forward as the "wide" kernel computes it: S summed over
    `width`-column slices of d in order, then out chunk by chunk of
    `chunk` columns, each from the same P."""
    t, tk, d = q2.shape[1], k.shape[1], q2.shape[2]
    s = torch.zeros(q2.shape[0], t, tk)
    for d0 in range(0, d, width):
        s += torch.matmul(q2[..., d0:d0 + width].float(),
                          k[..., d0:d0 + width].float().transpose(1, 2))
    s.masked_fill_(~attn._valid_mask(t, tk, causal, kv_len, s.device),
                   attn.DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = (s - m).exp2()
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    pt = p.to(v.dtype).float()
    out = torch.cat([torch.matmul(pt, v[..., c0:c0 + chunk].float()) / l_safe
                     for c0 in range(0, d, chunk)], dim=-1)
    return out.to(q2.dtype), (m + torch.log2(l_safe))[..., 0]


def _split_backward(q2, k, v, out, do, lse, scale, causal, kv_len, q_len,
                    chunk=256, width=32):
    """The backward as the "wide" kernel computes it: S and dP summed over
    slices of d, then dq, dk and dv chunk by chunk from the same P, dS."""
    t, tk, d = q2.shape[1], k.shape[1], q2.shape[2]
    delta = (out.float() * do.float()).sum(dim=-1)
    s = torch.zeros(q2.shape[0], t, tk)
    dp = torch.zeros_like(s)
    for d0 in range(0, d, width):
        sl = slice(d0, d0 + width)
        s += torch.matmul(q2[..., sl].float(), k[..., sl].float().transpose(1, 2))
        dp += torch.matmul(do[..., sl].float(), v[..., sl].float().transpose(1, 2))
    valid = attn._valid_mask(t, tk, causal, kv_len, s.device)
    valid = valid & (torch.arange(t)[:, None] < q_len)
    p = torch.where(valid, (s - lse[..., None]).exp2(), torch.zeros_like(s))
    ds = (p * (dp - delta[..., None])).to(q2.dtype).float()
    pt = p.to(do.dtype).float().transpose(1, 2)
    grads = [[], [], []]
    for c0 in range(0, d, chunk):
        cs = slice(c0, c0 + chunk)
        grads[0].append(torch.matmul(ds, k[..., cs].float()) * scale)
        grads[1].append(torch.matmul(ds.transpose(1, 2), q2[..., cs].float())
                        * math.log(2.0))
        grads[2].append(torch.matmul(pt, do[..., cs].float()))
    return tuple(torch.cat(g, dim=-1).to(x.dtype)
                 for g, x in zip(grads, (q2, k, v)))


def _box_sums(a, b, width=64, first=0):
    """a @ b^T over the last axis as the 16-bit "wide" backward forms S^T
    and dP^T: one f32 product a `width`-column box, the products added in
    f32 box by box from box `first` on, then the boxes before it (first 0:
    column order, the kernel's in every chunk)."""
    n = -(-a.shape[-1] // width)
    out = None
    for i in list(range(first, n)) + list(range(first)):
        sl = slice(i * width, (i + 1) * width)
        part = torch.matmul(a[..., sl].float(),
                            b[..., sl].float().transpose(1, 2))
        out = part if out is None else out + part
    return out


class TestColumnSplitPlainVersion:
    """The algorithm of the "wide" kernels (head_dim above 256), held on
    the CPU: S (and dP) summed over 32-column slices of d, the outputs
    formed in chunks of 256 columns from one P (and dS), equal the unsplit
    plain versions. f32 within f32 rounding of the regrouped sums over d
    (rtol 1e-5, atol 1e-5); bf16, where P and dS round to bf16 and a sum
    regrouped in f32 may tip a rounding, within BF16_REL_TOL of each
    output's largest element."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_16bit_chunks_share_p_and_ds_in_column_order(self, dtype):
        """The 16-bit "wide" backward's order: each 256-column chunk sums
        S^T and dP^T over the 64-column boxes of all of d in column order,
        so every chunk holds the same P and dS (in f32, and rounded to the
        dtype), and its columns of dq, dk and dv formed from them equal the
        unsplit plain version's (within BF16_REL_TOL of each output's
        largest element); chunk 1 summing its own boxes first would not
        hold chunk 0's f32 P and dS to the bit."""
        d, t, kv_len, q_len, chunk = 512, 128, 100, 90, 256
        q, k, v, do = (torch.from_numpy(_rand(150 + i, 2, t, d)).to(dtype)
                       for i in range(4))
        q[:, q_len:] = 0
        do[:, q_len:] = 0
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        scale = 1.0 / math.sqrt(d)
        q2 = attn.prescale(q, scale)
        out, lse = attn.flash_forward_plain(q2, k, v, True, kv_len)
        delta = (out.float() * do.float()).sum(dim=-1)
        valid = attn._valid_mask(t, t, True, kv_len, q2.device) & (
            torch.arange(t)[:, None] < q_len)

        def p_and_ds(first):
            s = _box_sums(q2, k, first=first)
            dp = _box_sums(do, v, first=first)
            p = torch.where(valid, (s - lse[..., None]).exp2(),
                            torch.zeros_like(s))
            return p, p * (dp - delta[..., None])

        per_chunk = [p_and_ds(0) for _ in range(0, d, chunk)]
        for p, ds in per_chunk[1:]:
            for x, x0 in ((p, per_chunk[0][0]), (ds, per_chunk[0][1])):
                assert torch.equal(x, x0) and torch.equal(x.to(dtype),
                                                          x0.to(dtype))
        grads = [[], [], []]
        for (p, ds), c0 in zip(per_chunk, range(0, d, chunk)):
            cs = slice(c0, c0 + chunk)
            p, ds = p.to(dtype).float(), ds.to(dtype).float()
            grads[0].append(torch.matmul(ds, k[..., cs].float()) * scale)
            grads[1].append(torch.matmul(ds.transpose(1, 2),
                                         q2[..., cs].float()) * math.log(2.0))
            grads[2].append(torch.matmul(p.transpose(1, 2),
                                         do[..., cs].float()))
        want = attn.flash_backward_plain(q2, k, v, out, do, lse, scale, True,
                                         kv_len, q_len)
        for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
            err = (torch.cat(g, dim=-1) - w.float()).abs().max().item()
            assert err <= BF16_REL_TOL * w.float().abs().max().item(), \
                (name, err)
        # Control: chunk 1 summing its own boxes (4-7) first.
        assert not torch.equal(_box_sums(q2, k, first=4), _box_sums(q2, k))
        p1, ds1 = p_and_ds(chunk // 64)
        assert not (torch.equal(p1, per_chunk[1][0])
                    and torch.equal(ds1, per_chunk[1][1]))

    @pytest.mark.parametrize("dtype,d,causal,kv_len,q_len", [
        (torch.float32, 320, True, 128, 128),
        (torch.float32, 512, False, 100, 128),
        (torch.bfloat16, 512, True, 128, 90),
        (torch.float16, 320, True, 128, 128),
    ])
    def test_split_equals_unsplit(self, dtype, d, causal, kv_len, q_len):
        q, k, v, do = (torch.from_numpy(_rand(90 + i, 2, 128, d)).to(dtype)
                       for i in range(4))
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        q[:, q_len:] = 0
        do[:, q_len:] = 0
        scale = 1.0 / math.sqrt(d)
        q2 = attn.prescale(q, scale)
        out, lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
        s_out, s_lse = _split_forward(q2, k, v, causal, kv_len)
        args = (q2, k, v, out, do, lse, scale, causal, kv_len, q_len)
        want = attn.flash_backward_plain(*args)
        got = _split_backward(*args)
        torch.testing.assert_close(s_lse, lse, rtol=1e-5, atol=1e-5)
        for a, w, name in [(s_out, out, "out")] + list(
                zip(got, want, ("dq", "dk", "dv"))):
            assert a.dtype == w.dtype == dtype and a.shape == w.shape, name
            if dtype == torch.float32:
                torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5,
                                           msg=name)
            else:
                err = (a.float() - w.float()).abs().max().item()
                assert err <= BF16_REL_TOL * w.float().abs().max().item(), \
                    (name, err)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as the f32 forward kernel rounds (cvt.rna.tf32.f32's value): an
    integer add of half a TF32 ulp to the magnitude, then a mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, terms):
    """a @ b in TF32 on the CPU: each operand split as x = hi + lo (hi =
    tf32(x), lo = tf32(x - hi)); three terms lo_a hi_b + hi_a lo_b + hi_a
    hi_b (lo_a lo_b dropped), or one, hi_a hi_b. Each product of two TF32
    values is exact in f32; the sums are f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = torch.matmul(a_hi, b_hi)
    if terms == 3:
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        out = torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo) + out
    return out


def _tf32_forward(q2, k, v, causal, kv_len, terms):
    """The f32 forward with both products in `terms`-term TF32, as the
    kernel forms them (P split as it stands, in f32)."""
    t, tk = q2.shape[1], k.shape[1]
    s = _tf32_matmul(q2, k.transpose(1, 2), terms)
    s.masked_fill_(~attn._valid_mask(t, tk, causal, kv_len, s.device),
                   attn.DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = (s - m).exp2()
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = _tf32_matmul(p, v, terms) / l_safe
    return out, (m + torch.log2(l_safe))[..., 0]


def _tf32_slices(a, b, terms, width):
    """a @ b^T over the last axis in `terms`-term TF32, one chain a
    `width`-column slice, the chains added in column order in f32 (as the
    f32 kernels add each tensor-core chain)."""
    out = None
    for d0 in range(0, a.shape[-1], width):
        sl = slice(d0, d0 + width)
        part = _tf32_matmul(a[..., sl], b[..., sl].transpose(1, 2), terms)
        out = part if out is None else out + part
    return out


def _tf32_split_forward(q2, k, v, causal, kv_len, terms, chunk=256,
                        width=64):
    """The f32 "wide" forward as its kernel forms it, chunk by chunk of
    `chunk` output columns: each chunk's S over all of d in chains of
    `width` columns (one K box) in column order, its P and lse, its
    columns of out. Returns (out, [lse of each chunk], [P of each
    chunk])."""
    t, tk, d = q2.shape[1], k.shape[1], q2.shape[2]
    outs, lses, ps = [], [], []
    for c0 in range(0, d, chunk):
        s = _tf32_slices(q2, k, terms, width)
        s.masked_fill_(~attn._valid_mask(t, tk, causal, kv_len, s.device),
                       attn.DEFAULT_MASK_VALUE)
        m = s.amax(dim=-1, keepdim=True)
        p = (s - m).exp2()
        l = p.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append(_tf32_matmul(p, v[..., c0:c0 + chunk], terms) / l_safe)
        lses.append((m + torch.log2(l_safe))[..., 0])
        ps.append(p)
    return torch.cat(outs, dim=-1), lses, ps


def _tf32_backward(q2, k, v, out, do, lse, scale, causal, kv_len, q_len,
                   terms, chunk=256, width=32, bq=64, bk=32):
    """The f32 backward as its kernel forms it at every head_dim (the
    "wide" kernel's, one chunk up to 256), every product in `terms`-term
    TF32: S^T and dP^T over all of d in chains of `width`
    columns in column order; P and dS in f32; then chunk by chunk of
    `chunk` columns dV and dK summed over q tiles of `bq` rows in order
    (one chain a tile; dK times ln2 at the end) and dQ over KV tiles of
    `bk` rows (one chain a tile; the kernel adds them by f32 reductions in
    no fixed order), times scale."""
    t, tk, d = q2.shape[1], k.shape[1], q2.shape[2]
    delta = (out.float() * do.float()).sum(dim=-1)
    s = _tf32_slices(q2, k, terms, width)
    dp = _tf32_slices(do, v, terms, width)
    valid = attn._valid_mask(t, tk, causal, kv_len, s.device)
    valid = valid & (torch.arange(t)[:, None] < q_len)
    p = torch.where(valid, (s - lse[..., None]).exp2(), torch.zeros_like(s))
    ds = p * (dp - delta[..., None])
    grads = [[], [], []]
    for c0 in range(0, d, chunk):
        cs = slice(c0, c0 + chunk)
        dv = dk = dq = 0
        for i0 in range(0, t, bq):
            qs = slice(i0, i0 + bq)
            dv = dv + _tf32_matmul(p[:, qs].transpose(1, 2), do[:, qs, cs],
                                   terms)
            dk = dk + _tf32_matmul(ds[:, qs].transpose(1, 2), q2[:, qs, cs],
                                   terms)
        for j0 in range(0, tk, bk):
            ks = slice(j0, j0 + bk)
            dq = dq + _tf32_matmul(ds[..., ks], k[:, ks, cs], terms)
        grads[0].append(dq * scale)
        grads[1].append(dk * math.log(2.0))
        grads[2].append(dv)
    return tuple(torch.cat(g, dim=-1) for g in grads)


class TestThreeTermTf32PlainVersion:
    """The f32 kernels' arithmetic (three-term TF32 on the tensor cores),
    emulated on the CPU by rounding f32 bits to TF32: the forward's output
    and lse lie within the f32 bar (1e-5 of max|ref| and of ||ref||, as
    chip_smoke.py holds the kernels) of `flash_forward_plain` in f32, at d
    128, 256 and 320 (the longest sums), causal and not, with kv_len and
    q_len inside a tile; one-term TF32 lies outside it. The "wide" pair
    (head_dim above 256) likewise, in its own chains and order: the
    forward's column split at d 512 (its chunks' lse and P agree to the
    bit), and the backward's five products (dq, dk, dv against
    `flash_backward_plain` at d 64, 128 and 256, one chunk, and 320 and
    512). The tensor cores' own
    summation order and rounding within a chain are not emulated:
    chip_smoke.py holds the kernels and the forward's product alone on
    the card."""

    F32_BAR = 1e-5

    @staticmethod
    def _within(got, ref, bar):
        err = (got - ref).abs().max().item()
        rel_l2 = ((got - ref).norm() / ref.norm()).item()
        return err <= bar * ref.abs().max().item() and rel_l2 <= bar

    @pytest.mark.parametrize("d", [128, 256, 320])
    @pytest.mark.parametrize("causal", [True, False])
    def test_three_terms_meet_the_f32_bar(self, d, causal):
        t, kv_len, q_len = 128, 100, 90
        q, k, v = (torch.from_numpy(_rand(110 + i, 2, t, d)) * 0.5
                   for i in range(3))
        q[:, q_len:] = 0
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
        q2 = attn.prescale(q, 1.0 / math.sqrt(d))
        want, want_lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
        got, got_lse = _tf32_forward(q2, k, v, causal, kv_len, terms=3)
        rows = slice(0, q_len)
        assert self._within(got[:, rows], want[:, rows], self.F32_BAR)
        lse_err = (got_lse[:, rows] - want_lse[:, rows]).abs().max().item()
        assert lse_err <= self.F32_BAR * want_lse[:, rows].abs().max().item()
        one, _ = _tf32_forward(q2, k, v, causal, kv_len, terms=1)
        assert not self._within(one[:, rows], want[:, rows], self.F32_BAR)

    @staticmethod
    def _inputs(d, t=128, kv_len=100, q_len=90, n=3, seed=110):
        xs = [torch.from_numpy(_rand(seed + i, 2, t, d)) * 0.5
              for i in range(n)]
        xs[0][:, q_len:] = 0
        for x in xs[1:3]:
            x[:, kv_len:] = 0
        if n > 3:
            xs[3][:, q_len:] = 0
        return xs

    @pytest.mark.parametrize("causal", [True, False])
    def test_column_split_forward_at_d512(self, causal):
        d, kv_len, q_len = 512, 100, 90
        q, k, v = self._inputs(d, kv_len=kv_len, q_len=q_len)
        q2 = attn.prescale(q, 1.0 / math.sqrt(d))
        want, want_lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
        got, lses, ps = _tf32_split_forward(q2, k, v, causal, kv_len, 3)
        rows = slice(0, q_len)
        assert len(lses) == 2
        assert torch.equal(lses[0], lses[1]) and torch.equal(ps[0], ps[1])
        assert self._within(got[:, rows], want[:, rows], self.F32_BAR)
        lse_err = (lses[0][:, rows] - want_lse[:, rows]).abs().max().item()
        assert lse_err <= self.F32_BAR * want_lse[:, rows].abs().max().item()
        # Control: a chunk that summed its own columns first would not agree
        # to the bit with chunk 0.
        s0 = _tf32_slices(q2, k, 3, 64)
        rolled = _tf32_slices(q2.roll(-256, dims=-1), k.roll(-256, dims=-1),
                              3, 64)
        assert not torch.equal(s0, rolled)
        one, _, _ = _tf32_split_forward(q2, k, v, causal, kv_len, 1)
        assert not self._within(one[:, rows], want[:, rows], self.F32_BAR)

    @pytest.mark.parametrize("d", [64, 128, 256, 320, 512])
    @pytest.mark.parametrize("causal", [True, False])
    def test_three_term_backward_meets_the_f32_bar(self, d, causal):
        kv_len, q_len = 100, 90
        q, k, v, do = self._inputs(d, kv_len=kv_len, q_len=q_len, n=4,
                                   seed=130)
        scale = 1.0 / math.sqrt(d)
        q2 = attn.prescale(q, scale)
        out, lse = attn.flash_forward_plain(q2, k, v, causal, kv_len)
        args = (q2, k, v, out, do, lse, scale, causal, kv_len, q_len)
        want = attn.flash_backward_plain(*args)
        got = _tf32_backward(*args, terms=3)
        rows = (q_len, kv_len, kv_len)
        for g, w, n, name in zip(got, want, rows, ("dq", "dk", "dv")):
            assert self._within(g[:, :n], w[:, :n], self.F32_BAR), name
        one = _tf32_backward(*args, terms=1)
        assert not all(self._within(g[:, :n], w[:, :n], self.F32_BAR)
                       for g, w, n in zip(one, want, rows))

    def test_rounding_is_to_nearest_ties_away(self):
        ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
        x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                          1.0 + 3 * ulp / 4, 2.0 - ulp / 4, 3.0],
                         dtype=torch.float32)
        want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, 2.0,
                             3.0], dtype=torch.float32)
        assert torch.equal(_tf32(x), want)
        assert not (_tf32(x).view(torch.int32) & 0x1FFF).any()


class TestAnyHeadDimsMatchPallas:
    """Where the "any" kernels take over on the card (f32, head_dim 256,
    96 and 16), and the "wide" ones (head_dim 320 and 512, f32 and bf16),
    the port's plain path (what a CPU tensor runs) equals the
    JAX package's `flash_attention` with its Pallas kernels in interpret
    mode, forward and gradients, at b 1 x h 2 x t 256, causal. f32 at
    `FWD_TOL`/`GRAD_TOL` (as tests/test_ops.py holds the JAX kernels);
    bf16 within BF16_REL_TOL of each output's largest element (both
    round P, dS and the outputs to bf16; their f32 sums differ in
    order only)."""

    @pytest.mark.parametrize("dtype,d", [("float32", 256), ("bfloat16", 256),
                                         ("float32", 96), ("float32", 16),
                                         ("float32", 320), ("bfloat16", 320),
                                         ("float32", 512), ("bfloat16", 512)])
    def test_forward_and_gradients(self, dtype, d):
        q, k, v, g = (_rand(70 + i, 1, 2, 256, d) for i in range(4))
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))

        def jax_loss(q, k, v):
            out = jax_attn.flash_attention(q, k, v, causal=True,
                                           force_pallas=True)
            return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

        want_out = jax_attn.flash_attention(jq, jk, jv, causal=True,
                                            force_pallas=True)
        want = jax.grad(jax_loss, argnums=(0, 1, 2))(jq, jk, jv)
        tdt = getattr(torch, dtype)

        def t(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(tdt)

        qt, kt, vt = (t(x).requires_grad_() for x in (jq, jk, jv))
        out = attn.flash_attention(qt, kt, vt, causal=True)
        got = torch.autograd.grad(out, (qt, kt, vt), t(jg))
        pairs = [(out, want_out, "out")] + list(zip(got, want,
                                                    ("dq", "dk", "dv")))
        for a, w, name in pairs:
            assert a.dtype == tdt, name
            a, w = a.detach().float().numpy(), np.asarray(w, np.float32)
            if dtype == "float32":
                tol = FWD_TOL if name == "out" else GRAD_TOL
                np.testing.assert_allclose(a, w, atol=tol, rtol=tol,
                                           err_msg=name)
            else:
                err = np.abs(a - w).max()
                assert err <= BF16_REL_TOL * np.abs(w).max(), (name, err)


class TestKernelWrappers:
    def test_cpu_tensor_takes_plain_version_without_launch(self):
        attn.reset_launch_counts()
        q = torch.zeros(1, 64, 64)
        attn.flash_forward(q, q, q, True, 64)
        assert attn.LAUNCHES == {"flash_fwd": 0, "flash_bwd_pre": 0,
                                 "flash_bwd": 0, "flash_bwd_dq": 0,
                                 "flash_fwd_any": 0, "flash_bwd_any_pre": 0,
                                 "flash_bwd_any": 0, "flash_bwd_any_dq": 0,
                                 "flash_fwd_wide": 0, "flash_bwd_wide": 0}

    def test_cpu_backward_takes_plain_version_without_launch(self):
        attn.reset_launch_counts()
        q = torch.zeros(1, 64, 64)
        lse = torch.zeros(1, 64)
        dq, dk, dv = attn.flash_backward(q, q, q, q, q, lse, 0.125, True, 64, 64)
        assert dq.dtype == q.dtype and dq.shape == q.shape
        assert all(n == 0 for n in attn.LAUNCHES.values())

    def test_meta_tensor_raises(self):
        q = torch.zeros(1, 64, 64, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            attn.flash_forward(q, q, q, True, 64)

    @pytest.mark.parametrize("launch", ["pre", "main", "dq"])
    def test_backward_launch_rejects_cpu_tensors(self, launch):
        # The backward's launches have no plain version of their own: on
        # a CPU tensor each raises before it reaches its kernel.
        attn.reset_launch_counts()
        q = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
        rows = torch.zeros(1, 64)
        acc = torch.zeros(64 * 64)
        calls = {
            "pre": lambda: attn.flash_backward_pre(q, q),
            "main": lambda: attn.flash_backward_main(
                q, q, q, q, rows, rows, acc, True, 64, 64),
            "dq": lambda: attn.flash_backward_dq(acc, q.shape, 0.125),
        }
        with pytest.raises(ValueError, match="CUDA"):
            calls[launch]()
        assert all(n == 0 for n in attn.LAUNCHES.values())
