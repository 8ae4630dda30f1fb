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


class TestKernelWrappers:
    def test_cpu_tensor_takes_plain_version_without_launch(self):
        attn.reset_launch_counts()
        q = torch.zeros(1, 64, 64)
        attn.flash_forward(q, q, q, True, 64)
        assert attn.LAUNCHES == {"flash_fwd": 0, "flash_bwd_pre": 0,
                                 "flash_bwd": 0, "flash_bwd_dq": 0}

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
