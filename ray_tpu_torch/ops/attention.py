"""Attention ops (PyTorch port of `ray_tpu/ops/attention.py`): the
reference MHA, and flash attention carried by CUDA kernels written for
Hopper (`csrc/flash_fwd.cu`; `csrc/flash_bwd.cu`, whose op is three
launches).

Each kernel has a plain PyTorch version here that computes the same
function the same way: log2-domain logits (q pre-scaled by
scale*log2(e)), top-left causal mask `row >= col`, KV columns
`>= kv_len` and q rows `>= q_len` masked, `dk` finished by ln2 and
`dq` by `scale`. A wrapper takes the plain version only for tensors
on the CPU; for a CUDA tensor it launches the kernel or raises.

Layout: [batch, heads, seq, head_dim] at the public function,
[batch*heads, seq, head_dim] at the kernels. GQA is handled above
this op by repeating KV heads.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: The kernels take sequence lengths that are multiples of BLOCK (their
#: 128-row tiles handle a partial last tile of 64 rows themselves); the
#: public wrapper pads both sequence axes to a multiple of it.
BLOCK = 64

#: Head dims the kernels are instantiated for.
HEAD_DIMS = (64, 128)

_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)

#: Kernel launches since the last reset, by kernel. Each wrapper adds
#: one where it launches its kernel and nowhere else. The backward op
#: is three launches: `flash_bwd_pre` (delta, and dq's f32 accumulator
#: zeroed), `flash_bwd` (the fused kernel) and `flash_bwd_dq` (dq
#: scaled and cast from the accumulator).
LAUNCHES = {"flash_fwd": 0, "flash_bwd_pre": 0, "flash_bwd": 0,
            "flash_bwd_dq": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Readable O(T^2)-memory attention; the numerical ground truth.
    Its causal mask is aligned bottom-right (`tril(k=t_k - t_q)`),
    unlike the kernels' top-left mask: the two agree when t_q == t_k."""
    t_q, d = q.shape[-2:]
    t_k = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril(
            diagonal=t_k - t_q
        )
        logits = logits.masked_fill(~mask, DEFAULT_MASK_VALUE)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v).to(q.dtype)


def repeat_kv(k: torch.Tensor, num_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention: [b, kvh, t, d] ->
    [b, kvh*num_rep, t, d]."""
    if num_rep == 1:
        return k
    return torch.repeat_interleave(k, num_rep, dim=1)


def prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale * log2(e) as an f32 multiply and a cast: the logits the
    kernels compute are then already in the log2 domain. A bf16 x bf16
    multiply would perturb the softmax temperature itself."""
    return (q.float() * (scale * _LOG2E)).to(q.dtype)


def _valid_mask(t, tk, causal, kv_len, device):
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    valid = cols < kv_len
    if causal:
        valid = valid & (rows >= cols)
    return valid


# ---------------------------------------------------------------------------
# plain versions of the two kernels
# ---------------------------------------------------------------------------

def flash_forward_plain(q2, k, v, causal: bool, kv_len: int):
    """Plain version of the forward kernel: (out [bh, t, d] in q's dtype,
    lse [bh, t] f32 in the log2 domain). q2 is pre-scaled (`prescale`)."""
    t, tk = q2.shape[1], k.shape[1]
    s = torch.matmul(q2.float(), k.float().transpose(1, 2))
    s.masked_fill_(~_valid_mask(t, tk, causal, kv_len, s.device),
                   DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp2_()
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    # p is rounded to v's dtype before the product, as in the kernel.
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = (m + torch.log2(l_safe))[..., 0]
    return out.to(q2.dtype), lse


def flash_backward_plain(q2, k, v, out, do, lse, scale: float,
                         causal: bool, kv_len: int, q_len: int):
    """Plain version of the backward op (its three kernels): (dq in q's
    dtype, dk, dv). lse is the forward's log2-domain [bh, t]; delta =
    rowsum(out * do) in f32, as `_flash_backward_fused` computes it."""
    t, tk = q2.shape[1], k.shape[1]
    delta = (out.float() * do.float()).sum(dim=-1)
    s = torch.matmul(q2.float(), k.float().transpose(1, 2))
    s.masked_fill_(~_valid_mask(t, tk, causal, kv_len, s.device),
                   DEFAULT_MASK_VALUE)
    p = s.sub_(lse[..., None]).exp2_()
    rows = torch.arange(t, device=p.device) < q_len
    p.masked_fill_(~rows[None, :, None], 0.0)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = (p * (dp - delta[..., None])).to(q2.dtype).float()
    dk = torch.matmul(ds.transpose(1, 2), q2.float()) * _LN2
    dq = torch.matmul(ds, k.float()) * scale
    return dq.to(q2.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
#: Counter name -> (library, C symbol, argument types).
_SIGNATURES = {
    "flash_fwd": ("flash_fwd", "rtt_flash_fwd_bf16", [_P] * 5 + [_I] * 6 + [_P]),
    "flash_bwd_pre": (
        "flash_bwd", "rtt_flash_bwd_pre_bf16", [_P] * 4 + [_I] * 2 + [_P]),
    "flash_bwd": ("flash_bwd", "rtt_flash_bwd_bf16", [_P] * 9 + [_I] * 7 + [_P]),
    "flash_bwd_dq": (
        "flash_bwd", "rtt_flash_bwd_dq_bf16",
        [_P] * 2 + [_I] * 3 + [ctypes.c_float, _P]),
}


def _kernel(name: str):
    library, symbol, argtypes = _SIGNATURES[name]
    fn = getattr(_build.load(library), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, device, dtype, *tensors) -> None:
    for x in tensors:
        if device.type != "cuda" or x.device != device:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: dtype {x.dtype} not supported "
                             f"(kernel takes {dtype})")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")


def _check_shapes(name, q, k, v):
    bh, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} / k {tuple(k.shape)}"
                         f" / v {tuple(v.shape)} mismatch")
    if t % BLOCK or k.shape[1] % BLOCK:
        raise ValueError(f"{name}: sequence lengths must be multiples of "
                         f"{BLOCK}, got {t} and {k.shape[1]}")


def _launch(name: str, fn, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def flash_forward(q2, k, v, causal: bool, kv_len: int):
    """Forward kernel (replaces `ray_tpu/ops/attention.py::_flash_forward`):
    q2 [bh, t, d] pre-scaled, k/v [bh, tk, d], t and tk multiples of
    BLOCK. Returns (out [bh, t, d] in q's dtype, lse [bh, t] f32)."""
    if q2.device.type == "cpu":
        return flash_forward_plain(q2, k, v, causal, kv_len)
    _check_cuda("flash_fwd", q2.device, torch.bfloat16, q2, k, v)
    _check_shapes("flash_fwd", q2, k, v)
    bh, t, d = q2.shape
    out = torch.empty_like(q2)
    lse = torch.empty(bh, t, dtype=torch.float32, device=q2.device)
    _launch(
        "flash_fwd", _kernel("flash_fwd"), q2.device,
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, t, k.shape[1], d, kv_len, int(causal),
    )
    return out, lse


def _check_backward(name, q2, k, v, do, lse):
    _check_cuda(name, q2.device, torch.bfloat16, q2, k, v, do)
    _check_cuda(name, q2.device, torch.float32, lse)
    _check_shapes(name, q2, k, v)
    if do.shape != q2.shape or lse.shape != q2.shape[:2]:
        raise ValueError(f"{name}: do/lse shapes do not match q")


def flash_backward_pre(out, do):
    """First launch of the backward op: (delta [bh, t] f32 = rowsum(out *
    do), dq's f32 accumulator, zeroed). CUDA tensors only; anything else
    raises ValueError."""
    _check_cuda("flash_bwd_pre", out.device, torch.bfloat16, out, do)
    if out.dim() != 3 or do.shape != out.shape or out.shape[2] not in HEAD_DIMS:
        raise ValueError(f"flash_bwd_pre: out {tuple(out.shape)} and do "
                         f"{tuple(do.shape)} must be one [bh, t, d], d in "
                         f"{HEAD_DIMS}")
    bh, t, d = out.shape
    delta = torch.empty(bh, t, dtype=torch.float32, device=out.device)
    dq_acc = torch.empty(bh * t * d, dtype=torch.float32, device=out.device)
    _launch("flash_bwd_pre", _kernel("flash_bwd_pre"), out.device,
            out.data_ptr(), do.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            bh * t, d)
    return delta, dq_acc


def flash_backward_main(q2, k, v, do, lse, delta, dq_acc, causal: bool,
                        kv_len: int, q_len: int):
    """The fused backward kernel: (dk, dv), and dS k added into dq_acc
    (unscaled, in the kernel's own order). CUDA tensors only; anything
    else raises ValueError."""
    _check_backward("flash_bwd", q2, k, v, do, lse)
    _check_cuda("flash_bwd", q2.device, torch.float32, delta, dq_acc)
    if delta.shape != lse.shape or dq_acc.numel() != q2.numel():
        raise ValueError("flash_bwd: delta/dq_acc sizes do not match q")
    bh, t, d = q2.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd", _kernel("flash_bwd"), q2.device,
            q2.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, t, k.shape[1], d, kv_len, q_len, int(causal))
    return dk, dv


def flash_backward_dq(dq_acc, shape, scale: float):
    """Last launch of the backward op: dq [bh, t, d] bf16 = dq_acc *
    scale, in dq's row-major order. CUDA tensors only; anything else
    raises ValueError."""
    _check_cuda("flash_bwd_dq", dq_acc.device, torch.float32, dq_acc)
    bh, t, d = shape
    if d not in HEAD_DIMS or t % BLOCK or dq_acc.numel() != bh * t * d:
        raise ValueError(f"flash_bwd_dq: dq {tuple(shape)} does not fit an "
                         f"accumulator of {dq_acc.numel()} elements")
    dq = torch.empty(bh, t, d, dtype=torch.bfloat16, device=dq_acc.device)
    _launch("flash_bwd_dq", _kernel("flash_bwd_dq"), dq_acc.device,
            dq_acc.data_ptr(), dq.data_ptr(), bh, t, d, float(scale))
    return dq


def flash_backward(q2, k, v, out, do, lse, scale: float, causal: bool,
                   kv_len: int, q_len: int):
    """Backward op (replaces `ray_tpu/ops/attention.py::_flash_backward_fused`):
    (dq in q's dtype, dk, dv) from the forward's q2, k, v, out and lse
    and the upstream gradient `do`. Three launches: delta and a zeroed
    f32 dq accumulator, the fused kernel, and dq's scale and cast."""
    if q2.device.type == "cpu":
        return flash_backward_plain(
            q2, k, v, out, do, lse, scale, causal, kv_len, q_len
        )
    # Every input is checked before the first of the three launches.
    _check_backward("flash_bwd", q2, k, v, do, lse)
    _check_cuda("flash_bwd", q2.device, torch.bfloat16, out)
    if out.shape != q2.shape:
        raise ValueError("flash_bwd: out shape does not match q")
    delta, dq_acc = flash_backward_pre(out, do)
    dk, dv = flash_backward_main(q2, k, v, do, lse, delta, dq_acc, causal,
                                 kv_len, q_len)
    return flash_backward_dq(dq_acc, q2.shape, scale), dk, dv


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

class FlashAttentionFunction(torch.autograd.Function):
    """Counterpart of `_flash_attention_bhsd`'s custom VJP on
    [bh, t, d] inputs padded to BLOCK multiples. The backward runs the
    backward op from the saved (q2, k, v, out, lse), q2 being the
    pre-scaled q the forward kernel took; it never reruns the forward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_len, q_len):
        q2 = prescale(q, scale)
        out, lse = flash_forward(q2, k, v, causal, kv_len)
        ctx.save_for_backward(q2, k, v, out, lse)
        ctx.args = (scale, causal, kv_len, q_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q2, k, v, out, lse = ctx.saved_tensors
        scale, causal, kv_len, q_len = ctx.args
        dq, dk, dv = flash_backward(
            q2, k, v, out, do.contiguous(), lse, scale, causal, kv_len, q_len,
        )
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention on [batch, heads, seq, head_dim]; the kernels on
    a CUDA tensor, their plain versions on a CPU tensor. The causal
    mask is aligned top-left (`row >= col`), as in the JAX kernels."""
    b, h, t, d = q.shape
    tk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.reshape(b * h, t, d)
    kf = k.reshape(b * h, tk, d)
    vf = v.reshape(b * h, tk, d)
    # Pad both sequences with zeros to the kernels' tile: the kernels
    # mask KV columns >= tk and q rows >= t, and the q padding is
    # sliced off the output.
    t_pad = -t % BLOCK
    tk_pad = -tk % BLOCK
    if t_pad:
        qf = F.pad(qf, (0, 0, 0, t_pad))
    if tk_pad:
        kf = F.pad(kf, (0, 0, 0, tk_pad))
        vf = F.pad(vf, (0, 0, 0, tk_pad))
    out = FlashAttentionFunction.apply(
        qf.contiguous(), kf.contiguous(), vf.contiguous(), scale, causal,
        tk, t,
    )
    return out[:, :t, :].reshape(b, h, t, d)
