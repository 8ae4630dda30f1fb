"""Attention over a paged KV pool, for the serving model step
(`models/generate._paged_layer`).

Two versions of one function. `paged_attention_plain` is the JAX
package's paged path in PyTorch (`ray_tpu/models/generate.py`): scatter
the chunk's k/v into each row's blocks, gather each row's whole table
back into logical order, repeat K/V to every query head and attend in
f32 under a full-width mask. `paged_decode_attention` takes a chunk of
one query token a row (the decode step): on a CUDA tensor it launches
the paged decode kernel (`csrc/paged_decode.cu`), which appends the step's
k/v and reads only each row's live blocks through its table, in the
pool's dtype, with the group's query heads sharing each K/V element; on
a CPU tensor it runs the plain version. A CUDA tensor the kernel does
not take raises; nothing falls back.

`attention_f32` is the f32 attention both the plain paged path and the
contiguous cache (`generate._layer_with_cache`) run.

Layouts: q [b, heads, t, head_dim], k/v [b, kv_heads, t, head_dim]; the
pool's k/v [n_blocks, kv_heads, block_len, head_dim]; tables [b, nb]
int64 physical block ids, q_pos [b, t] int64 absolute positions,
valid_len [b] int64. The result is [b, t, heads * head_dim], ready for
the output projection.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .attention import repeat_kv

#: Fill of masked attention logits, as in the JAX package.
MASK_VALUE = -1e30

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (64, 128, 256)
#: Pool dtype -> its code in the names of the libraries built from
#: `csrc/paged_decode.cu`, one a (dtype, head_dim).
_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16",
           torch.float32: "f32"}

#: Kernel launches since the last reset: one a decode step's layer on
#: the card, none on the CPU.
LAUNCHES = {"paged_decode": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = ([_P, _L, _L] * 3 + [_P, _P, _L, _I, _I, _P, _L, _I, _P, _L, _P,
                                 _L, _P, _I, _I, _I, ctypes.c_float, _P])


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_f32(q, keys, values, mask, dtype):
    """q [b, h, t, hd] against keys/values [b, kv_heads, width, hd] under
    `mask` [b or 1, t, width], in f32: (the result in `dtype`, [b, t, h *
    hd])."""
    b, heads, t, hd = q.shape
    groups = heads // keys.shape[1]
    kf = repeat_kv(keys, groups).float()
    vf = repeat_kv(values, groups).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    logits.mul_(1.0 / math.sqrt(hd))
    logits.masked_fill_(~mask[:, None], MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return attn.to(dtype).transpose(1, 2).reshape(b, t, -1)


def paged_attention_plain(q, k, v, k_pool, v_pool, tables, q_pos, valid_len):
    """Scatter k/v into the pools (in place), then attend q over each
    row's gathered table: [b, t, heads * head_dim] in q's dtype."""
    b, _, t, hd = q.shape
    kv_heads = k.shape[1]
    bl = k_pool.shape[2]
    nb = tables.shape[1]
    # Scatter this step's k/v: position p of row i lands in physical
    # block tables[i, p // bl] at offset p % bl. Rows never share a
    # writable block; dead rows all point at the null block 0, whose
    # junk no live row reads unmasked, so duplicate indices (whose
    # winner is unspecified) fall only there. The logical block is
    # clamped to the table: a retired slot's stale position may sit at
    # max_len, and an index past the table must never reach the device.
    logical = torch.div(q_pos, bl, rounding_mode="floor").clamp_(max=nb - 1)
    phys = torch.gather(tables, 1, logical).reshape(-1)
    off = (q_pos % bl).reshape(-1)
    k_pool[phys, :, off] = k.transpose(1, 2).reshape(b * t, kv_heads, hd).to(
        k_pool.dtype)
    v_pool[phys, :, off] = v.transpose(1, 2).reshape(b * t, kv_heads, hd).to(
        v_pool.dtype)
    # Gather each row's cache back into logical order: [b, nb, kvH, bl,
    # hd] -> [b, kvH, nb*bl, hd]. Gather AFTER the scatter so the chunk
    # attends to its own tokens (prefill self-attention).
    kf = k_pool[tables].transpose(1, 2).reshape(b, kv_heads, nb * bl, hd)
    vf = v_pool[tables].transpose(1, 2).reshape(b, kv_heads, nb * bl, hd)
    k_pos = torch.arange(nb * bl, device=q.device)
    mask = (k_pos <= q_pos[:, :, None]) & (k_pos < valid_len[:, None, None])
    return attention_f32(q, kf, vf, mask, q.dtype)


def _check(q, k, v, k_pool, v_pool, tables, q_pos, valid_len) -> None:
    """Raises ValueError on what the kernel does not take."""
    dev, dtype = q.device, q.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"paged_decode: dtype {dtype} not supported "
                         f"(kernel takes {list(_DTYPES)})")
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} is not "
                         "[b, heads, 1, head_dim]")
    b, heads, _, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {hd} not in {HEAD_DIMS}")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_decode: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} are not [n_blocks, "
                         "kv_heads, block_len, head_dim]")
    kv_heads = k_pool.shape[1]
    if (k.shape != (b, kv_heads, 1, hd) or v.shape != k.shape
            or k_pool.shape[3] != hd or heads % kv_heads):
        raise ValueError(f"paged_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} and pool "
                         f"{tuple(k_pool.shape)} do not match")
    for name, x in (("q", q), ("k", k), ("v", v), ("k_pool", k_pool),
                    ("v_pool", v_pool)):
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"paged_decode: {name} is {x.dtype} on "
                             f"{x.device}, q {dtype} on {dev}")
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
                s * x.element_size() % 16 for s in x.stride()[:2]):
            raise ValueError(f"paged_decode: {name} rows must be contiguous "
                             "and 16-byte aligned")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not x.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous")
    nb = tables.shape[-1]
    for name, x, shape in (("tables", tables, (b, nb)),
                           ("q_pos", q_pos, (b, 1)),
                           ("valid_len", valid_len, (b,))):
        if x.device != dev or x.dtype != torch.int64 or x.shape != shape:
            raise ValueError(f"paged_decode: {name} must be int64 {shape} "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if nb < 1 or tables.stride(1) != 1:
        raise ValueError("paged_decode: tables must have contiguous rows")


_kernels = {}


def _kernel(dtype, head_dim):
    fn = _kernels.get((dtype, head_dim))
    if fn is None:
        name = f"paged_decode_{_DTYPES[dtype]}_d{head_dim}"
        fn = _build.load(name).rtt_paged_decode
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _kernels[dtype, head_dim] = fn
    return fn


def paged_decode_attention(q, k, v, k_pool, v_pool, tables, q_pos,
                           valid_len):
    """One decode step's attention (t == 1): append k/v at each row's
    position (the logical block clamped to the table) and attend q over
    the row's first min(q_pos + 1, valid_len, table width * block_len)
    positions. Returns [b, 1, heads * head_dim] in q's dtype.

    CPU tensors run `paged_attention_plain`. CUDA tensors launch the
    kernel, which takes q, k, v and the pools in one dtype (bf16, f16 or
    f32), head_dim 64, 128 or 256, heads a multiple of kv_heads, rows of
    q/k/v contiguous and 16-byte aligned, contiguous pools and int64
    indices; anything else raises ValueError. Both read block 0 like any
    other block; dead rows, whose tables the decode step masks to that
    null block, get junk from either."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k, v, k_pool, v_pool, tables, q_pos,
                                     valid_len)
    _check(q, k, v, k_pool, v_pool, tables, q_pos, valid_len)
    b, heads, _, hd = q.shape
    n_blocks, kv_heads, bl, _ = k_pool.shape
    out = torch.empty(b, 1, heads * hd, dtype=q.dtype, device=q.device)
    fn = _kernel(q.dtype, hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), q.stride(0), q.stride(1),
                 k.data_ptr(), k.stride(0), k.stride(1),
                 v.data_ptr(), v.stride(0), v.stride(1),
                 k_pool.data_ptr(), v_pool.data_ptr(), n_blocks, kv_heads, bl,
                 tables.data_ptr(), tables.stride(0), tables.shape[1],
                 q_pos.data_ptr(), q_pos.stride(0),
                 valid_len.data_ptr(), valid_len.stride(0),
                 out.data_ptr(), b, heads, hd, 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["paged_decode"] += 1
    return out
