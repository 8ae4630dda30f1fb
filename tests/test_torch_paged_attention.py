"""The paged decode attention's wrapper and plain version on the CPU
(`ray_tpu_torch.ops.paged_attention`); the kernel itself is held to the
plain version on the card in `tests/test_torch_cuda.py`.

On a CPU tensor `paged_decode_attention` must run the serving step's
attention exactly as `models/generate._paged_layer` ran it before the
kernel (the code is kept verbatim below), only a chunk of one token a
row may reach it, its launch counter stays 0, and its checks reject what
the kernel does not take. The kernel's definition (attend over the live
prefix only, the appended position read as written) agrees with the
plain version's full-width masked attention."""

import math

import pytest
import torch

from ray_tpu_torch.models import generate as gen
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops.attention import repeat_kv

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)


def _before_the_kernel(q, k, v, k_pool, v_pool, tables, q_pos, valid_len,
                       dtype):
    """`_paged_layer`'s scatter, gather and `_attend_and_mlp`'s f32
    attention as they read before the kernel, up to the output
    projection."""
    b, heads, t, hd = q.shape
    kv_heads = k.shape[1]
    bl = k_pool.shape[2]
    nb = tables.shape[1]
    logical = torch.div(q_pos, bl, rounding_mode="floor").clamp_(max=nb - 1)
    phys = torch.gather(tables, 1, logical).reshape(-1)
    off = (q_pos % bl).reshape(-1)
    k_pool[phys, :, off] = k.transpose(1, 2).reshape(b * t, kv_heads, hd).to(
        k_pool.dtype)
    v_pool[phys, :, off] = v.transpose(1, 2).reshape(b * t, kv_heads, hd).to(
        v_pool.dtype)
    kf = k_pool[tables].transpose(1, 2).reshape(b, kv_heads, nb * bl, hd)
    vf = v_pool[tables].transpose(1, 2).reshape(b, kv_heads, nb * bl, hd)
    k_pos = torch.arange(nb * bl, device=q.device)
    mask = (k_pos <= q_pos[:, :, None]) & (k_pos < valid_len[:, None, None])
    groups = heads // kv_heads
    kf = repeat_kv(kf, groups).float()
    vf = repeat_kv(vf, groups).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    logits.mul_(1.0 / math.sqrt(hd))
    logits.masked_fill_(~mask[:, None], gen.MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return attn.to(dtype).transpose(1, 2).reshape(b, t, -1)


def _step(dtype, group, positions, kv_heads=2, d=16, bl=4, nb=6, seed=0):
    """A decode step's inputs on scrambled tables, the last row dead
    (its table masked to the null block 0)."""
    g = torch.Generator().manual_seed(seed)
    rows = len(positions)
    tables = (torch.randperm(rows * nb, generator=g) + 1).view(rows, nb)
    tables[-1] = 0
    positions = torch.tensor(positions)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    pool = (rows * nb + 1, kv_heads, bl, d)
    return (randn(rows, kv_heads * group, 1, d), randn(rows, kv_heads, 1, d),
            randn(rows, 1, kv_heads, d).transpose(1, 2), randn(*pool),
            randn(*pool), tables, positions[:, None], positions + 1)


def _copy(args):
    return tuple(x.clone() if i in (3, 4) else x for i, x in enumerate(args))


@pytest.mark.parametrize("positions", [
    [0, 3, 4, 5, 23, 7],     # block edges, the table's last position
    [24, 40, 9, 2],          # stale positions past the table (clamped)
])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_is_the_code_it_replaced(dtype, group, positions):
    """Bit for bit: the result, and both pools after the append."""
    args = _step(dtype, group, positions)
    want_args = _copy(args)
    got = pa.paged_decode_attention(*args)
    want = _before_the_kernel(*want_args, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(args[3], want_args[3])
    assert torch.equal(args[4], want_args[4])


def test_plain_prefill_chunk_is_the_code_it_replaced():
    """A chunk of several tokens a row, through the plain version."""
    g = torch.Generator().manual_seed(1)
    q, k = torch.randn(2, 4, 5, 16, generator=g), torch.randn(
        2, 2, 5, 16, generator=g)
    v = torch.randn(2, 2, 5, 16, generator=g)
    pools = [torch.randn(13, 2, 4, 16, generator=g) for _ in range(2)]
    tables = (torch.randperm(12, generator=g) + 1).view(2, 6)
    q_pos = (3 + torch.arange(5)).expand(2, 5)
    valid = torch.tensor([8, 8])
    args = (q, k, v, *pools, tables, q_pos, valid)
    want_args = _copy(args)
    got = pa.paged_attention_plain(*args)
    assert torch.equal(got, _before_the_kernel(*want_args, torch.float32))
    assert torch.equal(args[3], want_args[3])


def _tiny():
    cfg = llama.LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                            n_kv_heads=2, intermediate=64, max_seq_len=64,
                            dtype=torch.float32, attention="reference",
                            remat=False)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")


def test_only_a_one_token_chunk_reaches_the_wrapper(monkeypatch):
    """Prefill chunks of 8 never call `paged_decode_attention` (it raises
    here); each decode step calls it once a layer; the CPU launches no
    kernel."""
    cfg, model = _tiny()
    plain = pa.paged_decode_attention
    calls = []

    def refuse(*args):
        raise AssertionError("a prefill chunk reached the decode kernel")

    def count(*args):
        calls.append(args[0].shape)
        return plain(*args)

    tables = torch.arange(1, 9).view(2, 4)
    tokens = torch.randint(1, 64, (2, 16), generator=torch.Generator()
                           .manual_seed(2))
    pool = gen.init_block_pool(cfg, 9, 8, device="cpu")
    monkeypatch.setattr(pa, "paged_decode_attention", refuse)
    for off in (0, 8):
        logits, pool = gen.paged_prefill(model, cfg, tokens[:, off:off + 8],
                                         pool, tables, off, off + 8)
    monkeypatch.setattr(pa, "paged_decode_attention", count)
    pa.reset_launch_counts()
    last = logits[:, -1]
    for step in range(3):
        _, pool, last = gen.paged_decode_step(
            model, cfg, pool, tables, last, torch.tensor([16, 16]) + step,
            torch.tensor([True, True]))
    assert calls == [torch.Size([2, 4, 1, 8])] * (3 * cfg.n_layers)
    assert pa.LAUNCHES == {"paged_decode": 0}


def _live_prefix_reference(q, k, v, k_pool, v_pool, tables, q_pos,
                           valid_len):
    """The kernel's definition in f64, a row at a time: the append lands
    at the logical block clamped to the table, and attention reads the
    first min(p + 1, valid_len, table width) positions only, through the
    table."""
    b, heads, _, d = q.shape
    kv_heads, bl = k_pool.shape[1], k_pool.shape[2]
    nb = tables.shape[1]
    out = torch.zeros(b, heads, d, dtype=torch.float64)
    for row in range(b):
        p = int(q_pos[row, 0])
        blk = min(p // bl, nb - 1)
        k_pool[tables[row, blk], :, p % bl] = k[row, :, 0]
        v_pool[tables[row, blk], :, p % bl] = v[row, :, 0]
        n = min(p + 1, int(valid_len[row]), nb * bl)
        pos = torch.arange(n)
        ks = k_pool[tables[row, pos // bl], :, pos % bl].double()  # [n, kvh, d]
        vs = v_pool[tables[row, pos // bl], :, pos % bl].double()
        for h in range(heads):
            g = h // (heads // kv_heads)
            w = torch.softmax(ks[:, g] @ q[row, h, 0].double() / math.sqrt(d),
                              dim=0)
            out[row, h] = w @ vs[:, g]
    return out.reshape(b, 1, heads * d)


@pytest.mark.parametrize("positions", [[0, 3, 4, 5, 23, 7],
                                       [24, 40, 9, 2]])
def test_live_prefix_equals_full_width_attention(positions):
    """The plain version's full-width masked attention in f32 equals
    attention over each live row's prefix through its table in f64."""
    args = _step(torch.float32, 4, positions)
    ref_args = _copy(args)
    got = pa.paged_decode_attention(*args)
    want = _live_prefix_reference(*ref_args)
    live = slice(0, len(positions) - 1)  # the dead row reads junk
    torch.testing.assert_close(got[live].double(), want[live], rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(args[3], ref_args[3])


def _decode_args(**change):
    args = dict(zip(("q", "k", "v", "k_pool", "v_pool", "tables", "q_pos",
                     "valid_len"), _step(torch.bfloat16, 4, [5, 9, 2],
                                         d=64)))
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    ({"q": torch.zeros(3, 8, 1, 96, dtype=torch.bfloat16),
      "k": torch.zeros(3, 2, 1, 96, dtype=torch.bfloat16),
      "v": torch.zeros(3, 2, 1, 96, dtype=torch.bfloat16)}, "head_dim"),
    ({"q": torch.zeros(3, 8, 2, 64, dtype=torch.bfloat16)}, r"\[b, heads, 1"),
    ({"q": torch.zeros(3, 8, 1, 64, dtype=torch.float64)}, "dtype"),
    ({"k": torch.zeros(3, 2, 1, 64)}, "float32"),
    ({"q": torch.zeros(3, 8, 1, 128, dtype=torch.bfloat16)[..., ::2]},
     "16-byte"),
    ({"k_pool": torch.zeros(19, 2, 8, 64, dtype=torch.bfloat16)[:, :, ::2],
      "v_pool": torch.zeros(19, 2, 8, 64, dtype=torch.bfloat16)[:, :, ::2]},
     "contiguous"),
    ({"tables": torch.zeros(3, 6, dtype=torch.int32)}, "int64"),
    ({"q": torch.zeros(3, 7, 1, 64, dtype=torch.bfloat16)}, "do not match"),
])
def test_checks_reject_what_the_kernel_does_not_take(change, match):
    """The CUDA path's checks, run on CPU tensors."""
    with pytest.raises(ValueError, match=match):
        pa._check(**_decode_args(**change))


def test_checks_take_the_decode_step_layout():
    """v as the projection leaves it (a transposed view), q_pos a column
    of the positions, an expanded valid length: accepted."""
    args = _decode_args()
    args["valid_len"] = torch.tensor([9]).expand(3)
    pa._check(**args)
