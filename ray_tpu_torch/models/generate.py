"""Autoregressive decoding for the Llama family (PyTorch port of
`ray_tpu/models/generate.py`).

Two phases, as in the JAX package:

  * prefill - one forward over the padded prompt writes the KV cache;
  * decode  - single-token forwards against the cache, with greedy /
    temperature / top-k sampling under a fixed token budget (rows that
    hit EOS keep computing but emit 0).

Attention here is plain tensor code in f32 (einsum, a -1e30 mask over
absolute positions, softmax), as in the JAX package, whose serving path
reaches no Pallas kernel: the flash kernels are not on this path.

Layout against the JAX package: the functions take the port's `Llama`
module where JAX takes a `params` dict, and loop over `model.layers`
where JAX scans stacked layers. Where JAX donates a buffer, these
functions update the cache or pool in place and return it, so callers
keep the JAX call shape. A scalar (uniform) position is a Python int,
written as one contiguous slice; per-row positions are a `[b]` tensor.
Sampling draws from an explicit `torch.Generator`, never the global RNG.
Tokens are int64.

The KV cache layout is [layers, batch, kv_heads, max_len, head_dim];
the paged pool's is [layers, n_blocks, kv_heads, block_len, head_dim].

Compile watch: `decode_step`, `prefill`, `paged_prefill`,
`paged_decode_step` and `generate` run through programs registered
under the JAX package's names (`generate.decode_step`, ...), so a
drifting shape through any of them is a storm `doctor` names.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._private import compile_watch
from ..ops.attention import repeat_kv
from ..ops.norms import apply_rotary, rotary_embedding
from .llama import (
    Llama,
    LlamaConfig,
    LlamaLayer,
    embed_tokens,
    model_glu,
    model_norm,
    project_qkv,
)

#: Fill of masked attention logits, as in the JAX package.
MASK_VALUE = -1e30


def _device(model: Llama) -> torch.device:
    return model.embed.weight.device


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device="cuda") -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "length": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def _project(cfg: LlamaConfig, x, layer: LlamaLayer, cos, sin):
    h = model_norm(cfg, x, layer.attn_norm)
    q, k, v = project_qkv(cfg, h, layer)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def _attend_and_mlp(cfg: LlamaConfig, x, layer: LlamaLayer, q, keys, values,
                    mask):
    """The rest of a decoder block after the cache update: q [b, h, t, hd]
    against keys/values [b, kv_heads, width, hd] under `mask` [b or 1, t,
    width], in f32, then the output projection and the MLP."""
    b, t, _ = x.shape
    groups = cfg.n_heads // cfg.n_kv_heads
    kf = repeat_kv(keys, groups).float()
    vf = repeat_kv(values, groups).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    logits.mul_(1.0 / math.sqrt(cfg.head_dim))
    logits.masked_fill_(~mask[:, None], MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    attn = attn.to(cfg.dtype).transpose(1, 2).reshape(b, t, -1)
    x = x + layer.wo(attn)
    h = model_norm(cfg, x, layer.mlp_norm)
    return x + layer.w2(model_glu(cfg, layer.w1(h), layer.w3(h)))


def _layer_with_cache(
    cfg: LlamaConfig,
    x: torch.Tensor,  # [b, t, dim]
    layer: LlamaLayer,
    cos,
    sin,
    k_cache: torch.Tensor,  # [b, kv_heads, max_len, hd], updated in place
    v_cache: torch.Tensor,
    cache_pos,  # int, or [b] per-row start offset of x
    valid_len,  # int or 0-d tensor, or [b] per-row valid length incl. x
):
    b, t, _ = x.shape
    q, k, v = _project(cfg, x, layer, cos, sin)
    max_len = k_cache.shape[2]
    steps = torch.arange(t, device=x.device)
    if isinstance(cache_pos, int):
        # Uniform offset (generate's decode, whole-prompt prefill): one
        # contiguous slice. The start is clamped so the update fits, as
        # `lax.dynamic_update_slice` clamps it.
        start = min(max(cache_pos, 0), max_len - t)
        k_cache[:, :, start:start + t] = k.to(k_cache.dtype)
        v_cache[:, :, start:start + t] = v.to(v_cache.dtype)
        q_pos = (cache_pos + steps)[None, :]  # [1, t]
    else:
        # Per-row offsets (ragged `generate_stream`): a batched scatter.
        idx = cache_pos.clamp(0, max_len - t)[:, None] + steps  # [b, t]
        rows = torch.arange(b, device=x.device)[:, None]
        k_cache[rows, :, idx] = k.transpose(1, 2).to(k_cache.dtype)
        v_cache[rows, :, idx] = v.transpose(1, 2).to(v_cache.dtype)
        q_pos = cache_pos[:, None] + steps  # [b, t]
    # Causal + cache-validity mask over absolute positions.
    k_pos = torch.arange(max_len, device=x.device)
    if isinstance(valid_len, torch.Tensor) and valid_len.dim():
        valid_len = valid_len[:, None, None]
    mask = (k_pos <= q_pos[:, :, None]) & (k_pos < valid_len)
    return (_attend_and_mlp(cfg, x, layer, q, k_cache, v_cache, mask),
            k_cache, v_cache)


def _positions_arg(x, device):
    """A uniform position stays a Python int (a 0-d tensor is read once
    here); per-row positions become an int64 tensor on `device`."""
    if isinstance(x, (int, np.integer)):
        return int(x)
    x = torch.as_tensor(x, device=device)
    return int(x) if x.dim() == 0 else x.long()


def _valid_arg(x, device):
    if isinstance(x, (int, np.integer)):
        return int(x)
    return torch.as_tensor(x, device=device).long()


@torch.inference_mode()
def _forward_with_cache(model: Llama, cfg: LlamaConfig, tokens, cache,
                        cache_pos, valid_len):
    """tokens [b, t] -> (logits [b, t, vocab] f32, the cache, updated in
    place).

    `cache_pos` / `valid_len` may each (independently) be scalars (the
    whole batch at one offset, the `generate` path) or `[b]` tensors
    (per-row offsets and lengths: ragged `generate_stream` prefill and
    decode)."""
    dev = _device(model)
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, t = tokens.shape
    cache_pos = _positions_arg(cache_pos, dev)
    valid_len = _valid_arg(valid_len, dev)
    steps = torch.arange(t, device=dev)
    if isinstance(cache_pos, int):
        positions = (cache_pos + steps).expand(b, t)
    else:
        positions = cache_pos[:, None] + steps
    x = embed_tokens(cfg, model, tokens)
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling)
    for i, layer in enumerate(model.layers):
        x, _, _ = _layer_with_cache(cfg, x, layer, cos, sin, cache["k"][i],
                                    cache["v"][i], cache_pos, valid_len)
    x = model_norm(cfg, x, model.final_norm)
    return model.lm_head(x).float(), cache


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float, top_k: int) -> torch.Tensor:
    """logits [b, vocab] -> token ids [b]. Greedy takes the first
    maximum; otherwise a categorical draw (Gumbel-max, as
    `jax.random.categorical`) over logits / temperature, restricted to
    the top k with ties at the cutoff kept."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < cutoff, MASK_VALUE)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


# ---------------------------------------------------------------------
# Shared decode step: `generate`, `generate_stream` and the engine's
# contiguous-cache counterpart all run this one step - one sampling
# implementation, one cache-update implementation.
# ---------------------------------------------------------------------


def _decode_step(model, cfg, cache, last_logits, positions, alive,
                 generator, temperature: float, top_k: int):
    """Sample one token from `last_logits`, run the single-token forward
    against the cache at `positions`, and return (token [b], the cache,
    next last_logits [b, vocab])."""
    token = _sample(last_logits, generator, temperature, top_k)
    token = torch.where(torch.as_tensor(alive, device=token.device), token, 0)
    if not isinstance(positions, int):
        positions = _positions_arg(positions, token.device)
    logits, cache = _forward_with_cache(
        model, cfg, token[:, None], cache, positions, positions + 1
    )
    return token, cache, logits[:, 0]


_decode_step_prog = compile_watch.instrument("generate.decode_step",
                                             _decode_step)
_prefill_prog = compile_watch.instrument("generate.prefill",
                                         _forward_with_cache)


def decode_step(model: Llama, cfg: LlamaConfig, cache, last_logits,
                positions, alive, generator=None, *,
                temperature: float = 0.0, top_k: int = 0):
    """Single-step decode, the entry point shared by `generate_stream`:
    `positions` may be an int or per-row. The cache is updated in place
    and returned; `last_logits` is only read."""
    return _decode_step_prog(model, cfg, cache, last_logits, positions,
                             alive, generator, temperature, top_k)


def prefill(model: Llama, cfg: LlamaConfig, tokens, cache, cache_pos,
            valid_len):
    """KV-cache prefill: one forward over `tokens` writing the cache at
    `cache_pos` (in place). Returns (logits, cache)."""
    return _prefill_prog(model, cfg, tokens, cache, cache_pos, valid_len)


# ---------------------------------------------------------------------
# Paged KV: one shared block pool instead of per-row [max_len] arenas.
# A sequence's cache lives in `block_len`-sized blocks scattered across
# the pool; a per-row BLOCK TABLE maps logical block j -> physical
# block id. Attention gathers each row's blocks back into logical
# order, so the math is that of the contiguous cache above with
# max_len == n_logical_blocks * block_len (llm/kv_slots.py owns the
# allocator and refcounts; this module owns the compute).
# ---------------------------------------------------------------------


def init_block_pool(cfg: LlamaConfig, n_blocks: int, block_len: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """The shared pool: k/v of shape
    [layers, n_blocks, kv_heads, block_len, head_dim]."""
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _paged_layer(
    cfg: LlamaConfig,
    x: torch.Tensor,  # [b, t, dim]
    layer: LlamaLayer,
    cos,
    sin,
    k_pool: torch.Tensor,  # [n_blocks, kv_heads, block_len, hd], in place
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [b, n_logical_blocks] int64 physical ids
    q_pos: torch.Tensor,  # [b, t] int64 absolute positions of x's tokens
    valid_len: torch.Tensor,  # [b] valid cache length incl. x
):
    b, t, _ = x.shape
    kv_heads, hd = cfg.n_kv_heads, cfg.head_dim
    bl = k_pool.shape[2]
    nb = tables.shape[1]
    q, k, v = _project(cfg, x, layer, cos, sin)
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
    k_pos = torch.arange(nb * bl, device=x.device)
    mask = (k_pos <= q_pos[:, :, None]) & (k_pos < valid_len[:, None, None])
    return (_attend_and_mlp(cfg, x, layer, q, kf, vf, mask),
            k_pool, v_pool)


@torch.inference_mode()
def _paged_forward(model: Llama, cfg: LlamaConfig, tokens, pool, tables,
                   q_pos, valid_len):
    """tokens [b, t] at absolute positions q_pos [b, t] -> (logits [b, t,
    vocab] f32, the pool, updated in place). The paged analog of
    `_forward_with_cache`; `tables` maps each row's logical blocks to
    pool blocks and `valid_len` [b] bounds what attention may see."""
    dev = _device(model)
    tokens = torch.as_tensor(tokens, device=dev).long()
    tables = torch.as_tensor(tables, device=dev).long()
    q_pos = torch.as_tensor(q_pos, device=dev).long()
    valid_len = torch.as_tensor(valid_len, device=dev).long()
    x = embed_tokens(cfg, model, tokens)
    cos, sin = rotary_embedding(q_pos, cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling)
    for i, layer in enumerate(model.layers):
        x, _, _ = _paged_layer(cfg, x, layer, cos, sin, pool["k"][i],
                               pool["v"][i], tables, q_pos, valid_len)
    x = model_norm(cfg, x, model.final_norm)
    return model.lm_head(x).float(), pool


def _paged_prefill_impl(model, cfg, tokens, pool, table, offset, valid_len):
    dev = _device(model)
    tokens = torch.as_tensor(tokens, device=dev)
    b, t = tokens.shape
    q_pos = (_positions_arg(offset, dev) + torch.arange(t, device=dev)
             ).expand(b, t)
    if isinstance(valid_len, (int, np.integer)):
        valid = torch.full((b,), int(valid_len), device=dev)
    else:
        valid = torch.as_tensor(valid_len, device=dev).long().expand(b)
    return _paged_forward(model, cfg, tokens, pool, table, q_pos, valid)


def _paged_decode_step_impl(model, cfg, pool, tables, last_logits,
                            positions, alive, generator, temperature,
                            top_k):
    dev = _device(model)
    alive = torch.as_tensor(alive, device=dev)
    tables = torch.as_tensor(tables, device=dev)
    token = _sample(last_logits, generator, temperature, top_k)
    token = torch.where(alive, token, 0)
    # Dead rows must not scatter into REAL blocks: a slot mid-admission
    # (its table already built, its prefill still running, alive not
    # yet set) would otherwise write this step's junk k/v at its STALE
    # position into the new request's - possibly shared prefix-cache -
    # pages. Masking to the null block here makes the guarantee hold
    # whatever the host's bookkeeping order.
    tables = torch.where(alive[:, None], tables, 0)
    positions = torch.as_tensor(positions, device=dev).long()
    logits, pool = _paged_forward(
        model, cfg, token[:, None], pool, tables, positions[:, None],
        positions + 1,
    )
    return token, pool, logits[:, 0]


_paged_prefill_prog = compile_watch.instrument("generate.paged_prefill",
                                               _paged_prefill_impl)
_paged_decode_prog = compile_watch.instrument("generate.paged_decode_step",
                                              _paged_decode_step_impl)


def paged_prefill(model: Llama, cfg: LlamaConfig, tokens, pool, table,
                  offset, valid_len):
    """Chunked prefill straight into the block pool: one forward over
    `tokens` [b, chunk] at positions [offset, offset + chunk) of the
    sequences whose block tables are `table` [b, nb]. A prefix-cache hit
    simply starts at a later offset with the shared blocks already in
    the pool. The pool is updated in place; returns (logits, pool)."""
    return _paged_prefill_prog(model, cfg, tokens, pool, table, offset,
                               valid_len)


def paged_decode_step(model: Llama, cfg: LlamaConfig, pool, tables,
                      last_logits, positions, alive, generator=None, *,
                      temperature: float = 0.0, top_k: int = 0):
    """Single-step decode over the FULL slot batch against the block
    pool (the paged analog of `decode_step`): sample one token per row
    from `last_logits`, scatter its k/v into each row's current block,
    and gather-attend over the row's block table. The pool is updated in
    place; `last_logits` is only read, and the next logits are a new
    tensor. Returns (token [b], pool, next last_logits [b, vocab])."""
    return _paged_decode_prog(model, cfg, pool, tables, last_logits,
                              positions, alive, generator, temperature,
                              top_k)


# ---------------------------------------------------------------------
# whole-batch generation
# ---------------------------------------------------------------------


@torch.inference_mode()
def generate(
    model: Llama,
    prompt_tokens,  # [b, prompt_len] padded with pad_id
    prompt_lengths,  # [b] true lengths
    cfg: LlamaConfig,
    *,
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_token: int = -1,
    rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (generated [b, max_new_tokens], lengths [b]).

    Static token budget: rows that emit `eos_token` stop counting (the
    returned per-row length counts the EOS and nothing after it) but
    keep stepping and emit 0. No host sync inside the loop. `rng`
    defaults to a generator seeded with 0 on the model's device.
    """
    dev = _device(model)
    prompt_tokens = torch.as_tensor(prompt_tokens, device=dev).long()
    prompt_lengths = torch.as_tensor(prompt_lengths, device=dev).long()
    b, prompt_len = prompt_tokens.shape
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    cache = init_kv_cache(cfg, b, prompt_len + max_new_tokens, device=dev)

    # Phase 1: prefill the cache with the full (padded) prompt.
    logits, cache = _forward_with_cache(model, cfg, prompt_tokens, cache, 0,
                                        prompt_len)
    # Next-token logits come from each row's LAST VALID position.
    last = logits[torch.arange(b, device=dev), prompt_lengths - 1]

    # NOTE: rows shorter than prompt_len decode against a cache that
    # includes pad positions; masking uses valid_len = full prefix, so
    # equal-length prompts are exact and ragged batches approximate
    # (`generate_stream` is exact).
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    tokens, alive_flags = [], []
    for step in range(max_new_tokens):
        token, cache, last = _decode_step(model, cfg, cache, last,
                                          prompt_len + step, alive, rng,
                                          temperature, top_k)
        tokens.append(token)
        alive_flags.append(alive)
        alive = alive & (token != eos_token)
    lengths = torch.stack(alive_flags, dim=1).sum(dim=1)
    return torch.stack(tokens, dim=1), lengths


# Rebound through the compile watch, as the JAX package rebinds its
# `generate`: whole-batch generation is a named program.
generate = compile_watch.instrument("generate.generate", generate)


@torch.inference_mode()
def generate_stream(
    model: Llama,
    prompt_tokens,
    prompt_lengths,
    cfg: LlamaConfig,
    *,
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_token: int = -1,
    rng: Optional[torch.Generator] = None,
    cache_len: Optional[int] = None,
):
    """Incremental analog of `generate`: yields one `[b]` int64 numpy
    array per decode step, as sampled (the stream contract: one host
    copy per step). Stops early when every row has emitted `eos_token`.

    Rows decode from their TRUE lengths, so padding never enters
    attention: unlike `generate`, ragged batches are exact.

    `cache_len` sets the KV cache to an exact fixed size (extra
    positions stay masked). It must hold the padded prompt AND every
    row's true length + budget."""
    dev = _device(model)
    prompt_tokens = torch.as_tensor(prompt_tokens, device=dev).long()
    lengths_host = np.asarray(torch.as_tensor(prompt_lengths).cpu())
    prompt_lengths = torch.as_tensor(prompt_lengths, device=dev).long()
    b, prompt_len = prompt_tokens.shape
    if cache_len is not None:
        if cache_len != int(cache_len):
            raise ValueError(f"cache_len must be integral, got {cache_len!r}")
        max_len = int(cache_len)
        needed = int(np.max(lengths_host))
        if prompt_len > max_len or needed + max_new_tokens > max_len:
            raise ValueError(
                f"cache_len={max_len} cannot hold the padded prompt "
                f"({prompt_len}) and true length ({needed}) + "
                f"max_new_tokens ({max_new_tokens})"
            )
    else:
        max_len = prompt_len + max_new_tokens
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    cache = init_kv_cache(cfg, b, max_len, device=dev)

    # Per-row valid lengths and decode positions: each new token
    # overwrites the pad KV at its position before valid_len covers it.
    logits, cache = prefill(model, cfg, prompt_tokens, cache, 0,
                            prompt_lengths)
    last = logits[torch.arange(b, device=dev), prompt_lengths - 1]
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    position = prompt_lengths
    for _ in range(max_new_tokens):
        token, cache, last = decode_step(model, cfg, cache, last, position,
                                         alive, rng, temperature=temperature,
                                         top_k=top_k)
        alive = alive & (token != eos_token)
        yield token.cpu().numpy()  # rt: noqa[RT303] — the stream contract IS one host token per step; this sync is the product, not overhead
        position = position + 1
        # Once every row has emitted EOS there is no token left to
        # produce: stop without running a dead step.
        if not bool(alive.any()):  # rt: noqa[RT303] — early-stop predicate must reach the host; it saves whole dead steps, worth one scalar sync
            return
