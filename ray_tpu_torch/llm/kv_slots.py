# Copied from ray_tpu/llm/kv_slots.py: the port imports nothing of ray_tpu.
# bucket_for, default_block_len, BlockAllocator and the prefix keys are
# unchanged; PagedKVCache builds its pool with the port's init_block_pool
# on the model's device.
"""Paged KV cache for the continuous-batching engine.

Fixed slot arenas shaped [layers, slots, kv_heads, max_len, head_dim]
would make every request — a 6-token chat turn included — reserve
`max_len` positions of KV for its whole lifetime, coupling slot count
(the decode batch width) to worst-case sequence memory. This module
is a PAGED cache instead:

* one shared pool of `block_len`-sized KV blocks,

      k, v: [layers, n_blocks, kv_heads, block_len, head_dim]

  (models/generate.init_block_pool);
* a per-request PAGE TABLE mapping logical block j -> physical block
  id; attention gathers blocks back into logical order per step
  (models/generate._paged_layer), so the math — and the greedy token
  stream — is identical to the contiguous cache;
* a refcounted `BlockAllocator` (the plasma-style ownership model of
  the reference object plane: pin/refcount, free-list reuse, nothing
  zeroed) with PREFIX CACHING: full prompt blocks register under the
  exact token prefix they hold, and a later request whose prompt
  starts with the same tokens shares those blocks — its prefill
  SKIPS them entirely (shared system prompts become nearly free).

Shapes stay STATIC: the decode step runs over the full slot batch
with full-width [slots, max_blocks] tables (dead rows ride along
pointing at the reserved null block 0), prompts pad to prefill-chunk
buckets, and chunks are fixed-size.

Junk-is-masked contract (unchanged from the arenas): a freed block is
NOT zeroed. Attention masks positions >= valid_len, and every visible
position is rewritten by its owning request before valid_len covers
it — so alloc/free is pure host bookkeeping, O(1) per block.

Immutability contract for shared blocks: only FULL blocks of prompt
tokens register in the prefix table, decode writes always land at
positions >= len(prompt) (never inside a full prompt block), and a
registered block is only ever written again after eviction
unregisters it — so a cache hit can never observe a block mid-rewrite.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Hashable, List, Sequence

from ..models.llama import LlamaConfig
from ..models.generate import init_block_pool


def bucket_for(n: int, chunk: int, max_len: int) -> int:
    """Smallest multiple of `chunk` holding `n` tokens (whole-chunk
    prefill: the last chunk pads rather than shrinking, keeping the
    chunk shape static). Raises when it exceeds the per-request
    capacity."""
    if n < 1:
        raise ValueError("empty prompt")
    bucket = ((n + chunk - 1) // chunk) * chunk
    if bucket > max_len:
        raise ValueError(
            f"prompt of {n} tokens needs a {bucket}-token bucket but "
            f"requests are capped at max_len={max_len}"
        )
    return bucket


def default_block_len(prefill_chunk: int, cap: int = 16) -> int:
    """Auto block length: the largest divisor of the prefill chunk at
    most `cap` — chunks must cover whole blocks so a chunked prefill
    never splits a block write across dispatches."""
    for cand in range(min(cap, prefill_chunk), 0, -1):
        if prefill_chunk % cand == 0:
            return cand
    return 1


class BlocksExhausted(RuntimeError):
    """The pool has fewer free (or evictable cached) blocks than the
    reservation needs."""


#: The reserved scratch block every dead slot's table points at; its
#: contents are garbage by design and never gathered for a live row.
NULL_BLOCK = 0


class BlockAllocator:
    """Refcounted physical-block bookkeeping plus the prefix-reuse
    table. Pure host-side Python — no JAX — so its invariants are
    unit-testable in microseconds (tests/test_kv_blocks.py).

    Block states:

    * free        — on the free list, contents meaningless;
    * pinned      — refcount >= 1, owned by one or more live requests
                    (shared only via a prefix-cache hit);
    * cached-free — refcount 0 but still registered under its prompt
                    prefix in an LRU: reusable by a future prefix hit,
                    evictable (oldest first) when a reservation
                    outgrows the free list.

    Prefix keys are opaque hashables minted by the cache owner
    (PagedKVCache chains SHA-256 digests over the token prefix a
    block completes — O(prompt) to build, and a cross-prompt
    collision would be a SHA-256 collision).
    """

    def __init__(self, n_blocks: int, reserved: int = 1):
        if n_blocks <= reserved:
            raise ValueError(
                f"pool needs > {reserved} blocks, got {n_blocks}"
            )
        self.n_blocks = int(n_blocks)
        self.reserved = int(reserved)
        # LIFO free list: a just-freed (cache-warm) block is reused
        # first, same as the arena slot free list.
        self._free: List[int] = list(
            range(n_blocks - 1, reserved - 1, -1)
        )
        self._refcount: Dict[int, int] = {}
        self._prefix_to_block: Dict[Hashable, int] = {}
        self._block_prefix: Dict[int, Hashable] = {}
        #: refcount-0 blocks still holding a registered prefix, oldest
        #: first (eviction order).
        self._cached: "OrderedDict[int, None]" = OrderedDict()

    # -- capacity ------------------------------------------------------
    def capacity(self) -> int:
        """Blocks a single reservation could ever obtain."""
        return self.n_blocks - self.reserved

    def available(self) -> int:
        """Blocks obtainable right now (free + evictable cached)."""
        return len(self._free) + len(self._cached)

    def used(self) -> int:
        """Blocks pinned by live requests."""
        return len(self._refcount)

    def cached(self) -> int:
        """Refcount-0 blocks retained for prefix reuse."""
        return len(self._cached)

    # -- allocation ----------------------------------------------------
    def reserve(self, n: int) -> List[int]:
        """Claim `n` blocks at refcount 1. Free blocks first, then
        LRU-evict cached-free blocks (their prefix entries drop).
        Raises BlocksExhausted — the caller sheds or keeps the request
        queued — without handing out a partial set."""
        if n < 0:
            raise ValueError(f"reserve({n})")
        if n > self.available():
            raise BlocksExhausted(
                f"need {n} KV blocks, only {self.available()} "
                f"available (pool {self.capacity()})"
            )
        out: List[int] = []
        for _ in range(n):
            if self._free:
                block = self._free.pop()
            else:
                block, _ = self._cached.popitem(last=False)
                del self._prefix_to_block[self._block_prefix.pop(block)]
            self._refcount[block] = 1
            out.append(block)
        return out

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block. A block reaching refcount 0
        goes to the cached-free LRU if it still holds a registered
        prefix, else back to the free list. Double-free raises — the
        engine-killing class of bug the arena design hit once
        (a mid-prefill cancel released twice) must be loud."""
        for block in blocks:
            count = self._refcount.get(block)
            if count is None:
                raise ValueError(
                    f"double free of KV block {block}"
                )
            if count > 1:
                self._refcount[block] = count - 1
                continue
            del self._refcount[block]
            if block in self._block_prefix:
                self._cached[block] = None
            else:
                self._free.append(block)

    # -- prefix cache --------------------------------------------------
    def peek_prefix(self, keys: Sequence[Hashable]) -> int:
        """Length of the longest cached run of `keys` (no pinning) —
        the admission gate's lookahead."""
        hits = 0
        for key in keys:
            if key not in self._prefix_to_block:
                break
            hits += 1
        return hits

    def peek_cached(self, keys: Sequence[Hashable], limit: int) -> int:
        """Among the first `limit` blocks of the longest cached run of
        `keys`, how many are currently refcount-0 (cached-free)?
        Pinning THOSE removes them from `available()`; hit blocks
        already pinned by a live request cost nothing to share — the
        distinction the admission gate needs to budget a reservation
        exactly (no pinning here)."""
        cached = 0
        for key in keys[: max(0, limit)]:
            block = self._prefix_to_block.get(key)
            if block is None:
                break
            if self._refcount.get(block, 0) == 0:
                cached += 1
        return cached

    def match_prefix(self, keys: Sequence[Hashable]) -> List[int]:
        """Pin and return the blocks of the longest cached run of
        `keys`. Pinning removes a cached-free block from the eviction
        LRU, so a reservation made after this call cannot steal a
        matched block."""
        out: List[int] = []
        for key in keys:
            block = self._prefix_to_block.get(key)
            if block is None:
                break
            count = self._refcount.get(block, 0)
            if count == 0:
                self._cached.pop(block, None)
            self._refcount[block] = count + 1
            out.append(block)
        return out

    def register(self, block: int, key: Hashable) -> bool:
        """Publish a pinned block as the cache of prompt prefix `key`.
        First writer wins: if the prefix (or the block) is already
        registered the call is a no-op — the caller's copy simply
        stays private."""
        if self._refcount.get(block) is None:
            raise ValueError(
                f"register of unpinned KV block {block}"
            )
        if key in self._prefix_to_block or block in self._block_prefix:
            return False
        self._prefix_to_block[key] = block
        self._block_prefix[block] = key
        return True

    def stats(self) -> Dict[str, int]:
        return {
            "kv_blocks_total": self.capacity(),
            "kv_blocks_used": self.used(),
            "kv_blocks_cached": self.cached(),
            "kv_blocks_free": len(self._free),
        }


class PagedKVCache:
    """The engine's shared block pool plus its geometry: block length,
    per-request logical-table width, and prompt-length buckets."""

    def __init__(
        self,
        cfg: LlamaConfig,
        n_blocks: int,
        block_len: int,
        max_len: int,
        prefill_chunk: int,
        device="cuda",
    ):
        if prefill_chunk < 1 or prefill_chunk > max_len:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} outside [1, {max_len}]"
            )
        if block_len < 1 or prefill_chunk % block_len != 0:
            raise ValueError(
                f"kv_block_len {block_len} must divide the prefill "
                f"chunk {prefill_chunk} (chunks write whole blocks)"
            )
        if max_len % block_len != 0:
            raise ValueError(
                f"max_len {max_len} must be a multiple of "
                f"kv_block_len {block_len}"
            )
        self.cfg = cfg
        self.block_len = int(block_len)
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        #: Logical table width: the block count a max_len sequence
        #: needs; every request's table pads to it (static shapes).
        self.max_blocks = self.max_len // self.block_len
        self.alloc = BlockAllocator(n_blocks, reserved=1)
        self._pool = init_block_pool(cfg, int(n_blocks), self.block_len,
                                     device=device)

    # -- pool ----------------------------------------------------------
    @property
    def pool(self) -> Dict[str, object]:
        """The {"k", "v"} block pool the paged forward consumes and
        updates in place."""
        return self._pool

    @pool.setter
    def pool(self, new: Dict[str, object]) -> None:
        self._pool = new

    # -- geometry ------------------------------------------------------
    def bucket_for(self, prompt_len: int) -> int:
        return bucket_for(prompt_len, self.prefill_chunk, self.max_len)

    def blocks_for(self, total_tokens: int) -> int:
        """Blocks a sequence of `total_tokens` positions occupies."""
        return -(-int(total_tokens) // self.block_len)

    def prefix_keys(self, prompt: Sequence[int]) -> List[bytes]:
        """Prefix-cache keys for every FULL block of `prompt`: key i
        is an incremental SHA-256 chain digest(i-1) || block-i tokens,
        so building all keys is O(prompt_len) in time AND memory
        (materializing the exact prefix per key would be quadratic),
        while the chain still binds each key to the ENTIRE token
        prefix — a cross-prompt key collision is a SHA-256 collision.
        The final PARTIAL block (if any) never gets a key — decode
        writes into it, and shared blocks must stay immutable."""
        import hashlib

        bl = self.block_len
        keys: List[bytes] = []
        digest = b"rt-paged-kv-prefix"
        for i in range(len(prompt) // bl):
            chained = hashlib.sha256(digest)
            chained.update(
                ",".join(map(str, prompt[i * bl:(i + 1) * bl])).encode()
            )
            digest = chained.digest()
            keys.append(digest)
        return keys

    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (self._pool["k"], self._pool["v"])
        )
