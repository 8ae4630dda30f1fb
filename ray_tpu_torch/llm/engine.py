"""Continuous-batching LLM inference engine over a PAGED KV cache
(PyTorch port of `ray_tpu/llm/engine.py`).

Requests hold refcounted `block_len`-sized pages of ONE shared pool
(kv_slots.PagedKVCache), and a request whose prompt prefix is already
pooled (same system prompt) SKIPS prefill for the covered blocks. The
background step loop, every iteration:

  1. reaps cancellations and frees their slots + blocks immediately;
  2. admits the FIFO head of the waiting queue - gated on KV-block
     availability (not enough blocks: the head WAITS, no skip-ahead,
     no crash) - pinning any prefix-cache hit and reserving the rest
     of its pages, then advances its prefill by ONE fixed-size chunk
     written straight into its pages (Sarathi-style interleave,
     starting AFTER the shared prefix);
  3. runs ONE paged decode step over the FULL slot batch (full-width
     block tables, dead rows masked and parked on the null block) -
     `models/generate.paged_decode_step` - streaming each live row's
     token to its consumer queue, with one device-to-host copy of the
     sampled tokens per step;
  4. retires EOS/budget rows, releasing slots and unpinning blocks in
     the same iteration (full prompt blocks stay cached for future
     prefix hits until memory pressure evicts them).

Requests are host-side objects; per-request device state is the pages
its table points at + one row of `last_logits`. Sampling parameters are
engine-level (greedy is the serving default); sampled decoding draws
from a `torch.Generator` on the model's device, seeded from
`EngineConfig.seed` and the step count.

Threading: submit()/cancel() may be called from any thread; all
scheduler/allocator/request state is guarded by one lock, device work
runs outside it. One engine = one step thread = one model family. The
step thread enters `torch.inference_mode()` and selects the model's
device itself: both are thread-local, and without them every decode
step would record an autograd graph.

Failure: if the step loop dies, every in-flight and queued request is
failed with the loop's exception (consumers raise, never hang) and
subsequent submits raise EngineDead.

Versioned weights (`update_weights`): a weight push installs a new
parameter GENERATION without stopping the step loop. Every request pins
the generation that was latest at its ADMISSION and decodes on it to
completion - a push mid-decode leaves in-flight streams token-exact on
the old weights - while the next admission (and every policy batch)
uses the new generation. During the mixed window the decode batch
partitions by generation and runs one masked decode step per generation
over the same pool. Old generations are dropped the moment their last
pinned request retires.

Batch programs (`program=`, `submit_policy`): callers submit small row
batches from any thread; the loop coalesces everything pending into one
padded bucket, runs the program's forward ONCE and scatters the rows
back to their tickets. A policy-only engine passes ``cfg=None``.

Observability: as the JAX engine, this one reports every decode step,
prefill chunk, prefix hit, first token, retirement, occupancy change,
weight push and policy batch to `serve.observability` (the
`serve_engine_*` series, tagged with the engine's app, deployment and
family); the hooks are guarded, so a failure there never fails a
decode. It also keeps counters that `stats()` returns: decode steps
and their time by batch width, prefill chunks, tokens and time, and
the requests each policy forward served.

Spans: the step thread stamps each boundary of its loop once with
`time.time_ns()` (the clock of torch.profiler's events) and records the
interval in the process's flight recorder (kind `engine`) and in a
counter of `stats()`, from the same stamps:

  queue           submit -> admission (request)      queue_wait_ms, admitted
  admit           the lock, gate and allocation (request)
  prefill.launch  a chunk's start -> its sync (request, offset)
                                                     prefill_launch_ms
  prefill.wait    the sync (request)                 prefill_wait_ms
  decode.launch   a step's start -> its device->host copy (step, batch)
                                                     decode_launch_ms
  decode.wait     the copy and its wait (step)       decode_wait_ms
  decode.emit     the tokens on the host -> after the step's hooks (step)
                                                     decode_emit_ms
  idle            the loop's first park on its wake event -> its last
                  before work resumes                idle_ms

so launch + wait is `prefill_ms`, and the decode steps' ms of
`decode_by_batch`. The counters cover the engine's life (an idle
period once it ends); with the recorder off the spans record nothing (one
attribute read each, ``RT_flight_recorder_enabled=0``).

Compile watch: as in the JAX engine, the prefill, decode and policy
programs are registered by family (`engine.paged_prefill[<family>]`,
`engine.paged_decode_step[<family>]`, `engine.policy[<family>]`, the
last late-bound through `self._program`), and `stats()["compiles"]`
gives each one's `{"compiles", "distinct_shapes"}`: fixed after
warm-up, so movement under traffic is a new-signature bug.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from .._private import flight_recorder
from ..models.generate import paged_decode_step, paged_prefill
from .kv_slots import NULL_BLOCK, PagedKVCache, default_block_len
from .scheduler import EngineDead, EngineOverloaded, SlotScheduler

__all__ = [
    "EngineConfig",
    "InferenceEngine",
    "TokenStream",
    "PolicyTicket",
    "BatchProgram",
    "EngineOverloaded",
    "EngineDead",
]

#: Seed stream of the policy path's generator (the decode path's is 0).
_POLICY_STREAM = 0x9E37


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine admission/cache knobs."""

    #: Decode-batch width = max concurrently-decoding sequences. With
    #: the paged cache this is DECOUPLED from KV memory: extra slots
    #: cost one block-table row + one logits row, not max_len of KV.
    slots: int = 4
    #: Per-REQUEST KV cap; prompt_len + max_new_tokens must fit. The
    #: admission bound and the logical block-table width.
    max_len: int = 256
    #: Prefill chunk length. Prompts pad up to a multiple of this
    #: (the length-bucket set), and long prompts prefill chunk-by-
    #: chunk interleaved with decode steps.
    prefill_chunk: int = 32
    #: KV block (page) length in tokens; 0 = auto (largest divisor of
    #: prefill_chunk up to 16). Must divide prefill_chunk and max_len.
    kv_block_len: int = 0
    #: Physical KV pool size in blocks (one extra is reserved as the
    #: null block); 0 = auto: slots x max_len worth.
    kv_blocks: int = 0
    #: Prefix caching: full prompt blocks register under their exact
    #: token prefix; a later request with the same prefix pins the
    #: blocks and skips prefill for them.
    prefix_cache: bool = True
    #: Waiting-queue bound; past it submit() raises EngineOverloaded.
    max_waiting: int = 64
    #: Default per-request token budget (requests may pass their own).
    max_new_tokens: int = 64
    #: Engine-level sampling parameters (0.0 = greedy).
    temperature: float = 0.0
    top_k: int = 0
    #: Default EOS token id (-1 = none); requests may override.
    eos_token: int = -1
    #: RNG seed for sampled decoding (ignored when greedy).
    seed: int = 0
    #: Idle-loop park time waiting for work.
    idle_wait_s: float = 0.02
    #: Bound on pending policy-path rows (submit_policy sheds with
    #: EngineOverloaded past it); only meaningful with a `program`.
    max_policy_rows: int = 4096


class _Request:
    __slots__ = (
        "request_id", "prompt", "max_new_tokens", "eos_token",
        "out", "cancelled", "submitted_ts", "first_token_ts",
        "submitted_ns",
        "emitted", "slot", "bucket", "offset", "padded",
        "prefix_keys", "total_blocks", "block_ids", "n_shared",
        "skip", "gen",
    )

    def __init__(
        self,
        request_id: str,
        prompt: List[int],
        max_new_tokens: int,
        eos_token: int,
    ):
        self.request_id = request_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_token = eos_token
        #: Consumer stream: ("tok", id) | ("end", reason) |
        #: ("err", exc). Unbounded - the engine must never block on a
        #: slow consumer (that would head-of-line block the whole
        #: decode batch); depth is bounded in practice by max_new.
        self.out: "queue.Queue" = queue.Queue()
        self.cancelled = threading.Event()
        self.submitted_ts = time.perf_counter()
        self.first_token_ts: Optional[float] = None
        #: The queue span's start, on the clock of the engine's spans.
        self.submitted_ns = time.time_ns()
        self.emitted = 0
        # prefill progress (engine thread only)
        self.slot: Optional[int] = None
        self.bucket = 0
        self.offset = 0
        self.padded = None
        # paged-cache bookkeeping
        self.prefix_keys: List[bytes] = []
        self.total_blocks = 0
        self.block_ids: List[int] = []
        self.n_shared = 0
        self.skip = 0
        #: Weight generation pinned at ADMISSION (None until then):
        #: the request prefills and decodes on this generation to
        #: completion even if update_weights lands mid-stream.
        self.gen: Optional[int] = None


class TokenStream:
    """Consumer side of one request: iterate token ids as they are
    sampled. Ends at EOS/budget/cancel; raises if the engine failed
    the request. `finish_reason` is set once exhausted."""

    def __init__(self, engine: "InferenceEngine", req: _Request):
        self._engine = engine
        self._req = req
        self.finish_reason: Optional[str] = None

    @property
    def request_id(self) -> str:
        return self._req.request_id

    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        if self.finish_reason is not None:
            raise StopIteration
        while True:
            try:
                kind, value = self._req.out.get(timeout=1.0)
                break
            except queue.Empty:
                # A dead engine fails every request with a sentinel,
                # but if this request somehow missed one the consumer
                # must raise, not hang forever.
                if (
                    self._engine._dead is not None
                    and self._req.out.empty()
                ):
                    self.finish_reason = "error"
                    raise EngineDead(
                        "engine died mid-stream"
                    ) from self._engine._dead
        if kind == "tok":
            return value
        if kind == "end":
            self.finish_reason = value
            raise StopIteration
        self.finish_reason = "error"
        raise value

    def cancel(self) -> None:
        self._engine.cancel(self._req.request_id)


class BatchProgram:
    """Pluggable batch program for the engine's policy path.

    A program turns one PADDED row batch of inputs into a dict of
    per-row outputs with ONE call; the engine's step loop owns batching
    - it coalesces every pending `submit_policy` request into the
    smallest bucket that fits and scatters the output rows back to
    their tickets. Subclasses override `run`; `buckets` is the
    ascending set of padded batch sizes."""

    #: Ascending padded batch sizes; a single submit may not exceed
    #: buckets[-1] rows.
    buckets: tuple = (8, 16, 32, 64, 128, 256)

    def bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def run(self, params, inputs: torch.Tensor,
            generator: torch.Generator) -> Dict[str, Any]:
        """(params, padded inputs [bucket, ...] on the engine's device,
        a seeded generator on that device) -> dict of [bucket, ...]
        output tensors or arrays."""
        raise NotImplementedError


class _PolicyRequest:
    __slots__ = (
        "inputs", "n", "done", "result", "error", "version",
    )

    def __init__(self, inputs: np.ndarray):
        self.inputs = inputs
        self.n = int(len(inputs))
        self.done = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.version: Optional[int] = None


class PolicyTicket:
    """Consumer side of one policy-path request: `result()` blocks
    until the engine's step loop has served the rows (raising, never
    hanging, if the engine dies first). `version` is the weight
    version the reply was computed with."""

    def __init__(self, engine: "InferenceEngine", req: _PolicyRequest):
        self._engine = engine
        self._req = req

    @property
    def version(self) -> Optional[int]:
        return self._req.version

    def result(
        self, timeout: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        deadline = (
            None if timeout is None else time.perf_counter() + timeout
        )
        while True:
            wait = 1.0
            if deadline is not None:
                wait = min(wait, deadline - time.perf_counter())
                if wait <= 0:
                    raise TimeoutError(
                        "policy request not served in time"
                    )
            if self._req.done.wait(wait):
                break
            # Same contract as TokenStream: a dead engine fails every
            # ticket, but if this one somehow missed the sentinel the
            # consumer must raise, not hang.
            if (
                self._engine._dead is not None
                and not self._req.done.is_set()
            ):
                raise EngineDead(
                    "engine died with policy request pending"
                ) from self._engine._dead
        if self._req.error is not None:
            raise self._req.error
        assert self._req.result is not None
        return self._req.result


def _module_device(params) -> torch.device:
    for p in params.parameters():
        return p.device
    raise ValueError("the engine's model has no parameters")


class InferenceEngine:
    """The engine. `params` is the model: the port's `Llama` for the
    LLM path (`cfg` its `LlamaConfig`), or the module a `program` runs
    for a policy-only engine (`cfg=None`). The engine computes on that
    module's device."""

    def __init__(
        self,
        params: torch.nn.Module,
        cfg,
        engine_config: Optional[EngineConfig] = None,
        *,
        family: str = "",
        app: str = "",
        deployment: str = "",
        program: Optional[BatchProgram] = None,
    ):
        ec = engine_config or EngineConfig()
        self.params = params
        self.cfg = cfg
        self.config = ec
        self.family = family
        self._program = program
        if cfg is None and program is None:
            raise ValueError(
                "cfg=None (policy-only engine) requires a `program`"
            )
        self._tags = {
            "app": app, "deployment": deployment,
            "family": family or "default",
        }
        self._device = _module_device(params)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        # Versioned weight generations: generation index -> {version,
        # params, refs}. `refs` counts the LLM requests pinned at
        # admission; a non-latest generation is dropped the moment its
        # count returns to zero. The policy path always reads the
        # latest generation and pins nothing.
        self._gens: Dict[int, Dict[str, Any]] = {
            0: {"version": 0, "params": params, "refs": 0}
        }
        self._gen_latest = 0
        self._weight_version = 0
        if cfg is not None:
            block_len = ec.kv_block_len or default_block_len(
                ec.prefill_chunk
            )
            n_blocks = ec.kv_blocks or (
                ec.slots * (ec.max_len // block_len) + 1
            )
            self._kv = PagedKVCache(
                cfg, n_blocks, block_len, ec.max_len, ec.prefill_chunk,
                device=self._device,
            )
            self._sched = SlotScheduler(ec.slots, ec.max_waiting)
            # Per-slot decode state. positions/alive/tables live
            # host-side (the engine mutates them per admission/step);
            # last_logits stays on the device.
            self._positions = np.zeros(ec.slots, np.int64)
            self._alive = np.zeros(ec.slots, bool)
            self._tables = np.full(
                (ec.slots, self._kv.max_blocks), NULL_BLOCK, np.int64
            )
            self._last_logits = torch.zeros(
                (ec.slots, cfg.vocab_size), dtype=torch.float32,
                device=self._device,
            )
        else:
            self._kv = None
            self._sched = None
        self._rng = torch.Generator(device=self._device)
        # Compile-watch registration, by family as in the JAX engine:
        # the family rides in the program NAME (bounded: model
        # families), never a free-form label.
        from .._private import compile_watch

        fam = family or "default"
        if cfg is not None:
            self._paged_prefill = compile_watch.instrument(
                f"engine.paged_prefill[{fam}]", paged_prefill
            )
            self._paged_decode = compile_watch.instrument(
                f"engine.paged_decode_step[{fam}]", paged_decode_step
            )
        if program is not None:
            # Late-bound through self._program so a swapped program
            # takes effect: the watcher wraps the CALL.
            self._program_run = compile_watch.instrument(
                f"engine.policy[{fam}]",
                lambda *a, **k: self._program.run(*a, **k),
            )
        self._prefilling: Optional[_Request] = None
        self._by_id: Dict[str, _Request] = {}
        self._policy_pending: "deque[_PolicyRequest]" = deque()
        self._policy_rows_pending = 0
        self._policy_steps = 0
        #: Requests served by one policy forward -> forwards.
        self._policy_batches: Dict[int, int] = {}
        self._policy_rows_served = 0
        self._steps = 0
        self._tokens_emitted = 0
        self._requests_done = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_tokens_saved = 0
        self._prefill_chunks = 0
        self._prefill_tokens = 0
        self._prefill_ms = 0.0
        #: Decode batch width -> [steps, total ms].
        self._decode_by_batch: Dict[int, List[float]] = {}
        # The loop's spans, summed (module docstring).
        self._queue_wait_ms = 0.0
        self._admitted = 0
        self._prefill_launch_ms = 0.0
        self._prefill_wait_ms = 0.0
        self._decode_launch_ms = 0.0
        self._decode_wait_ms = 0.0
        self._decode_emit_ms = 0.0
        self._idle_ms = 0.0
        self._dead: Optional[BaseException] = None
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run,
            daemon=True,
            name=f"llm-engine:{family or 'default'}",
        )
        self._thread.start()

    # -- public --------------------------------------------------------
    def submit(
        self,
        prompt: List[int],
        *,
        max_new_tokens: Optional[int] = None,
        eos_token: Optional[int] = None,
        request_id: Optional[str] = None,
    ) -> TokenStream:
        ec = self.config
        if self._kv is None:
            raise ValueError(
                "policy-only engine (cfg=None) has no LLM path; use "
                "submit_policy()"
            )
        max_new = int(
            ec.max_new_tokens if max_new_tokens is None
            else max_new_tokens
        )
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = [int(t) for t in prompt]
        bucket = self._kv.bucket_for(len(prompt))
        if len(prompt) + max_new > ec.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds per-request capacity max_len={ec.max_len}"
            )
        if eos_token is not None and eos_token != int(eos_token):
            raise ValueError(
                f"eos_token must be integral, got {eos_token!r}"
            )
        total_blocks = self._kv.blocks_for(
            max(bucket, len(prompt) + max_new)
        )
        if total_blocks > self._kv.alloc.capacity():
            # OOM is a SHED, not a crash or an unserviceable queue
            # entry: this request could never be admitted.
            raise EngineOverloaded(
                f"request needs {total_blocks} KV blocks but the pool "
                f"holds {self._kv.alloc.capacity()}; shed"
            )
        req = _Request(
            request_id or uuid.uuid4().hex[:16],
            prompt,
            max_new,
            ec.eos_token if eos_token is None else int(eos_token),
        )
        req.bucket = bucket
        req.total_blocks = total_blocks
        if ec.prefix_cache:
            req.prefix_keys = self._kv.prefix_keys(prompt)
        with self._lock:
            if self._dead is not None or self._stopping:
                raise EngineDead(
                    "engine is shut down"
                ) from self._dead
            if req.request_id in self._by_id:
                raise ValueError(
                    f"duplicate request_id {req.request_id!r}"
                )
            self._sched.submit(req)
            self._by_id[req.request_id] = req
        self._wake.set()
        return TokenStream(self, req)

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or in-flight request. Queued requests end
        immediately; running ones are reaped (slot + blocks freed) at
        the top of the next engine iteration - mid-decode, not at
        stream end."""
        with self._lock:
            req = self._by_id.get(request_id)
            if req is None:
                return False
            req.cancelled.set()
            if self._sched.remove_waiting(req):
                self._finish_locked(req, "cancelled")
        self._wake.set()
        return True

    def update_weights(
        self, params: torch.nn.Module, *, version: Optional[int] = None
    ) -> int:
        """Install a new weight generation WITHOUT draining the engine:
        in-flight LLM requests keep the generation they were admitted
        under and finish token-exact on it; the next admission - and
        the next policy batch - serves the new weights. `params` is a
        model of the same configuration on the same device. Returns
        the installed weight version (monotonic; pass `version` to
        carry the trainer's own numbering)."""
        if version is not None and version != int(version):
            raise ValueError(
                f"version must be integral, got {version!r}"
            )
        with self._lock:
            if self._dead is not None or self._stopping:
                raise EngineDead(
                    "engine is shut down"
                ) from self._dead
            v = (
                int(version) if version is not None
                else self._weight_version + 1
            )
            if v <= self._weight_version:
                raise ValueError(
                    f"weight version must increase: got {v}, "
                    f"serving {self._weight_version}"
                )
            self._gen_latest += 1
            self._gens[self._gen_latest] = {
                "version": v, "params": params, "refs": 0,
            }
            self._weight_version = v
            self.params = params
            self._prune_gens_locked()
        self._observe_weights()
        self._wake.set()
        return v

    def _prune_gens_locked(self) -> None:
        for gen in [
            g for g, e in self._gens.items()
            if g != self._gen_latest and e["refs"] <= 0
        ]:
            del self._gens[gen]

    def submit_policy(self, inputs) -> PolicyTicket:
        """Queue one row batch for the policy batch program; the step
        loop coalesces everything pending into one padded bucket and
        runs the program's forward once."""
        if self._program is None:
            raise ValueError(
                "engine was built without a policy batch program"
            )
        inputs = np.asarray(inputs)
        if inputs.ndim < 1 or len(inputs) < 1:
            raise ValueError("submit_policy needs >= 1 input row")
        if len(inputs) > self._program.buckets[-1]:
            raise ValueError(
                f"policy batch of {len(inputs)} rows exceeds the "
                f"program's largest bucket "
                f"{self._program.buckets[-1]}; split it"
            )
        req = _PolicyRequest(inputs)
        with self._lock:
            if self._dead is not None or self._stopping:
                raise EngineDead(
                    "engine is shut down"
                ) from self._dead
            if (
                self._policy_rows_pending + req.n
                > self.config.max_policy_rows
            ):
                raise EngineOverloaded(
                    f"policy backlog full "
                    f"({self.config.max_policy_rows} rows); shed"
                )
            self._policy_pending.append(req)
            self._policy_rows_pending += req.n
        self._wake.set()
        return PolicyTicket(self, req)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = (
                self._sched.stats() if self._sched is not None
                else {"slots_total": 0, "slots_used": 0, "waiting": 0}
            )
            out.update(
                family=self.family,
                steps=self._steps,
                tokens_emitted=self._tokens_emitted,
                requests_done=self._requests_done,
                prefilling=self._prefilling is not None,
                prefix_hits=self._prefix_hits,
                prefix_misses=self._prefix_misses,
                prefix_tokens_saved=self._prefix_tokens_saved,
                prefill_chunks=self._prefill_chunks,
                prefill_tokens=self._prefill_tokens,
                prefill_ms=self._prefill_ms,
                decode_by_batch={
                    width: {"steps": int(steps), "ms": ms}
                    for width, (steps, ms) in sorted(
                        self._decode_by_batch.items())
                },
                queue_wait_ms=self._queue_wait_ms,
                admitted=self._admitted,
                prefill_launch_ms=self._prefill_launch_ms,
                prefill_wait_ms=self._prefill_wait_ms,
                decode_launch_ms=self._decode_launch_ms,
                decode_wait_ms=self._decode_wait_ms,
                decode_emit_ms=self._decode_emit_ms,
                idle_ms=self._idle_ms,
                weight_version=self._weight_version,
                weight_gens=len(self._gens),
                policy_pending_rows=self._policy_rows_pending,
                policy_steps=self._policy_steps,
                policy_requests_per_step=dict(
                    sorted(self._policy_batches.items())),
                policy_rows_served=self._policy_rows_served,
                dead=self._dead is not None,
            )
            # Per-family compile counts: prefill / decode / policy
            # programs, each {compiles, distinct_shapes}.
            compiles: Dict[str, Any] = {}
            if self._kv is not None:
                compiles["prefill"] = self._paged_prefill.stats()
                compiles["decode"] = self._paged_decode.stats()
            if self._program is not None:
                compiles["policy"] = self._program_run.stats()
            if compiles:
                out["compiles"] = compiles
            if self._kv is not None:
                out.update(
                    kv_bytes=self._kv.nbytes(),
                    kv_block_len=self._kv.block_len,
                    **self._kv.alloc.stats(),
                )
        return out

    def close(self) -> None:
        """Stop the loop and fail everything in flight. In-flight
        consumers get an ERROR, not a clean end - a truncated response
        must be detectable."""
        with self._lock:
            self._stopping = True
        self._wake.set()
        self._thread.join(timeout=30)
        with self._lock:
            if self._dead is None:
                self._dead = EngineDead("engine unloaded")
            self._fail_all_locked(
                EngineDead("engine unloaded with request in flight")
            )

    # -- engine loop ---------------------------------------------------
    def _device_scope(self):
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def _seeded(self, *stream: int) -> torch.Generator:
        """The engine's generator, seeded from the config's seed and
        `stream` (the step count, and a tag for the policy path)."""
        seed = hash((self.config.seed,) + stream) & 0x7FFF_FFFF_FFFF_FFFF
        return self._rng.manual_seed(seed)

    def _sync(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _run(self) -> None:
        try:
            # Grad mode and the current device are thread-local: this
            # thread sets both for itself.
            with torch.inference_mode(), self._device_scope():
                # One idle span from the first park to the last of a
                # run of parks, recorded when work resumes.
                idle_from = idle_to = None
                while True:
                    with self._lock:
                        if self._stopping:
                            return
                    did_work = self._step()
                    if not did_work:
                        if idle_from is None:
                            idle_from = time.time_ns()
                        self._wake.wait(self.config.idle_wait_s)
                        self._wake.clear()
                        idle_to = time.time_ns()
                    elif idle_from is not None:
                        self._idle_ms += (idle_to - idle_from) * 1e-6
                        flight_recorder.record_span(
                            "engine", "idle", idle_from, idle_to)
                        idle_from = None
        except BaseException as e:  # noqa: BLE001 - forwarded to
            # every consumer; the loop must never die silently.
            failure = EngineDead(f"engine loop died: {e!r}")
            failure.__cause__ = e
            with self._lock:
                self._dead = e
                self._fail_all_locked(failure)

    def _step(self) -> bool:
        """One engine iteration; returns whether any work happened.
        Policy batches go first: their callers are blocked threads, and
        one batched forward is cheap next to a decode step over the
        full slot batch."""
        worked = self._reap_cancelled()
        worked = self._policy_step() or worked
        if self._sched is not None:
            worked = self._advance_prefill() or worked
            worked = self._decode() or worked
        return worked

    # -- policy path ---------------------------------------------------
    def _policy_step(self) -> bool:
        """Serve every pending policy request that fits the largest
        bucket in ONE padded batched forward on the LATEST weight
        generation; scatter output rows back to their tickets."""
        if self._program is None:
            return False
        with self._lock:
            if not self._policy_pending:
                return False
            cap = self._program.buckets[-1]
            batch: List[_PolicyRequest] = []
            rows = 0
            while (
                self._policy_pending
                and rows + self._policy_pending[0].n <= cap
            ):
                req = self._policy_pending.popleft()
                self._policy_rows_pending -= req.n
                batch.append(req)
                rows += req.n
            entry = self._gens[self._gen_latest]
            params, version = entry["params"], entry["version"]
        t0 = time.perf_counter()
        bucket = self._program.bucket_for(rows)
        sample = batch[0].inputs
        padded = np.zeros(
            (bucket, *sample.shape[1:]), dtype=sample.dtype
        )
        cursor = 0
        for req in batch:
            padded[cursor:cursor + req.n] = req.inputs
            cursor += req.n
        try:
            outs = self._program_run(
                params, torch.tensor(padded, device=self._device),
                self._seeded(_POLICY_STREAM, self._policy_steps),
            )
            host = {
                k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)
                for k, v in outs.items()
            }
        except BaseException as e:
            # A program failure fails THIS batch's tickets (the
            # callers must not hang) and then the loop: a broken
            # program cannot serve the next batch either.
            for req in batch:
                req.error = EngineDead(
                    f"policy batch program failed: {e!r}"
                )
                req.error.__cause__ = e
                req.done.set()
            raise
        cursor = 0
        for req in batch:
            req.result = {
                k: v[cursor:cursor + req.n] for k, v in host.items()
            }
            req.version = version
            req.done.set()
            cursor += req.n
        self._policy_steps += 1
        self._policy_batches[len(batch)] = (
            self._policy_batches.get(len(batch), 0) + 1)
        self._policy_rows_served += rows
        self._observe_policy(
            (time.perf_counter() - t0) * 1e3, rows, bucket
        )
        return True

    # -- cancellation / completion ------------------------------------
    def _reap_cancelled(self) -> bool:
        if self._sched is None:
            return False
        worked = False
        with self._lock:
            # The prefilling request is ALSO in sched.running (its
            # slot was claimed at admission) - release it through this
            # branch first so the loop below can't double-release the
            # slot (release() on an already-freed slot raises and
            # would kill the whole loop).
            if (
                self._prefilling is not None
                and self._prefilling.cancelled.is_set()
            ):
                req = self._prefilling
                self._prefilling = None
                self._release_locked(req.slot, req, "cancelled")
                worked = True
            for slot, req in list(self._sched.running.items()):
                if req.cancelled.is_set():
                    self._release_locked(slot, req, "cancelled")
                    worked = True
        return worked

    def _release_locked(
        self, slot: int, req: _Request, reason: str
    ) -> None:
        self._sched.release(slot)
        self._alive[slot] = False
        self._tables[slot, :] = NULL_BLOCK
        if req.block_ids:
            # Unpin: full prompt blocks stay in the prefix cache
            # (refcount 0, LRU-evictable); private blocks go back to
            # the free list. block_ids cleared so no path can double-
            # free (the allocator would raise and kill the loop).
            self._kv.alloc.release(req.block_ids)
            req.block_ids = []
        self._unpin_gen_locked(req)
        self._finish_locked(req, reason)

    def _unpin_gen_locked(self, req: _Request) -> None:
        if req.gen is None:
            return
        entry = self._gens.get(req.gen)
        req.gen = None
        if entry is not None:
            entry["refs"] -= 1
            self._prune_gens_locked()

    def _finish_locked(self, req: _Request, reason: str) -> None:
        self._by_id.pop(req.request_id, None)
        self._requests_done += 1
        req.out.put(("end", reason))
        self._observe_finish(reason)
        # Push occupancy from the retirement itself: cancellation/
        # drain may leave no alive rows, so no decode step would ever
        # publish the freed slots.
        self._observe_occupancy()

    def _fail_all_locked(self, error: BaseException) -> None:
        if self._prefilling is not None:
            doomed = [self._prefilling]
            self._prefilling = None
        else:
            doomed = []
        if self._sched is not None:
            doomed.extend(self._sched.drain())
            self._alive[:] = False
            self._tables[:, :] = NULL_BLOCK
        for req in doomed:
            if req.block_ids:
                try:
                    self._kv.alloc.release(req.block_ids)
                except Exception:
                    pass  # dying anyway; never mask the real failure
                req.block_ids = []
            req.gen = None
            self._by_id.pop(req.request_id, None)
            req.out.put(("err", error))
        # Pending policy tickets fail FAST too: their callers are
        # synchronously blocked threads - an engine death must turn
        # into EngineDead there, never a hang.
        while self._policy_pending:
            preq = self._policy_pending.popleft()
            self._policy_rows_pending -= preq.n
            preq.error = error
            preq.done.set()
        self._observe_occupancy()

    # -- admission / block allocation ---------------------------------
    def _skip_for(self, req: _Request, hit_blocks: int) -> int:
        """Prefill tokens a prefix hit lets this request skip: capped
        at len(prompt) - 1 (the LAST prompt token is always computed -
        its logits seed decoding) and rounded down to a whole prefill
        chunk (offsets stay chunk-aligned, keeping the chunk shape
        static)."""
        bl = self._kv.block_len
        chunk = self._kv.prefill_chunk
        usable = min(hit_blocks * bl, len(req.prompt) - 1)
        return (usable // chunk) * chunk

    def _gate_locked(self, req: _Request) -> bool:
        """Admission gate: can the FIFO head get its blocks NOW? The
        reservation needs `total - skip` fresh blocks, and pinning the
        hit additionally consumes `cached` availability - only the
        hit blocks that are currently refcount-0 (cached-free) leave
        `available()` when pinned; hits already pinned by a live
        request are free to share. A gated admission can therefore
        never fail its reservation one line later."""
        alloc = self._kv.alloc
        hits = alloc.peek_prefix(req.prefix_keys)
        skip_blocks = self._skip_for(req, hits) // self._kv.block_len
        cached = alloc.peek_cached(req.prefix_keys, skip_blocks)
        return (
            alloc.available() - cached
            >= req.total_blocks - skip_blocks
        )

    def _allocate_locked(self, req: _Request) -> None:
        """Pin the request's prefix-cache hit (if any) and reserve the
        rest of its pages; build its table row. Runs under the lock in
        the same critical section as the gate."""
        alloc = self._kv.alloc
        shared = alloc.match_prefix(req.prefix_keys)
        skip = self._skip_for(req, len(shared))
        skip_blocks = skip // self._kv.block_len
        if len(shared) > skip_blocks:
            # Hit blocks beyond the chunk-aligned usable window: unpin
            # them again (they stay cached).
            alloc.release(shared[skip_blocks:])
            shared = shared[:skip_blocks]
        req.skip = skip
        req.offset = skip
        req.n_shared = skip_blocks
        req.block_ids = shared + alloc.reserve(
            req.total_blocks - skip_blocks
        )
        row = self._tables[req.slot]
        row[:] = NULL_BLOCK
        row[: len(req.block_ids)] = req.block_ids
        if skip:
            self._prefix_hits += 1
            self._prefix_tokens_saved += skip
        else:
            self._prefix_misses += 1
        self._observe_prefix(skip)

    # -- prefill -------------------------------------------------------
    def _advance_prefill(self) -> bool:
        """Admit (if idle) and advance the current prefill by ONE
        chunk, written straight into the request's pages. Returns
        whether prefill work happened."""
        t_lock = time.time_ns()
        with self._lock:
            req = self._prefilling
            if req is None:
                admitted = self._sched.admit_next(
                    gate=self._gate_locked
                )
                if admitted is None:
                    return False
                t_admitted = time.time_ns()
                req, slot = admitted
                req.slot = slot
                # Pin the weight generation at ADMISSION: every
                # prefill chunk and every decode step of this request
                # uses these weights, even if a weight push lands
                # mid-stream.
                req.gen = self._gen_latest
                self._gens[req.gen]["refs"] += 1
                self._allocate_locked(req)
                self._prefilling = req
                t_allocated = time.time_ns()
                self._queue_wait_ms += (t_admitted - req.submitted_ns) * 1e-6
                self._admitted += 1
                flight_recorder.record_span(
                    "engine", "queue", req.submitted_ns, t_admitted,
                    request=req.request_id)
                flight_recorder.record_span(
                    "engine", "admit", t_lock, t_allocated,
                    request=req.request_id)
        if req.padded is None:
            padded = np.zeros((1, req.bucket), np.int64)
            padded[0, : len(req.prompt)] = req.prompt
            req.padded = padded
        chunk = self.config.prefill_chunk
        offset = req.offset
        t0 = time.time_ns()
        dev = self._device
        tokens = torch.tensor(
            req.padded[:, req.offset:req.offset + chunk], device=dev)
        table = torch.tensor(
            self._tables[req.slot:req.slot + 1], device=dev)
        logits, pool = self._paged_prefill(
            self._gens[req.gen]["params"],
            self.cfg,
            tokens,
            self._kv.pool,
            table,
            req.offset,
            req.offset + chunk,
        )
        self._kv.pool = pool
        req.offset += chunk
        last_chunk = req.offset >= req.bucket
        if last_chunk:
            # Next-token logits come from the prompt's LAST REAL
            # position (inside this chunk by bucket construction:
            # the final chunk covers [bucket - chunk, bucket) and
            # len(prompt) > bucket - chunk - prefix skip never
            # reaches the final chunk, it is capped at
            # len(prompt) - 1).
            local = len(req.prompt) - 1 - (req.offset - chunk)
            self._last_logits[req.slot] = logits[0, local]
        # Waits for the chunk, as the JAX engine does, so its time is
        # the device's.
        t_sync = time.time_ns()
        self._sync()
        t1 = time.time_ns()
        chunk_ms = (t1 - t0) * 1e-6
        self._prefill_chunks += 1
        self._prefill_tokens += chunk
        self._prefill_ms += chunk_ms
        self._prefill_launch_ms += (t_sync - t0) * 1e-6
        self._prefill_wait_ms += (t1 - t_sync) * 1e-6
        flight_recorder.record_span(
            "engine", "prefill.launch", t0, t_sync,
            request=req.request_id, offset=offset)
        flight_recorder.record_span(
            "engine", "prefill.wait", t_sync, t1, request=req.request_id)
        self._observe_prefill(chunk_ms, chunk)
        if last_chunk:
            req.padded = None
            with self._lock:
                self._prefilling = None
                # Cancelled during the final chunk: reap now rather
                # than decoding a dead row for one step.
                if req.cancelled.is_set():
                    self._release_locked(req.slot, req, "cancelled")
                    return True
                if self.config.prefix_cache:
                    # Publish the full prompt blocks this request
                    # computed (not the ones it shared) for future
                    # prefix hits; first writer wins on races.
                    for i in range(
                        req.n_shared, len(req.prefix_keys)
                    ):
                        self._kv.alloc.register(
                            req.block_ids[i], req.prefix_keys[i]
                        )
                self._positions[req.slot] = len(req.prompt)
                self._alive[req.slot] = True
        return True

    # -- decode --------------------------------------------------------
    def _decode(self) -> bool:
        alive_idx = np.flatnonzero(self._alive)
        if alive_idx.size == 0:
            return False
        batch = int(alive_idx.size)
        ec = self.config
        dev = self._device
        step = self._steps
        t0 = time.time_ns()
        # Partition the alive batch by pinned weight generation. In
        # steady state there is exactly one group; in the window after
        # an update_weights there are two (old streams finishing, new
        # admissions starting) and each runs its own masked decode
        # step over the SAME pool - masks are disjoint and dead rows
        # scatter to the null block, so the groups can't cross-talk.
        with self._lock:
            by_gen: Dict[int, List[int]] = {}
            for slot in alive_idx:
                req = self._sched.running.get(int(slot))
                if req is None:
                    continue
                by_gen.setdefault(
                    req.gen if req.gen is not None else 0, []
                ).append(int(slot))
        if not by_gen:
            return False
        tables = torch.tensor(self._tables, device=dev)
        positions = torch.tensor(self._positions, device=dev)
        if len(by_gen) == 1:
            gen = next(iter(by_gen))
            token, pool, last_logits = self._paged_decode(
                self._gens[gen]["params"],
                self.cfg,
                self._kv.pool,
                tables,
                self._last_logits,
                positions,
                torch.tensor(self._alive, device=dev),
                self._seeded(self._steps),
                temperature=ec.temperature,
                top_k=ec.top_k,
            )
            self._kv.pool = pool
            self._last_logits = last_logits
            t_copy = time.time_ns()
            tokens = token.cpu().numpy()  # the one device->host copy
        else:
            # Mixed-generation window. paged_decode_step only reads its
            # `last_logits` and returns new logits in a tensor of its
            # own, so every group reads the same pre-step logits (the
            # JAX engine copies them, `base_logits + 0`, because its
            # step donates the buffer); the surviving rows merge back.
            base_logits = self._last_logits
            merged = base_logits
            pool = self._kv.pool
            # Tokens merge on the device too: one host copy after the
            # loop, as on the single-generation path.
            merged_tokens = None
            for gen in sorted(by_gen):
                mask = np.zeros(ec.slots, bool)
                mask[by_gen[gen]] = True
                gmask = torch.tensor(mask, device=dev)
                token, pool, out_logits = self._paged_decode(
                    self._gens[gen]["params"],
                    self.cfg,
                    pool,
                    tables,
                    base_logits,
                    positions,
                    gmask,
                    self._seeded(self._steps),
                    temperature=ec.temperature,
                    top_k=ec.top_k,
                )
                merged = torch.where(gmask[:, None], out_logits, merged)
                merged_tokens = torch.where(
                    gmask, token,
                    0 if merged_tokens is None else merged_tokens,
                )
            self._kv.pool = pool
            self._last_logits = merged
            t_copy = time.time_ns()
            tokens = merged_tokens.cpu().numpy()  # ONE copy for the window
        now_ns = time.time_ns()
        step_ms = (now_ns - t0) * 1e-6
        self._steps += 1
        now = time.perf_counter()
        emitted = 0
        with self._lock:
            for slot in alive_idx:
                req = self._sched.running.get(int(slot))
                if req is None:  # freed this iteration
                    continue
                tok = int(tokens[slot])
                if req.first_token_ts is None:
                    req.first_token_ts = now
                    self._observe_ttft(
                        (now - req.submitted_ts) * 1e3
                    )
                req.out.put(("tok", tok))
                req.emitted += 1
                emitted += 1
                self._positions[slot] += 1
                if tok == req.eos_token:
                    self._release_locked(int(slot), req, "stop")
                elif req.emitted >= req.max_new_tokens:
                    self._release_locked(int(slot), req, "length")
            self._tokens_emitted += emitted
            row = self._decode_by_batch.setdefault(batch, [0, 0.0])
            row[0] += 1
            row[1] += step_ms
            self._decode_launch_ms += (t_copy - t0) * 1e-6
            self._decode_wait_ms += (now_ns - t_copy) * 1e-6
        self._observe_step(step_ms, batch, emitted)
        t_emitted = time.time_ns()
        self._decode_emit_ms += (t_emitted - now_ns) * 1e-6
        flight_recorder.record_span(
            "engine", "decode.launch", t0, t_copy, step=step, batch=batch)
        flight_recorder.record_span(
            "engine", "decode.wait", t_copy, now_ns, step=step)
        flight_recorder.record_span(
            "engine", "decode.emit", now_ns, t_emitted, step=step)
        return True

    # -- metrics -------------------------------------------------------
    # All hooks are guarded no-ops on failure: observability must
    # never fail a decode (serve/observability.py owns the metric
    # definitions; the engine just reports).

    def _block_stats(self) -> Dict[str, int]:
        if self._kv is None:
            return {"kv_used": 0, "kv_total": 0, "kv_cached": 0}
        alloc = self._kv.alloc
        return {
            "kv_used": alloc.used(),
            "kv_total": alloc.capacity(),
            "kv_cached": alloc.cached(),
        }

    def _observe_step(
        self, step_ms: float, batch: int, tokens: int
    ) -> None:
        try:
            from ..serve.observability import observe_engine_step

            stats = self._sched.stats()
            observe_engine_step(
                self._tags, step_ms, batch, tokens,
                stats["slots_used"], stats["slots_total"],
                stats["waiting"], **self._block_stats(),
            )
        except Exception:
            pass

    def _observe_prefill(self, chunk_ms: float, tokens: int) -> None:
        try:
            from ..serve.observability import observe_engine_prefill

            observe_engine_prefill(self._tags, chunk_ms, tokens)
        except Exception:
            pass

    def _observe_prefix(self, skip_tokens: int) -> None:
        try:
            from ..serve.observability import observe_engine_prefix

            observe_engine_prefix(self._tags, skip_tokens)
        except Exception:
            pass

    def _observe_ttft(self, ttft_ms: float) -> None:
        try:
            from ..serve.observability import observe_engine_ttft

            observe_engine_ttft(self._tags, ttft_ms)
        except Exception:
            pass

    def _observe_finish(self, reason: str) -> None:
        try:
            from ..serve.observability import observe_engine_finish

            observe_engine_finish(self._tags, reason)
        except Exception:
            pass

    def _observe_occupancy(self) -> None:
        try:
            from ..serve.observability import (
                observe_engine_occupancy,
            )

            if self._sched is None:
                return
            stats = self._sched.stats()
            observe_engine_occupancy(
                self._tags, stats["slots_used"],
                stats["slots_total"], stats["waiting"],
                **self._block_stats(),
            )
        except Exception:
            pass

    def _observe_weights(self) -> None:
        try:
            from ..serve.observability import observe_engine_weights

            observe_engine_weights(self._tags, self._weight_version)
        except Exception:
            pass

    def _observe_policy(
        self, batch_ms: float, rows: int, bucket: int
    ) -> None:
        try:
            from ..serve.observability import observe_engine_policy

            observe_engine_policy(self._tags, batch_ms, rows, bucket)
        except Exception:
            pass
