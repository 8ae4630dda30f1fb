"""The engine behind `ray_tpu_torch.serve`: a multiplexed, streaming LLM
deployment (PyTorch port of `ray_tpu/llm/serving.py`).

Wiring, as in the JAX package:

* replicas host `InferenceEngine`s - one engine per loaded model
  family, created through ``@serve.multiplexed`` so the router's
  model-warmth ranking and the per-replica LRU apply unchanged;
  per-family slot accounting falls out of one-engine-per-family;
* ``__call__`` is a GENERATOR, so the deployment is a streaming
  ingress: each sampled token goes out as its own chunk while the
  engine keeps decoding (proxy chunked transfer-encoding, handle
  ``options(stream=True)``);
* admission: the router/proxy queue feeds the replica; the replica
  hands the request to the engine's FIFO scheduler, which rejects
  with ``EngineOverloaded`` past its waiting bound;
* cancellation: a consumer that abandons the stream
  (`DeploymentResponseGenerator.close()`, proxy client disconnect)
  triggers `Replica.cancel_stream` -> ``__serve_cancel_stream__``
  here -> `engine.cancel` - the slot frees mid-decode instead of
  decoding to the token budget for nobody;
* kill switch: ``RT_serve_engine_enabled=0`` (or
  ``engine_enabled=False``) serves every request with a per-request
  `generate_stream()` - the serialize-per-request baseline, same
  response format.

Device: a replica computes on `device`, "cuda" unless the caller asks
for the CPU. `build_llm_app` asks one card per replica for "cuda"
(``ray_actor_options={"num_gpus": 1}``: every other worker runs with
the cards hidden), and a replica asked for the card that finds none
raises on its first request, which fails that stream: nothing falls
back to the CPU.

Request payload (HTTP body JSON or a plain dict via handle):

    {"prompt": [token ids], "max_new_tokens": 16,
     "model": "family-id" (optional; `serve_multiplexed_model_id`
      header / handle option wins), "eos_token": optional}

Response stream: one chunk per token, ASCII decimal + trailing space.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import torch

from ..serve.multiplex import get_multiplexed_model_id, multiplexed
from .engine import EngineConfig, InferenceEngine

#: Engines a single replica keeps loaded (multiplex LRU bound).
MAX_FAMILIES_PER_REPLICA = 4


def _resolve_dtype(name: Any):
    if not isinstance(name, str):
        return name
    return {
        "float32": torch.float32,
        "bfloat16": torch.bfloat16,
        "float16": torch.float16,
    }[name]


def _resolve_device(device: Any) -> torch.device:
    """`device` as a torch device; a CUDA device on a process that sees
    no card raises (a replica asked for the card never serves from the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for, but this process "
            "sees no CUDA device (a replica needs num_gpus=1)"
        )
    return device


def build_model(spec: Dict[str, Any], device: Any = "cuda"):
    """Model-family spec -> (the port's `Llama` on `device`, its
    `LlamaConfig`).

    kind "init": randomly initialized from a config dict, drawn from a
    generator on `device` seeded with the spec's seed (every HF family
    shares the Llama compute graph, so a family here is a (config,
    seed) point; one device and seed give the same weights in every
    process);
    kind "hf": a local HF checkpoint directory, converted by
    `models/hf_convert.load_hf_llama`."""
    device = _resolve_device(device)
    kind = spec.get("kind", "init")
    if kind == "hf":
        from ..models.hf_convert import load_hf_llama

        return load_hf_llama(spec["path"], device=device)
    if kind != "init":
        raise ValueError(f"unknown model spec kind {kind!r}")
    from ..models.llama import LlamaConfig, init_params

    kwargs = dict(spec.get("config") or {})
    if "dtype" in kwargs:
        kwargs["dtype"] = _resolve_dtype(kwargs["dtype"])
    kwargs.setdefault("attention", "reference")
    cfg = LlamaConfig(**kwargs)
    generator = torch.Generator(device=device).manual_seed(
        int(spec.get("seed", 0))
    )
    return init_params(cfg, generator, device=device), cfg


class LLMServer:
    """The deployment class `build_llm_app` wraps (usable directly:
    ``serve.deployment(LLMServer).bind(families, ...)``)."""

    def __init__(
        self,
        families: Dict[str, Dict[str, Any]],
        default_family: Optional[str] = None,
        engine: Optional[Dict[str, Any]] = None,
        engine_enabled: bool = True,
        device: Any = "cuda",
    ):
        if not families:
            raise ValueError("families must name at least one model")
        self._families = dict(families)
        self._default = default_family or next(iter(self._families))
        self._engine_cfg = EngineConfig(**(engine or {}))
        self._engine_enabled = bool(engine_enabled)
        self._device = str(device)
        # serve request_id -> [(engine, engine_request_id), ...] for
        # cancel_stream propagation. A LIST per id: the serve id is
        # CLIENT-controlled (x-request-id), so concurrent requests may
        # collide on it - each stream keeps its own engine-minted
        # unique id and cancel hits every stream under the serve id.
        self._streams: Dict[str, list] = {}
        # Cancels that arrived BEFORE their stream handler ran (the
        # cancel RPC can beat the streaming call through the actor
        # mailbox): serve_id -> arrival ts, consulted right after
        # submit. Entries expire; the map stays tiny.
        self._early_cancels: Dict[str, float] = {}
        self._streams_lock = threading.Lock()
        # Fallback (model, cfg) per family, behind the SAME LRU
        # machinery as engines: bounded to MAX_FAMILIES_PER_REPLICA
        # and per-family load serialization, so a cold family's load
        # never blocks warm families' requests.
        self._fallback_lock = threading.Lock()
        self._fallback_wrapper = None
        #: family -> seconds its last engine model took to build.
        self._build_s: Dict[str, float] = {}

    # -- engines -------------------------------------------------------
    @multiplexed(max_num_models_per_replica=MAX_FAMILIES_PER_REPLICA)
    def get_engine(self, family: str) -> InferenceEngine:
        """Loader the multiplex LRU calls on a cold family: builds the
        model and an engine with its OWN slots + step thread, so a
        swap (this load) blocks only requests for THIS family."""
        from ..serve.observability import current_request_context

        spec = self._spec(family)
        t0 = time.perf_counter()
        model, cfg = build_model(spec, self._device)
        if torch.device(self._device).type == "cuda":
            torch.cuda.synchronize()
        self._build_s[family] = time.perf_counter() - t0
        ctx = current_request_context() or {}
        return InferenceEngine(
            model,
            cfg,
            self._engine_cfg,
            family=family,
            app=str(ctx.get("app", "")),
            deployment=str(ctx.get("deployment", "")),
        )

    def _spec(self, family: str) -> Dict[str, Any]:
        spec = self._families.get(family)
        if spec is None:
            raise ValueError(
                f"unknown model family {family!r}; serving "
                f"{sorted(self._families)}"
            )
        return spec

    # -- request path --------------------------------------------------
    def __call__(self, request):
        """Streaming ingress: yields one chunk per sampled token."""
        payload = (
            request.json() if hasattr(request, "json") else request
        ) or {}
        family = (
            get_multiplexed_model_id()
            or str(payload.get("model") or "")
            or self._default
        )
        prompt = payload.get("prompt")
        if not prompt:
            raise ValueError("payload needs a non-empty 'prompt'")
        max_new = payload.get("max_new_tokens")
        max_new = None if max_new is None else int(max_new)
        eos = payload.get("eos_token")
        eos = None if eos is None else int(eos)
        if not self._engine_enabled:
            yield from self._serve_fallback(
                family, prompt, max_new, eos
            )
            return
        from ..serve.observability import get_request_id

        engine = self.get_engine(family)
        # The engine mints its own UNIQUE id (a client-controlled
        # x-request-id may collide); the serve id only keys the
        # cancel map.
        stream = engine.submit(
            prompt, max_new_tokens=max_new, eos_token=eos
        )
        serve_id = get_request_id()
        entry = (engine, stream.request_id)
        cancelled_early = False
        if serve_id:
            with self._streams_lock:
                self._streams.setdefault(serve_id, []).append(entry)
                # The consumer may have abandoned us before this
                # handler even ran (cancel RPC beat the streaming
                # call through the mailbox).
                cancelled_early = (
                    self._early_cancels.pop(serve_id, None)
                    is not None
                )
        if cancelled_early:
            stream.cancel()
        try:
            for token in stream:
                yield f"{token} ".encode()
        finally:
            # Abnormal generator exit (consumer gone) must not leave
            # the engine decoding the rest of the budget for nobody.
            if stream.finish_reason is None:
                stream.cancel()
            if serve_id:
                with self._streams_lock:
                    entries = self._streams.get(serve_id)
                    if entries is not None:
                        try:
                            entries.remove(entry)
                        except ValueError:
                            pass
                        if not entries:
                            self._streams.pop(serve_id, None)

    def __serve_cancel_stream__(self, request_id: str) -> bool:
        """Replica cancel hook: the consumer abandoned the stream.
        Cancels EVERY live stream under the serve request id (ids are
        client-controlled and may collide; each entry still cancels
        by its own engine-minted id). A miss is remembered briefly -
        the cancel may have outrun its own stream handler."""
        now = time.time()
        with self._streams_lock:
            entries = list(self._streams.get(request_id, ()))
            if not entries:
                self._early_cancels[request_id] = now
                # Expire stale entries so the map stays bounded even
                # under cancel floods for requests that never arrive.
                for rid, ts in list(self._early_cancels.items()):
                    if now - ts > 60.0:
                        del self._early_cancels[rid]
        cancelled = False
        for engine, engine_request_id in entries:
            cancelled = engine.cancel(engine_request_id) or cancelled
        return cancelled

    # -- fallback (kill switch) ---------------------------------------
    def _fallback_model(self, family: str):
        """(model, cfg) through the multiplex LRU wrapper - same bound
        and same per-family load serialization as the engine path."""
        wrapper = self._fallback_wrapper
        if wrapper is None:
            from ..serve.multiplex import _ModelMultiplexWrapper

            with self._fallback_lock:
                if self._fallback_wrapper is None:
                    self._fallback_wrapper = _ModelMultiplexWrapper(
                        lambda owner, fam: build_model(
                            owner._spec(fam), owner._device
                        ),
                        self,
                        MAX_FAMILIES_PER_REPLICA,
                    )
                wrapper = self._fallback_wrapper
        return wrapper.load(family)

    def _serve_fallback(self, family, prompt, max_new, eos):
        """Per-request `generate_stream` - no shared cache, no
        batching: what serving looked like before the engine, kept as
        the RT_serve_engine_enabled=0 escape hatch and the baseline."""
        from ..models.generate import generate_stream
        from .kv_slots import bucket_for

        model, cfg = self._fallback_model(family)
        ec = self._engine_cfg
        max_new = int(
            ec.max_new_tokens if max_new is None else max_new
        )
        # Same length-bucket padding as the engine, so the baseline
        # sees the same bounded set of prompt shapes.
        prompt = [int(t) for t in prompt]
        bucket = bucket_for(
            len(prompt), ec.prefill_chunk, ec.max_len
        )
        if len(prompt) + max_new > ec.max_len:
            # Same admission contract as the engine path: the kill
            # switch changes throughput, not validation semantics.
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new}) exceeds slot capacity "
                f"max_len={ec.max_len}"
            )
        padded = prompt + [0] * (bucket - len(prompt))
        for step_tokens in generate_stream(
            model,
            torch.tensor([padded], dtype=torch.int64),
            torch.tensor([len(prompt)], dtype=torch.int64),
            cfg,
            max_new_tokens=max_new,
            temperature=ec.temperature,
            top_k=ec.top_k,
            eos_token=ec.eos_token if eos is None else eos,
            # Fixed cache size, as the engine's slots.
            cache_len=ec.max_len,
        ):
            yield f"{int(step_tokens[0])} ".encode()

    # -- introspection -------------------------------------------------
    def engine_stats(self) -> Dict[str, Any]:
        """Per-loaded-family engine stats for this replica."""
        wrapper = getattr(self, "__serve_multiplex_get_engine", None)
        if wrapper is None:
            return {}
        return {
            family: engine.stats()
            for family, engine in wrapper.models().items()
        }

    def device_stats(self) -> Dict[str, Any]:
        """The replica's device, the seconds each family's engine model
        took to build, and on the card the peak of allocated memory."""
        out: Dict[str, Any] = {
            "device": self._device, "build_s": dict(self._build_s),
        }
        if torch.device(self._device).type == "cuda":
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        return out


def build_llm_app(
    families: Dict[str, Dict[str, Any]],
    *,
    default_family: Optional[str] = None,
    engine: Optional[Dict[str, Any]] = None,
    engine_enabled: Optional[bool] = None,
    num_replicas: int = 1,
    max_ongoing_requests: Optional[int] = None,
    name: str = "llm",
    device: Any = "cuda",
):
    """Bind the engine deployment. `engine_enabled=None` resolves the
    RT_serve_engine_enabled kill switch HERE (driver-side) so the
    decision ships in the replica init args instead of depending on
    worker-process environments. A "cuda" `device` asks one card for
    each replica."""
    from .._private.config import Config
    from ..serve.deployment import deployment as serve_deployment

    runtime_cfg = Config.from_env()
    if engine_enabled is None:
        engine_enabled = runtime_cfg.serve_engine_enabled
    engine = dict(engine or {})
    if "prefix_cache" not in engine:
        # Same driver-side resolution as the engine kill switch.
        engine["prefix_cache"] = bool(
            runtime_cfg.serve_prefix_cache_enabled
        )
    engine_cfg = EngineConfig(**engine)
    if max_ongoing_requests is None:
        # Streams hold a replica thread for their whole lifetime:
        # admit enough for every slot plus a queueing margin so the
        # engine's FIFO - not the actor mailbox - orders waiters.
        max_ongoing_requests = engine_cfg.slots * 4
    on_card = torch.device(device).type == "cuda"
    dep = serve_deployment(
        name=name,
        num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options={"num_gpus": 1} if on_card else None,
    )(LLMServer)
    return dep.bind(
        dict(families),
        default_family=default_family,
        engine=dict(engine or {}),
        engine_enabled=bool(engine_enabled),
        device=str(device),
    )
