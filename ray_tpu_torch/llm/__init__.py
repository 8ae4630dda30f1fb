"""LLM inference of the PyTorch/CUDA port (counterpart of `ray_tpu/llm`):
the continuous-batching engine (engine.py) over a paged KV cache with
prefix reuse (kv_slots.py), fed by a FIFO slot scheduler gated on block
availability (scheduler.py); serving.py wires it behind
`ray_tpu_torch.serve` as a multiplexed streaming deployment
(`build_llm_app`), on the card unless the caller asks for the CPU."""

from .engine import (
    BatchProgram,
    EngineConfig,
    EngineDead,
    EngineOverloaded,
    InferenceEngine,
    PolicyTicket,
    TokenStream,
)
from .kv_slots import BlockAllocator, BlocksExhausted, PagedKVCache
from .scheduler import SlotScheduler
from .serving import LLMServer, build_llm_app

__all__ = [
    "BatchProgram",
    "BlockAllocator",
    "BlocksExhausted",
    "EngineConfig",
    "EngineDead",
    "EngineOverloaded",
    "InferenceEngine",
    "LLMServer",
    "PagedKVCache",
    "PolicyTicket",
    "SlotScheduler",
    "TokenStream",
    "build_llm_app",
]
