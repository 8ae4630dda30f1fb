"""LLM inference of the PyTorch/CUDA port (counterpart of `ray_tpu/llm`):
the continuous-batching engine (engine.py) over a paged KV cache with
prefix reuse (kv_slots.py), fed by a FIFO slot scheduler gated on block
availability (scheduler.py). The serve deployment (`ray_tpu/llm/
serving.py`) is not ported yet: it needs the serve runtime."""

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

__all__ = [
    "BatchProgram",
    "BlockAllocator",
    "BlocksExhausted",
    "EngineConfig",
    "EngineDead",
    "EngineOverloaded",
    "InferenceEngine",
    "PagedKVCache",
    "PolicyTicket",
    "SlotScheduler",
    "TokenStream",
]
