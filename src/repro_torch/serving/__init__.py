"""Paged continuous-batching serving for the port: FCFS, reserve-full
admission, chunked prefill, H-step greedy megasteps, fp or int8 KV pools and
the copy-on-write shared-prefix cache."""
from .engine import EngineConfig, PagedServingEngine, quantized_greedy_reference
from .kvcache import BlockAllocator, PagedKVCache, PoolExhausted, PrefixCache, PrefixEntry
from .scheduler import Request, Scheduler

__all__ = [
    "BlockAllocator", "EngineConfig", "PagedKVCache", "PagedServingEngine",
    "PoolExhausted", "PrefixCache", "PrefixEntry", "Request", "Scheduler",
    "quantized_greedy_reference",
]
