"""Paged continuous-batching serving for the port (slice 1: FCFS,
reserve-full admission, chunked prefill, H-step greedy megasteps)."""
from .engine import EngineConfig, PagedServingEngine
from .kvcache import BlockAllocator, PagedKVCache, PoolExhausted
from .scheduler import Request, Scheduler

__all__ = [
    "BlockAllocator", "EngineConfig", "PagedKVCache", "PagedServingEngine",
    "PoolExhausted", "Request", "Scheduler",
]
