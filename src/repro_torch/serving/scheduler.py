"""Requests and FCFS admission over paged-KV slots (port of
``repro/serving/scheduler.py`` in its ``reserve_full`` mode).

Admission reserves pages for ``prompt + max_new`` up front, so a running
request never grows and never needs preempting; a request joins the
running batch at the next megastep boundary once a slot and its pages are
free, and its pages return to the pool the step it finishes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from .kvcache import PagedKVCache, PoolExhausted

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [P] int32
    max_new: int = 16
    # stop token: generation ends the step it is emitted (kept in ``out``);
    # -1 disables
    eos_id: int = -1
    # ---- filled in by scheduler/engine ----
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0  # next kv write position (= current logical length)
    arrival_s: float = 0.0  # wall-clock submit time (TTFT anchor)

    @property
    def total_tokens(self) -> int:
        """KV entries the request can ever write (prompt + decode)."""
        return len(self.prompt) + self.max_new

    @property
    def done(self) -> bool:
        if self.eos_id >= 0 and self.out and self.out[-1] == self.eos_id:
            return True
        return len(self.out) >= self.max_new


class Scheduler:
    """Host-side bookkeeping the engine drives between megasteps."""

    def __init__(self, cache: PagedKVCache):
        self.cache = cache
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request

    def submit(self, req: Request) -> None:
        """Enqueue one request; malformed requests are refused here."""
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be ≥ 1, got {req.max_new}")
        live = {r.rid for r in self.waiting} | {r.rid for r in self.active.values()}
        if req.rid in live:
            raise ValueError(f"request {req.rid}: rid already live")
        if req.total_tokens > self.cache.max_slot_tokens():
            raise ValueError(
                f"request {req.rid}: {req.total_tokens} tokens exceed the per-slot "
                f"maximum {self.cache.max_slot_tokens()} (max_blocks_per_slot × block_size)"
            )
        if self.cache.blocks_needed(req.total_tokens) > self.cache.allocator.num_blocks:
            raise PoolExhausted(
                f"request {req.rid} needs {self.cache.blocks_needed(req.total_tokens)} "
                f"blocks but the whole pool has {self.cache.allocator.num_blocks}"
            )
        self.waiting.append(req)

    def try_admit(self) -> Optional[Request]:
        """Admit the queue head if a slot and its full page reservation fit."""
        if not self.waiting or not self.cache.can_admit(self.waiting[0].total_tokens):
            return None
        req = self.waiting.popleft()
        req.slot = self.cache.acquire_slot(req.total_tokens)
        self.active[req.slot] = req
        return req

    def finish(self, slot: int) -> Request:
        """Release a finished request's slot + pages."""
        req = self.active.pop(slot)
        self.cache.release_slot(slot)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.active)
