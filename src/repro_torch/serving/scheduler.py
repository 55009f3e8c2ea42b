"""Requests and FCFS admission over paged-KV slots (port of
``repro/serving/scheduler.py`` in its ``reserve_full`` mode).

Admission reserves pages for ``prompt + max_new`` up front, so a running
request never grows and never needs preempting; a request joins the
running batch at the next megastep boundary once a slot and its pages are
free, and its pages return to the pool the step it finishes. With the
prefix cache on, admission first probes it and shares the match's pages
copy-on-write, so both the page bill and the prefill shrink to the
uncached suffix (the reference's ``admit_planned``, which FCFS with full
reservation reduces to head-of-queue admission).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from .kvcache import PagedKVCache, PoolExhausted, PrefixEntry

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
    # prompt tokens whose KV a prefix-cache hit already holds (prefill
    # starts here), and the cached final-token logits of a full hit
    cached_tokens: int = 0
    cached_logits: Optional[torch.Tensor] = None

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

    def peek_prefix(self, req: Request) -> Optional[PrefixEntry]:
        """Prefix-cache probe for a fresh request. A full-prompt hit without
        cached logits is demoted to ``prompt[:-1]``: at least one token must
        go through prefill to give first-token logits, and its KV write must
        land on a private page."""
        if req.pos != 0 or req.out:
            return None
        entry = self.cache.prefix_lookup(req.prompt)
        if (entry is not None and entry.n_tokens == len(req.prompt)
                and entry.last_logits is None):
            entry = self.cache.prefix_lookup(req.prompt[:-1])
        return entry

    def try_admit(self) -> Optional[Request]:
        """Admit the queue head if a slot and its full page reservation fit,
        sharing a cached prefix's pages when the probe hits."""
        if not self.waiting:
            return None
        req = self.waiting[0]
        entry = self.peek_prefix(req)
        if not self.cache.can_admit(req.total_tokens, prefix_entry=entry):
            return None
        self.waiting.popleft()
        req.slot = self.cache.acquire_slot(req.total_tokens, prefix_entry=entry)
        if entry is not None:
            req.cached_tokens = entry.n_tokens
            req.cached_logits = (entry.last_logits if entry.n_tokens == len(req.prompt)
                                 else None)
        self.active[req.slot] = req
        return req

    def finish(self, slot: int) -> Request:
        """Release a finished request's slot + pages."""
        req = self.active.pop(slot)
        self.cache.release_slot(slot)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.active)
