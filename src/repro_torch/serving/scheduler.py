"""Requests, tenant policies and admission over paged-KV slots (port of
``repro/serving/scheduler.py`` in its ``reserve_full`` mode).

Admission reserves pages for ``prompt + max_new`` up front, so a running
request never grows and never needs preempting; a request joins the running
batch at the next megastep boundary once a slot and its pages are free, and
its pages return to the pool the step it finishes. With the prefix cache
on, admission first probes it and shares the match's pages copy-on-write,
so both the page bill and the prefill shrink to the uncached suffix.

**Tenant-aware policy.** Every request carries a ``tenant`` label and an
integer ``priority`` class (higher = more urgent). The
:class:`~repro_torch.serving.controller.ResourceController` admits in the
order :meth:`Scheduler.admission_order` gives:

* ``fcfs`` — queue order; tenant and priority are recorded but ignored.
* ``priority`` — higher classes first, FCFS within a class.
* ``fair`` — ``priority`` refined by a weighted deficit round-robin over
  decode-token grants: each megastep boundary every backlogged tenant earns
  ``weight × horizon`` tokens of credit, emitted tokens debit it, and among
  equal-priority waiters the tenant with the largest deficit admits first.

Policies only reorder *when* requests run; each request's greedy tokens do
not depend on them.

**SLO shed.** With a TTFT budget configured, a fresh request that cannot be
admitted at a boundary and has waited past the budget is shed (removed
from the queue with an empty output) instead of queueing unboundedly.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from .faults import InvalidRequest
from .kvcache import PagedKVCache, PoolExhausted, PrefixEntry
from .trace import NULL_TRACER

__all__ = ["Request", "Scheduler", "VALID_POLICIES"]

#: scheduling policies accepted by :class:`Scheduler` / ``EngineConfig``
VALID_POLICIES = ("fcfs", "priority", "fair")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [P] int32
    max_new: int = 16
    # stop token: generation ends the step it is emitted (kept in ``out``);
    # -1 disables
    eos_id: int = -1
    # ---- multi-tenant policy (ignored under policy="fcfs") ----
    tenant: str = "default"
    priority: int = 0  # higher = more urgent
    # the request must finish within this many logical steps of submission
    # or it ends with DeadlineExceeded (None = no deadline)
    deadline_steps: Optional[int] = None
    # ---- filled in by scheduler/engine ----
    out: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0  # next kv write position (= current logical length)
    submit_step: int = -1
    admit_step: int = -1
    admit_seq: int = -1  # monotone admission counter (victim ordering)
    shed_step: int = -1  # step the request was SLO-shed at (-1: not shed)
    preempt_count: int = 0
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
    def context_tokens(self) -> int:
        """KV entries needed at admission: the prompt for a fresh request,
        the generated-so-far context for one that already ran."""
        return self.pos if self.pos > 0 else len(self.prompt)

    @property
    def done(self) -> bool:
        if self.eos_id >= 0 and self.out and self.out[-1] == self.eos_id:
            return True
        return len(self.out) >= self.max_new

    def next_decode_writes(self, horizon: int) -> int:
        """KV writes the next megastep performs for this request: one per
        emitted token, capped by the horizon and the remaining budget
        (counted from after the prefill token; at least 1)."""
        budget = self.max_new - max(len(self.out), 1)
        return max(1, min(horizon, budget))


class Scheduler:
    """Host-side bookkeeping the engine drives between megasteps."""

    def __init__(self, cache: PagedKVCache, *, horizon: int = 1, tracer=None,
                 policy: str = "fcfs", tenant_weights: Optional[Dict[str, float]] = None):
        if horizon < 1:
            raise ValueError(f"horizon must be ≥ 1, got {horizon}")
        if policy not in VALID_POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of {VALID_POLICIES}")
        if tenant_weights is not None:
            for t, w in tenant_weights.items():
                if w <= 0:
                    raise ValueError(f"tenant weight for {t!r} must be > 0, got {w}")
        self.cache = cache
        self.horizon = horizon
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.policy = policy
        self.tenant_weights = dict(tenant_weights or {})
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self._admit_seq = 0
        # WDRR deficits (policy="fair"): tenant -> decode-token credit, kept
        # for backlogged tenants only (an idle tenant banks nothing)
        self._deficit: Dict[str, float] = {}

    # ---------------------------------------------------------- queue
    def submit(self, req: Request, step_idx: int = 0) -> None:
        """Enqueue one request; malformed requests are refused here with
        :class:`InvalidRequest` (also a ``ValueError``)."""
        if len(req.prompt) == 0:
            raise InvalidRequest(f"request {req.rid}: empty prompt", rid=req.rid)
        if req.max_new < 1:
            raise InvalidRequest(f"request {req.rid}: max_new must be ≥ 1, got {req.max_new}",
                                 rid=req.rid)
        if req.priority < 0:
            raise InvalidRequest(f"request {req.rid}: negative priority {req.priority}",
                                 rid=req.rid)
        if req.deadline_steps is not None and req.deadline_steps < 1:
            raise InvalidRequest(
                f"request {req.rid}: deadline_steps must be ≥ 1, got {req.deadline_steps}",
                rid=req.rid)
        live = {r.rid for r in self.waiting} | {r.rid for r in self.active.values()}
        if req.rid in live:
            raise InvalidRequest(f"request {req.rid}: rid already live", rid=req.rid)
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
        req.submit_step = step_idx
        self.waiting.append(req)
        self.tracer.instant(
            "enqueue", track="queue", cat="lifecycle", rid=req.rid, step=step_idx,
            prompt_tokens=len(req.prompt), max_new=req.max_new, queue_depth=len(self.waiting),
        )
        self.tracer.flow("s", req.rid, track="queue")

    def growth_reserve(self) -> int:
        """Pages the actives need for their next megastep's KV writes;
        admission leaves them untouched (0 under full reservation)."""
        return sum(self.cache.slot_deficit(slot, req.pos + req.next_decode_writes(self.horizon))
                   for slot, req in self.active.items())

    # ------------------------------------------------- policy ordering
    def admission_order(self) -> List[Request]:
        """Waiting requests in the order the controller considers them this
        boundary (``sorted`` is stable, so equal keys keep FCFS)."""
        waiting = list(self.waiting)
        if self.policy == "fcfs":
            return waiting
        if self.policy == "priority":
            return sorted(waiting, key=lambda r: -r.priority)
        return sorted(waiting, key=lambda r: (-r.priority, -self._deficit.get(r.tenant, 0.0)))

    def refresh_grants(self) -> None:
        """WDRR grant refresh, once per megastep boundary: every backlogged
        tenant earns ``weight × horizon`` credit, clamped to ``8 × weight ×
        horizon``; idle tenants are dropped."""
        if self.policy != "fair":
            return
        backlogged = {r.tenant for r in self.waiting}
        backlogged.update(r.tenant for r in self.active.values())
        quantum = float(self.horizon)
        for t in sorted(backlogged):
            w = self.tenant_weights.get(t, 1.0)
            d = self._deficit.get(t, 0.0) + w * quantum
            self._deficit[t] = min(d, 8.0 * w * quantum)
        for t in list(self._deficit):
            if t not in backlogged:
                del self._deficit[t]

    def note_tokens(self, tenant: str, n: int) -> None:
        """Debit ``n`` emitted decode tokens against a tenant's grant."""
        if self.policy != "fair" or n <= 0:
            return
        if tenant in self._deficit:
            self._deficit[tenant] -= float(n)

    def deficits(self) -> Dict[str, float]:
        """Snapshot of per-tenant WDRR deficits."""
        return dict(self._deficit)

    # ------------------------------------------------------- admission
    @staticmethod
    def _is_fresh(req: Request) -> bool:
        """Never admitted: no KV context and no output."""
        return req.pos == 0 and not req.out

    def peek_prefix(self, req: Request) -> Optional[PrefixEntry]:
        """Prefix-cache probe for a fresh request. A full-prompt hit without
        cached logits is demoted to ``prompt[:-1]``: at least one token must
        go through prefill to give first-token logits, and its KV write must
        land on a private page. Refreshes the cache's LRU order."""
        if not self._is_fresh(req):
            return None
        entry = self.cache.prefix_lookup(req.prompt)
        if (entry is not None and entry.n_tokens == len(req.prompt)
                and entry.last_logits is None):
            entry = self.cache.prefix_lookup(req.prompt[:-1])
        return entry

    @staticmethod
    def admit_tokens(req: Request) -> int:
        """KV entries an admission reserves pages for: ``prompt + max_new``
        (full reservation)."""
        return req.total_tokens

    def admit_planned(self, req: Request, step_idx: int) -> Optional[Request]:
        """Admit a specific waiting request (controller plan execution),
        re-validated against the live pool; ``None`` if it no longer fits
        (the plan step is dropped and the request stays queued). A fresh
        request shares a cached prefix's pages when the probe hits."""
        entry = self.peek_prefix(req)
        tokens = self.admit_tokens(req)
        if not self.cache.can_admit(tokens, headroom=self.growth_reserve(), prefix_entry=entry):
            return None
        self.waiting.remove(req)
        req.slot = self.cache.acquire_slot(tokens, prefix_entry=entry, rid=req.rid)
        if entry is not None:
            req.cached_tokens = entry.n_tokens
            req.cached_logits = (entry.last_logits if entry.n_tokens == len(req.prompt)
                                 else None)
        req.admit_step = step_idx
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.active[req.slot] = req
        return req

    def try_admit(self, step_idx: int = 0) -> Optional[Request]:
        """Head-of-queue admission (what controller plans reduce to under
        ``fcfs``; kept for direct callers and tests)."""
        if not self.waiting:
            return None
        return self.admit_planned(self.waiting[0], step_idx)

    def shed(self, req: Request, step_idx: int) -> Request:
        """SLO load-shed: remove a fresh waiting request from the queue (the
        caller emits the ``shed`` lifecycle event and the empty result)."""
        if not self._is_fresh(req):
            raise ValueError(f"request {req.rid}: only fresh requests shed")
        self.waiting.remove(req)
        req.shed_step = step_idx
        return req

    # ------------------------------------------------------- preemption
    def victim_key(self, req: Request):
        """Victim ordering (``max`` over actives picks the victim): the
        youngest admission under ``fcfs``; the lowest priority class first,
        youngest within it, under ``priority`` and ``fair``."""
        if self.policy == "fcfs":
            return (0, req.admit_seq)
        return (-req.priority, req.admit_seq)

    def finish(self, slot: int) -> Request:
        """Release a finished request's slot + pages."""
        req = self.active.pop(slot)
        self.cache.release_slot(slot)
        return req

    def cancel_release(self, req: Request) -> None:
        """Release everything a cancelled or failed request holds, wherever
        it is: an active slot's pages (shared prefix pages drop one hold), a
        queue entry and any prefix-admission state. Safe on a request that
        holds nothing."""
        if req.slot >= 0 and self.active.get(req.slot) is req:
            self.active.pop(req.slot)
            self.cache.release_slot(req.slot)
        req.slot = -1
        try:
            self.waiting.remove(req)
        except ValueError:
            pass
        req.cached_tokens = 0
        req.cached_logits = None

    # ---------------------------------------------------------- state
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.active)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)
