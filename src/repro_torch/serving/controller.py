"""Declarative resource controller: observe → target → plan → converge
(port of ``repro/serving/controller.py``).

One controller owns the serving stack's resource pools: request slots
(:mod:`.scheduler`), KV pages and prefix-cache pages (:mod:`.kvcache`), and
resident expert partitions (an offload manager, once the port has one).
Each megastep boundary it

(a) **observes** a consistent snapshot (queue composition per tenant, slot
    occupancy, free and reclaimable pages, the prefix cache's LRU order),
(b) computes a declarative **target state** (which requests hold slots,
    how many pages each may hold), and
(c) emits a **bounded plan** of convergence actions (admit / preempt /
    grow / evict-prefix / shed / upload-experts) that the engine executes
    in order.

**Exactness.** Planning simulates page accounting on a :class:`_PageLedger`
that mirrors :class:`~.kvcache.BlockAllocator` and
:class:`~.kvcache.PrefixCache` exactly (refcounts, LRU eviction order,
reclaimability = drop count == refcount, copy-on-write admission math), so
a planned admission never fails at execution under single-threaded
stepping; execution still re-validates each one against the live pool
(:meth:`Scheduler.admit_planned`).

Which waiter admits first and who is victimized is the scheduler's policy
(``admission_order`` / ``victim_key``). Under full reservation no active
slot ever lacks pages, so phase 1 plans no ``grow`` or ``preempt``; phase 3
plans nothing without an offload manager. The plan itself is visible as one
``plan`` lifecycle event per non-empty boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .scheduler import Request, Scheduler

__all__ = ["PlanAction", "Observation", "TargetState", "ResourceController"]


@dataclasses.dataclass(frozen=True)
class PlanAction:
    """One convergence step. ``kind`` ∈ {admit, preempt, grow,
    evict_prefix, shed, upload_experts}; the other fields are
    kind-specific."""

    kind: str
    rid: int = -1            # admit/shed: the request; preempt: the victim
    slot: int = -1           # preempt/grow: the slot acted on
    tenant: str = ""         # admit/preempt/shed: the request's tenant
    pages: int = 0           # grow: pages to append; evict_prefix: free target
    protect: Tuple[int, ...] = ()  # evict_prefix: pages the admission shares
    for_rid: int = -1        # preempt: the grower the freed pages serve
    for_tenant: str = ""     # preempt: that grower's tenant
    waited_steps: int = 0    # shed: logical steps the request waited
    uploads: int = 0         # upload_experts: (layer, bucket) groups touched
    targets: Tuple = ()      # upload_experts: ((bucket, layer, desired…), …)


@dataclasses.dataclass(frozen=True)
class _PrefixSnap:
    """Read-only planning view of one prefix-cache entry."""

    key: bytes
    pages: Tuple[int, ...]
    n_tokens: int
    has_logits: bool


@dataclasses.dataclass(frozen=True)
class Observation:
    """Consistent snapshot of observed state at a megastep boundary."""

    step_idx: int
    now_s: float
    free_pages: int
    free_slot_count: int
    refcounts: Dict[int, int]                 # allocated page → holders
    slot_pages: Dict[int, Tuple[int, ...]]    # live slot → its pages
    prefix_entries: Tuple[_PrefixSnap, ...]   # LRU order, oldest first
    active: Tuple[Tuple[int, Request], ...]   # (slot, req), admit_seq order
    waiting: Tuple[Request, ...]              # policy admission order
    tenants: Dict[str, Dict[str, int]]        # tenant → queue composition
    deficits: Dict[str, float]                # tenant → WDRR deficit
    # injected transient page-pool exhaustion (``pool`` fault site):
    # admission behaves as if this many free pages were unavailable.
    # Planning-only — held pages are real and growth is untouched, so
    # the penalty defers admissions (output-invariant by the
    # batch-composition-independence contract) without ever invalidating
    # the ledger's exactness for pages the pool actually holds.
    pool_penalty: int = 0


@dataclasses.dataclass(frozen=True)
class TargetState:
    """The declarative target the plan converges toward."""

    hold_slots: Tuple[int, ...]       # rids that hold a slot after converge
    page_targets: Dict[int, int]      # rid → total pages it may hold
    admit_rids: Tuple[int, ...]       # waiters that should gain a slot
    shed_rids: Tuple[int, ...]        # waiters past their TTFT budget
    victim_rids: Tuple[int, ...]      # actives that should yield their slot
    expert_targets: Tuple = ()        # ((bucket, layer, desired…), …)


class _PageLedger:
    """Pure page-accounting simulation over an :class:`Observation`.

    Mirrors :class:`~.kvcache.BlockAllocator` refcount semantics and
    :class:`~.kvcache.PrefixCache` LRU eviction / reclaimability
    *exactly*, so the planner can pre-play evict/preempt/grow/admit
    sequences and know what the real pools will do at execution time.
    Pages granted by planned grows have no physical identity yet; they
    are tracked as per-slot fresh counts (refcount 1 by construction —
    a grown page is never shared until prefill registers it, which
    happens after the plan window closes).
    """

    def __init__(self, obs: Observation, block_size: int):
        self.block_size = block_size
        self.free = obs.free_pages
        self.ref: Dict[int, int] = dict(obs.refcounts)
        self.slot_pages: Dict[int, List[int]] = {
            s: list(p) for s, p in obs.slot_pages.items()
        }
        self.slot_fresh: Dict[int, int] = {}
        self.free_slots = obs.free_slot_count
        self.entries: List[dict] = [
            {
                "key": e.key,
                "pages": tuple(e.pages),
                "n_tokens": e.n_tokens,
                "has_logits": e.has_logits,
                "alive": True,
            }
            for e in obs.prefix_entries
        ]
        self._by_key = {e["key"]: e for e in self.entries}

    # ------------------------------------------------------ allocator ops
    def _drop_ref(self, pg: int) -> None:
        self.ref[pg] -= 1
        if self.ref[pg] == 0:
            del self.ref[pg]
            self.free += 1

    def _evict_entry(self, ent: dict) -> None:
        ent["alive"] = False
        for pg in ent["pages"]:
            self._drop_ref(pg)

    def reclaimable(self, protect: frozenset = frozenset()) -> int:
        drop: Dict[int, int] = {}
        for ent in self.entries:
            if not ent["alive"]:
                continue
            if protect and not protect.isdisjoint(ent["pages"]):
                continue
            for pg in ent["pages"]:
                drop[pg] = drop.get(pg, 0) + 1
        return sum(1 for pg, d in drop.items() if d == self.ref.get(pg, 0))

    def available(self, protect: frozenset = frozenset()) -> int:
        return self.free + self.reclaimable(protect)

    def evict_for(self, n: int, protect: frozenset = frozenset()) -> int:
        """LRU eviction until ``n`` pages are free (or nothing evictable
        remains) — byte-for-byte the :meth:`PrefixCache.evict_for` walk."""
        evicted = 0
        while self.free < n:
            victim = None
            for ent in self.entries:  # LRU order, oldest first
                if ent["alive"] and (
                    not protect or protect.isdisjoint(ent["pages"])
                ):
                    victim = ent
                    break
            if victim is None:
                break
            self._evict_entry(victim)
            evicted += 1
        return evicted

    # -------------------------------------------------------- slot ops
    def preempt(self, slot: int) -> None:
        """Victim's pages free by refcount (shared prefix pages survive
        as cache holds); planned-grow fresh pages return outright."""
        for pg in self.slot_pages.pop(slot, []):
            self._drop_ref(pg)
        self.free += self.slot_fresh.pop(slot, 0)
        self.free_slots += 1

    def grow(self, slot: int, n: int) -> None:
        self.evict_for(n)
        assert self.free >= n, "planner grow after evict_for must fit"
        self.free -= n
        self.slot_fresh[slot] = self.slot_fresh.get(slot, 0) + n

    def admit(self, fresh_pages: int, shared: Tuple[int, ...]) -> None:
        """Caller ran :meth:`evict_for` (with the admission's protect
        set) first; mirrors ``acquire_slot``: fresh pages allocate,
        shared prefix pages gain one reference."""
        assert self.free >= fresh_pages, "planner admit after evict_for"
        self.free -= fresh_pages
        for pg in shared:
            self.ref[pg] = self.ref.get(pg, 0) + 1
        self.free_slots -= 1

    # ------------------------------------------------------ prefix peek
    def peek_prefix(self, prompt: np.ndarray) -> Optional[dict]:
        """Non-mutating twin of :meth:`PrefixCache.lookup` over the
        *surviving* (non-evicted-in-plan) entries, including the
        full-hit-without-logits demotion to ``prompt[:-1]``."""
        ent = self._probe(prompt)
        if (
            ent is not None
            and ent["n_tokens"] == len(prompt)
            and not ent["has_logits"]
        ):
            ent = self._probe(prompt[: len(prompt) - 1])
        return ent

    def _probe(self, prompt: np.ndarray) -> Optional[dict]:
        prompt = np.ascontiguousarray(prompt, np.int32)
        p = len(prompt)
        bs = self.block_size
        probes = [p] + [j * bs for j in range(p // bs, 0, -1) if j * bs != p]
        for n in probes:
            ent = self._by_key.get(prompt[:n].tobytes())
            if ent is not None and ent["alive"]:
                return ent
        return None


class ResourceController:
    """The reconciliation loop over slots, pages, and resident experts.

    ``plan_boundary(step_idx, now_s)`` = observe → reconcile → plan; the
    engine executes the returned actions in order and then runs the
    megastep. Policy ordering lives in the scheduler; page math in the
    ledger; expert targets in ``offload.residency_targets()`` (pure).
    """

    def __init__(self, scheduler: Scheduler, offload=None, tracer=None,
                 *, ttft_budget_steps: Optional[int] = None,
                 ttft_budget_s: Optional[float] = None, faults=None):
        if ttft_budget_steps is not None and ttft_budget_steps < 0:
            raise ValueError("ttft_budget_steps must be ≥ 0")
        if ttft_budget_s is not None and ttft_budget_s < 0:
            raise ValueError("ttft_budget_s must be ≥ 0")
        if tracer is None:
            from .trace import NULL_TRACER

            tracer = NULL_TRACER
        self.scheduler = scheduler
        self.cache = scheduler.cache
        self.offload = offload
        self.tracer = tracer
        self.ttft_budget_steps = ttft_budget_steps
        self.ttft_budget_s = ttft_budget_s
        self.faults = faults
        self.last_pool_penalty = 0

    # ---------------------------------------------------------- observe
    def observe(self, step_idx: int, now_s: float = 0.0) -> Observation:
        cache, sched = self.cache, self.scheduler
        refcounts = {
            pg: cache.allocator.refcount(pg) for pg in cache.allocator.allocated
        }
        prefix_entries: Tuple[_PrefixSnap, ...] = ()
        if cache.prefix is not None:
            prefix_entries = tuple(
                _PrefixSnap(
                    key=e.key,
                    pages=tuple(e.pages),
                    n_tokens=e.n_tokens,
                    has_logits=e.last_logits is not None,
                )
                for e in cache.prefix.snapshot()
            )
        active = tuple(
            sorted(sched.active.items(), key=lambda kv: kv[1].admit_seq)
        )
        waiting = tuple(sched.admission_order())
        tenants: Dict[str, Dict[str, int]] = {}
        for r in sched.waiting:
            t = tenants.setdefault(
                r.tenant, {"waiting": 0, "active": 0, "queued_tokens": 0}
            )
            t["waiting"] += 1
            t["queued_tokens"] += r.total_tokens
        for r in sched.active.values():
            t = tenants.setdefault(
                r.tenant, {"waiting": 0, "active": 0, "queued_tokens": 0}
            )
            t["active"] += 1
        pool_penalty = 0
        if self.faults is not None:
            spec = self.faults.fire("pool")
            if spec is not None:
                pool_penalty = max(0, int(spec.arg))
                self.tracer.lifecycle(
                    "fault", track="pool", site="pool", mode=spec.mode,
                    pages=pool_penalty, step=step_idx,
                )
        # the engine's thrash circuit-breaker consults this: an injected
        # penalty makes "nothing admitted though the queue has work" a
        # legitimate *transient* state, not a livelock
        self.last_pool_penalty = pool_penalty
        return Observation(
            step_idx=step_idx,
            now_s=now_s,
            free_pages=cache.allocator.num_free,
            free_slot_count=len(cache.free_slots),
            refcounts=refcounts,
            slot_pages={
                s: tuple(p) for s, p in cache.slot_blocks.items()
            },
            prefix_entries=prefix_entries,
            active=active,
            waiting=waiting,
            tenants=tenants,
            deficits=sched.deficits(),
            pool_penalty=pool_penalty,
        )

    # -------------------------------------------------------- reconcile
    def _overdue(self, req: Request, obs: Observation) -> bool:
        """Past its TTFT budget? (shed-eligible iff also fresh)"""
        if self.ttft_budget_steps is not None:
            if obs.step_idx - req.submit_step > self.ttft_budget_steps:
                return True
        if self.ttft_budget_s is not None:
            if obs.now_s - req.arrival_s > self.ttft_budget_s:
                return True
        return False

    def reconcile(self, obs: Observation) -> Tuple[TargetState, List[PlanAction]]:
        """Diff observed state against the policy's desires; return the
        target plus the ordered convergence plan. Pure over ``obs`` and
        the ledger — no pool is touched here."""
        sched = self.scheduler
        cache = self.cache
        ledger = _PageLedger(obs, cache.block_size)
        actions: List[PlanAction] = []
        horizon = sched.horizon

        # ---- phase 1: page convergence for surviving actives ----------
        # Oldest-admitted first (the historical _ensure_pages walk).
        # A slot that cannot get its next-megastep pages triggers policy-
        # ordered preemption; the grower may victimize itself, in which
        # case it yields instead of growing.
        alive: Dict[int, Request] = {s: r for s, r in obs.active}
        victims: List[Request] = []
        page_targets: Dict[int, int] = {}
        for slot, req in obs.active:
            if slot not in alive:
                continue
            need = cache.slot_deficit(
                slot, req.pos + req.next_decode_writes(horizon)
            )
            page_targets[req.rid] = len(ledger.slot_pages.get(slot, ())) + max(need, 0)
            if need <= 0:
                continue
            while ledger.available() < need and slot in alive:
                vslot = max(
                    alive, key=lambda s: sched.victim_key(alive[s])
                )
                vreq = alive.pop(vslot)
                victims.append(vreq)
                actions.append(PlanAction(
                    kind="preempt", rid=vreq.rid, slot=vslot,
                    tenant=vreq.tenant, for_rid=req.rid,
                    for_tenant=req.tenant,
                ))
                ledger.preempt(vslot)
            if slot not in alive:
                continue  # self-preempted: the pages go back to the pool
            if ledger.free < need and ledger.reclaimable() > 0:
                actions.append(PlanAction(
                    kind="evict_prefix", pages=need, for_rid=req.rid,
                ))
            ledger.grow(slot, need)
            actions.append(PlanAction(
                kind="grow", rid=req.rid, slot=slot, tenant=req.tenant,
                pages=need,
            ))

        # ---- phase 2: admission + SLO shed over the policy order ------
        # Candidates are the boundary's *observed* waiters (requests the
        # plan itself preempts re-queue at the head but sit out until the
        # next boundary, matching the historical admit-before-grow
        # timing). Strict order: a waiter that fits admits; an overdue
        # fresh waiter that cannot admit is shed; the first blocked
        # non-sheddable waiter ends *admission* (no out-of-order
        # admission within a policy's order — FCFS stays FCFS), but the
        # shed scan continues past it: a blocked head must not let
        # overdue waiters behind it queue unboundedly.
        admits: List[Request] = []
        sheds: List[Request] = []
        admitting = True
        for req in obs.waiting:
            fits = False
            if admitting:
                entry = None
                if cache.prefix is not None and Scheduler._is_fresh(req):
                    entry = ledger.peek_prefix(req.prompt)
                tokens = sched.admit_tokens(req)
                n = cache.blocks_needed(tokens)
                shared = (
                    entry["n_tokens"] // cache.block_size
                    if entry is not None else 0
                )
                fresh_pages = n - shared
                protect = (
                    frozenset(entry["pages"]) if entry is not None
                    else frozenset()
                )
                fits = (
                    ledger.free_slots > 0
                    and n <= cache.max_blocks_per_slot
                    # pool_penalty: injected transient exhaustion defers
                    # admission this boundary (planning-only, see
                    # Observation)
                    and fresh_pages <= ledger.available(protect)
                    - obs.pool_penalty
                )
            if fits:
                if ledger.free < fresh_pages:
                    actions.append(PlanAction(
                        kind="evict_prefix", pages=fresh_pages,
                        protect=tuple(sorted(protect)), for_rid=req.rid,
                    ))
                ledger.evict_for(fresh_pages, protect)
                shared_pages = (
                    entry["pages"][:shared] if entry is not None else ()
                )
                ledger.admit(fresh_pages, tuple(shared_pages))
                admits.append(req)
                page_targets[req.rid] = n
                actions.append(PlanAction(
                    kind="admit", rid=req.rid, tenant=req.tenant,
                ))
            elif Scheduler._is_fresh(req) and self._overdue(req, obs):
                sheds.append(req)
                actions.append(PlanAction(
                    kind="shed", rid=req.rid, tenant=req.tenant,
                    waited_steps=obs.step_idx - req.submit_step,
                ))
            else:
                admitting = False

        # ---- phase 3: expert residency convergence --------------------
        expert_targets: Tuple = ()
        if self.offload is not None:
            expert_targets = tuple(self.offload.residency_targets())
            if expert_targets:
                actions.append(PlanAction(
                    kind="upload_experts",
                    uploads=len(expert_targets),
                    targets=expert_targets,
                ))

        victim_rids = tuple(r.rid for r in victims)
        target = TargetState(
            hold_slots=tuple(
                r.rid for _, r in obs.active if r.rid not in set(victim_rids)
            ) + tuple(r.rid for r in admits),
            page_targets=page_targets,
            admit_rids=tuple(r.rid for r in admits),
            shed_rids=tuple(r.rid for r in sheds),
            victim_rids=victim_rids,
            expert_targets=expert_targets,
        )
        return target, actions

    # ------------------------------------------------------------- plan
    def plan_boundary(self, step_idx: int, now_s: float = 0.0) -> List[PlanAction]:
        """One full reconciliation pass: refresh fairness grants,
        observe, reconcile, emit the ``plan`` lifecycle event (scalar
        action counts), and hand the ordered plan to the engine."""
        self.scheduler.refresh_grants()
        if self.offload is not None:
            # housekeeping before observing residency: drop prefetch-
            # backoff entries for rows that degraded or became resident
            # meanwhile, so the deferral map stays bounded
            self.offload.prune_backoff()
        obs = self.observe(step_idx, now_s)
        _, actions = self.reconcile(obs)
        if actions:
            counts: Dict[str, int] = {}
            for a in actions:
                counts[a.kind] = counts.get(a.kind, 0) + 1
            self.tracer.lifecycle(
                "plan", track="pool", step=step_idx,
                actions=len(actions),
                admits=counts.get("admit", 0),
                preempts=counts.get("preempt", 0),
                grows=counts.get("grow", 0),
                prefix_evictions=counts.get("evict_prefix", 0),
                sheds=counts.get("shed", 0),
                expert_uploads=counts.get("upload_experts", 0),
            )
        return actions
