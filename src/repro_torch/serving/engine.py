"""Continuous-batching engine over the paged KV pool (port of
``repro/serving/engine.py``).

* **prefill** — an admitted request's prompt streams through
  :func:`paged_prefill_chunk` in fixed-size chunks, writing K/V straight
  into its pages; the last chunk's logits give the first token (TTFT).
* **decode megastep** — every slot advances up to ``decode_horizon``
  tokens through :func:`paged_decode_horizon`: greedy argmax on the device
  feeds each step's token into the next, per-slot stop logic rides the
  carried ``active`` mask, and the host fetches the ``[H, slots]`` token
  matrix, emit mask, activations and dispatch counts in one transfer per
  megastep.

**Control plane.** Each megastep boundary (:meth:`PagedServingEngine.step`)
advances the :class:`~.faults.FaultPlan`'s logical step, applies pending
cancellations and expired deadlines, and asks the
:class:`~.controller.ResourceController` for a plan: it observes the pools,
orders the waiters by the scheduler's policy (``fcfs``, ``priority`` or
``fair``) and plans admissions, prefix evictions and SLO sheds, which this
engine executes. Every lifecycle fact flows through the
:class:`~.trace.SpanTracer` into :class:`~.metrics.ServingMetrics`, so
``metrics.counters()`` and the tracer's ``deterministic_jsonl()`` equal the
reference engine's on the same request trace. The logical step index
advances by the decode steps that emitted tokens; submit steps, deadlines,
the shed budget, the fault plan and release steps all read it. A megastep
slower than ``watchdog_timeout_s`` or ``livelock_steps`` boundaries without
progress fail the engine closed with a typed error and a clean pool.

The engine serves the ``dense`` family and the ``moe`` family, PMQ-compressed
or not. In an MoE model expert capacity is raised to the drop-free bound
(capacity factor = number of experts), so a request's tokens never depend on
who it shares a step with. :func:`dense_greedy_reference` decodes through the
dense cache instead: the oracle the paged engine's greedy tokens are held to.

``kv_bits=8`` stores the pools as uint8 per-row affine codes (read through
``paged_attention_quant``); ``prefix_cache=True`` shares cached prompt
prefixes copy-on-write, so a hit prefills only the uncached suffix and a
full hit dispatches no prefill at all. Greedy outputs are bit-identical with
the cache on or off.

Pages for ``prompt + max_new`` are reserved at admission
(``reserve_full=True``). Growth and preemption (``reserve_full=False``),
swap, expert offload and temperature sampling are later slices: their
settings do not exist here, and ``reserve_full=False`` is refused.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models.moe import dispatch_capacity
from ..models.registry import get_model
from ..models.transformer import paged_decode_horizon, paged_prefill_chunk
from ..runtime.fault_tolerance import HeartbeatTable
from .controller import PlanAction, ResourceController
from .faults import (
    DeadlineExceeded,
    FaultPlan,
    LivelockDetected,
    PoisonedRequest,
    RequestCancelled,
    ServingFault,
    WatchdogTimeout,
)
from .kvcache import PagedKVCache, PoolExhausted
from .metrics import ServingMetrics
from .scheduler import VALID_POLICIES, Request, Scheduler
from .trace import ExpertRoutingTelemetry, MetricsConsumer, SpanTracer

__all__ = ["EngineConfig", "PagedServingEngine", "dense_greedy_reference",
           "quantized_greedy_reference"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    block_size: int = 16
    num_blocks: int = 64
    max_blocks_per_slot: int = 8
    prefill_chunk: int = 16
    use_otp: bool = True  # OTP decode masks when the model carries them
    # raise expert capacity to the drop-free bound inside every step
    drop_free_capacity: bool = True
    decode_horizon: int = 8
    # pages for prompt + max_new are reserved at admission; False (growth +
    # preemption) is a later slice and refused
    reserve_full: bool = True
    # shared-prefix KV reuse over refcounted copy-on-write pages
    prefix_cache: bool = False
    # 8 stores the pools as uint8 per-row affine codes; None keeps fp pools
    kv_bits: Optional[int] = None
    # "off" records no events (lifecycle facts still reach the metrics),
    # "spans" records spans, instants and flows, "full" adds per-step
    # gauges and the expert-routing telemetry
    trace_level: str = "off"
    # "fcfs", "priority" (classes first, FCFS within) or "fair" (priority
    # + weighted deficit round-robin over per-tenant decode tokens)
    policy: str = "fcfs"
    # (tenant, weight) pairs for policy="fair"; unlisted tenants weigh 1.0
    tenant_weights: Optional[Tuple[Tuple[str, float], ...]] = None
    # a fresh request that cannot admit after waiting more than this many
    # logical steps (or wall-clock seconds) is shed; None disables
    ttft_budget_steps: Optional[int] = None
    ttft_budget_s: Optional[float] = None
    # a megastep slower than this fails the engine closed (None = off)
    watchdog_timeout_s: Optional[float] = None
    # this many consecutive boundaries with work but no progress fail the
    # engine closed with LivelockDetected
    livelock_steps: int = 4096


def dense_greedy_reference(cfg, params, prompt: np.ndarray, max_new: int, *, device="cuda"):
    """Greedy decode through the dense cache — the oracle the paged engine
    is held to (paged == dense). Returns ``(tokens, per_step_logits)``,
    ``per_step_logits[i]`` the last-token logits ``[V]`` (f32, on the
    host) that chose ``tokens[i]``. Run it with the engine's ``model_cfg``
    so both sides use drop-free expert capacity."""
    bundle = get_model(cfg)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=device)
    cache, logits = bundle.prefill(params, {"tokens": tokens})
    # the prefill cache covers exactly the prompt; extend it for decode
    pad = cache["k"].new_zeros((*cache["k"].shape[:2], max_new, *cache["k"].shape[3:]))
    cache = dict(cache, k=torch.cat([cache["k"], pad], dim=2),
                 v=torch.cat([cache["v"], pad], dim=2))
    toks, steps = [], []
    for step in range(max_new):
        steps.append(logits[0, -1].cpu().numpy())
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(int(cur[0, 0]))
        if step < max_new - 1:
            cache, logits = bundle.decode_step(params, cache, cur, len(prompt) + step)
    return toks, steps


def quantized_greedy_reference(cfg, params, prompt: np.ndarray, max_new: int, *,
                               kv_bits: int = 8, block_size: int = 16, use_otp: bool = True,
                               device="cuda") -> List[int]:
    """Greedy oracle of int8-KV engines: a fresh single-slot, ``H = 1``,
    prefix-cache-off engine with the same ``kv_bits``. Per-row quantization
    depends only on the row, so a request's tokens are the same here as in
    a loaded, prefix-sharing engine."""
    prompt = np.ascontiguousarray(prompt, np.int32)
    pages = -(-(len(prompt) + max_new) // block_size)
    eng = PagedServingEngine(cfg, params, EngineConfig(
        max_slots=1, block_size=block_size, num_blocks=pages, max_blocks_per_slot=pages,
        prefill_chunk=block_size, decode_horizon=1, reserve_full=True, use_otp=use_otp,
        kv_bits=kv_bits, prefix_cache=False,
    ), device=device)
    return eng.serve([Request(rid=0, prompt=prompt, max_new=max_new)])[0]


class PagedServingEngine:
    """Serve :class:`Request`s against a dense or MoE model's params (see
    :mod:`repro_torch.models.transformer`) on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``), with an optional :class:`FaultPlan`."""

    def __init__(self, cfg, params: Dict, engine_cfg: Optional[EngineConfig] = None,
                 faults: Optional[FaultPlan] = None, *, device="cuda"):
        self.ecfg = ecfg = engine_cfg or EngineConfig()
        if cfg.family == "vlm":
            raise ValueError("vlm serving needs the patch-embedding path (image patches "
                             "ahead of the prompt), which the port does not have yet")
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"paged serving supports the dense and moe families, got "
                             f"{cfg.family!r}")
        if not ecfg.reserve_full:
            raise ValueError("reserve_full=False needs page growth and preemption, "
                             "which this slice does not implement")
        if ecfg.decode_horizon < 1:
            raise ValueError(f"decode_horizon must be ≥ 1, got {ecfg.decode_horizon}")
        if ecfg.policy not in VALID_POLICIES:
            raise ValueError(f"policy must be one of {VALID_POLICIES}, got {ecfg.policy!r}")
        if ecfg.ttft_budget_steps is not None and ecfg.ttft_budget_steps < 0:
            raise ValueError(f"ttft_budget_steps must be ≥ 0, got {ecfg.ttft_budget_steps}")
        if ecfg.ttft_budget_s is not None and ecfg.ttft_budget_s < 0:
            raise ValueError(f"ttft_budget_s must be ≥ 0, got {ecfg.ttft_budget_s}")
        if ecfg.livelock_steps < 1:
            raise ValueError(f"livelock_steps must be ≥ 1, got {ecfg.livelock_steps}")
        if len(params["layers"]) != cfg.num_layers:
            raise ValueError(f"params hold {len(params['layers'])} layers, "
                             f"config says {cfg.num_layers}")
        self.device = torch.device(device)
        self.model_cfg = cfg
        if cfg.is_moe and ecfg.drop_free_capacity:
            self.model_cfg = dataclasses.replace(
                cfg, moe_capacity_factor=float(max(cfg.moe_capacity_factor, cfg.num_experts))
            )
        self.params = params
        self.faults = faults
        # metrics first: they consume the tracer's lifecycle stream (through
        # a getter, so a caller that replaces engine.metrics keeps feeding it)
        self.metrics = ServingMetrics()
        self.tracer = SpanTracer(ecfg.trace_level,
                                 consumers=(MetricsConsumer(lambda: self.metrics),))
        self.cache = PagedKVCache(
            cfg, num_blocks=ecfg.num_blocks, block_size=ecfg.block_size,
            max_slots=ecfg.max_slots, max_blocks_per_slot=ecfg.max_blocks_per_slot,
            device=self.device, kv_bits=ecfg.kv_bits, prefix_cache=ecfg.prefix_cache,
        )
        self.cache.set_tracer(self.tracer)
        self.scheduler = Scheduler(
            self.cache, horizon=ecfg.decode_horizon, tracer=self.tracer, policy=ecfg.policy,
            tenant_weights=dict(ecfg.tenant_weights) if ecfg.tenant_weights is not None else None,
        )
        self.controller = ResourceController(
            self.scheduler, tracer=self.tracer, ttft_budget_steps=ecfg.ttft_budget_steps,
            ttft_budget_s=ecfg.ttft_budget_s, faults=faults,
        )
        self.results: Dict[int, List[int]] = {}
        # rid → the typed ServingFault a request ended with; results[rid]
        # holds the tokens it emitted before
        self.errors: Dict[int, ServingFault] = {}
        self._cancel_requests: set = set()
        self._no_progress = 0
        # injectable wall clock (the watchdog tests swap in a fake)
        self._clock = time.time
        self._watchdog = None
        if ecfg.watchdog_timeout_s is not None:
            self._watchdog = HeartbeatTable(["megastep"],
                                            timeout=float(ecfg.watchdog_timeout_s))
        self._step_idx = 0  # logical decode steps completed
        self._megastep_idx = 0
        # PMQ layers report per-slot dispatch counts: the capacity gauge and
        # the routing telemetry (while tracing) read them
        ce = params["layers"][0].get("moe_ce")
        self._num_slots = ce.num_slots if ce is not None else None
        self._ce_meta = ce.meta if ce is not None else None
        self.routing = (ExpertRoutingTelemetry()
                        if self.tracer.enabled and self._num_slots else None)
        # the last megastep's per-step emit mask [H, slots] and expert
        # dispatch counts [H, L, num_slots] (which expert rows it touched)
        self.last_emits: Optional[np.ndarray] = None
        self.last_slot_counts: Optional[np.ndarray] = None

    # ----------------------------------------------------- observability
    def routing_report(self) -> Optional[Dict]:
        """Observed per-(layer, expert-slot) dispatch frequency joined
        against the PMQ bit buckets; ``None`` unless the model is PMQ and
        tracing collected routing traffic."""
        if self.routing is None or self._ce_meta is None:
            return None
        return self.routing.bit_misallocation_report(self._ce_meta)

    def summary(self) -> Dict:
        """:meth:`ServingMetrics.summary` plus the engine's own keys: TTFT
        mean and max, prefill chunks, decode tokens, seconds and rate (wall
        clock on the host; the decode time ends in a device sync), mean OTP
        activation, prefix hits and reused tokens."""
        m = self.metrics
        out = m.summary()
        decode_s = float(sum(m.decode_step_s))
        tokens = out["generated_tokens"]
        out.update({
            "ttft_max_s": float(max(m.ttft_s)) if m.ttft_s else 0.0,
            "prefill_chunks": m.prefill_dispatches,
            "decode_tokens": tokens,
            "decode_s": decode_s,
            "decode_tokens_per_s": tokens / decode_s if decode_s else 0.0,
            "expert_activation": (float(np.mean(m.expert_activation))
                                  if m.expert_activation else 1.0),
            "cached_tokens": m.prefix_tokens_saved,
        })
        return out

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        req.arrival_s = time.time()
        self.scheduler.submit(req, self._step_idx)

    def cancel(self, rid: int) -> bool:
        """Mark a live request for cancellation, applied at the next safe
        point (the next boundary, or between prefill chunks). Returns
        whether ``rid`` was live (waiting or active)."""
        live = {r.rid for r in self.scheduler.waiting}
        live.update(r.rid for r in self.scheduler.active.values())
        if rid not in live:
            return False
        self._cancel_requests.add(rid)
        return True

    def serve(self, requests: Iterable[Request]) -> Dict[int, List[int]]:
        """Submit + run; returns the outputs of this batch."""
        reqs = list(requests)
        for r in reqs:
            self.submit(r)
        self.run()
        return {r.rid: self.results[r.rid] for r in reqs}

    # -------------------------------------------------------------- loop
    def run(self) -> Dict[int, List[int]]:
        while self.step():
            pass
        return dict(self.results)

    def step(self) -> bool:
        """One megastep boundary: advance the fault plan, apply
        cancellations and deadlines, execute the controller's plan, then
        advance every active slot one megastep under the watchdog, and count
        boundaries without progress. Returns whether work remains."""
        if self.faults is not None:
            self.faults.at_step(self._step_idx)
        self._apply_cancellations()
        self._apply_deadlines()
        if not self.scheduler.has_work():
            return False
        progress0 = (self._step_idx, sum(len(v) for v in self.results.values()))
        try:
            self._converge()
            if not self.scheduler.active:
                if not self.scheduler.waiting:
                    return False
                if self.controller.last_pool_penalty <= 0:
                    if self.cache.prefix is None or not self.cache.prefix.pages_held:
                        head = self.scheduler.waiting[0]
                        raise PoolExhausted(
                            f"request {head.rid} needs "
                            f"{self.cache.blocks_needed(head.context_tokens)} blocks but "
                            f"cannot be admitted ({self.cache.allocator.num_free} free)")
                    # a blocked head on an otherwise idle pool: the prefix
                    # cache is an optimisation, and its match's protected
                    # pages can pin pages eviction never reclaims — drop it
                    # and retry at the next boundary
                    self.cache.clear_prefix_cache()
            else:
                t_start = self._clock()
                if self._watchdog is not None:
                    self._watchdog.beat("megastep", now=t_start)
                self._decode_megastep()
                if self._watchdog is not None and self._watchdog.failed(now=self._clock()):
                    raise WatchdogTimeout(f"megastep exceeded the "
                                          f"{self.ecfg.watchdog_timeout_s}s watchdog budget")
        except WatchdogTimeout as exc:
            self._fail_closed(exc)
        progress1 = (self._step_idx, sum(len(v) for v in self.results.values()))
        if self.scheduler.has_work() and progress1 == progress0:
            self._no_progress += 1
            if self._no_progress >= self.ecfg.livelock_steps:
                self._fail_closed(LivelockDetected(
                    f"{self._no_progress} consecutive megastep boundaries with work but "
                    f"no progress"))
        else:
            self._no_progress = 0
        return self.scheduler.has_work()

    # --------------------------------------------------- typed termination
    def _terminate(self, req: Request, exc: ServingFault, kind: str) -> None:
        """End one request with a typed error: release what it holds, keep
        its partial output and the error, emit the lifecycle event."""
        track = f"slot{req.slot}" if req.slot >= 0 else "queue"
        self.scheduler.cancel_release(req)
        self._cancel_requests.discard(req.rid)
        self.errors[req.rid] = exc
        self.results[req.rid] = req.out
        self.tracer.lifecycle(kind, track=track, rid=req.rid, step=self._step_idx,
                              tokens=len(req.out))
        self.tracer.flow("f", req.rid, track=track)

    def _find_waiting(self, rid: int) -> Optional[Request]:
        return next((r for r in self.scheduler.waiting if r.rid == rid), None)

    def _find_live(self, rid: int) -> Optional[Request]:
        for r in self.scheduler.active.values():
            if r.rid == rid:
                return r
        return self._find_waiting(rid)

    def _apply_cancellations(self) -> None:
        for rid in sorted(self._cancel_requests):
            req = self._find_live(rid)
            if req is None:
                self._cancel_requests.discard(rid)
                continue
            self._terminate(req, RequestCancelled(f"request {rid} cancelled", rid=rid),
                            "cancel")

    def _apply_deadlines(self) -> None:
        live = list(self.scheduler.active.values()) + list(self.scheduler.waiting)
        for req in live:
            if req.deadline_steps is None:
                continue
            if self._step_idx - req.submit_step >= req.deadline_steps:
                self._terminate(req, DeadlineExceeded(
                    f"request {req.rid} missed its {req.deadline_steps}-step deadline",
                    rid=req.rid), "deadline")

    def _fail_closed(self, exc: ServingFault) -> None:
        """Engine-level fatal: end every live request with ``exc``, release
        all slots, pages and prefix holds, then raise."""
        live = list(self.scheduler.active.values()) + list(self.scheduler.waiting)
        for req in live:
            self.scheduler.cancel_release(req)
            self.errors[req.rid] = exc
            self.results[req.rid] = req.out
        self._cancel_requests.clear()
        self.tracer.lifecycle("fail_closed", track="engine", step=self._step_idx,
                              error=type(exc).__name__, requests=len(live))
        raise exc

    # ----------------------------------------------------- reconciliation
    def _converge(self) -> None:
        """Execute the controller's plan for this boundary."""
        self._execute_plan(self.controller.plan_boundary(self._step_idx, time.time()))

    def _execute_plan(self, plan: List[PlanAction]) -> None:
        for action in plan:
            if action.kind == "admit":
                self._execute_admit(action)
            elif action.kind == "evict_prefix":
                if self.cache.prefix is not None:
                    self.cache.prefix.evict_for(action.pages, frozenset(action.protect))
            elif action.kind == "shed":
                self._execute_shed(action)
            else:  # grow / preempt / upload_experts cannot be planned here
                raise RuntimeError(f"plan action {action.kind!r} needs growth, preemption or "
                                   f"expert offload, which the port does not have yet")

    # --------------------------------------------------------- admission
    def _execute_admit(self, action: PlanAction) -> None:
        req = self._find_waiting(action.rid)
        if req is None:
            return
        active_before = len(self.scheduler.active)
        depth_before = self.scheduler.queue_depth  # counts the request admitted
        wait_steps = self._step_idx - req.submit_step
        req = self.scheduler.admit_planned(req, self._step_idx)
        if req is None:
            return  # plan/pool divergence: drop the step, stay queued
        track = f"slot{req.slot}"
        self.tracer.lifecycle(
            "admit", track=track, rid=req.rid, slot=req.slot, step=self._step_idx,
            active_before=active_before, queue_depth=depth_before,
            resumed=req.preempt_count > 0, tenant=req.tenant, priority=req.priority,
            wait_steps=wait_steps,
        )
        self.tracer.flow("t", req.rid, track=track)
        if self.cache.prefix is not None:
            if req.cached_tokens > 0:
                self.tracer.lifecycle("prefix_hit", track=track, rid=req.rid,
                                      tokens_saved=req.cached_tokens,
                                      full=req.cached_logits is not None)
            else:
                self.tracer.lifecycle("prefix_miss", track=track, rid=req.rid)
        try:
            t0 = time.time()
            self._prefill_request(req)
            now = time.time()
            self.metrics.record_ttft(now - req.arrival_s, now - t0, tenant=req.tenant)
            self.results[req.rid] = req.out
        except (RequestCancelled, PoisonedRequest) as exc:
            self._terminate(req, exc,
                            "cancel" if isinstance(exc, RequestCancelled) else "poisoned")
            return
        if req.done:  # max_new == 1: the first token is the only one
            slot = req.slot
            self.scheduler.finish(slot)
            self.tracer.lifecycle("release", track=track, rid=req.rid, slot=slot,
                                  step=self._step_idx)
            self.tracer.flow("f", req.rid, track=track)

    def _execute_shed(self, action: PlanAction) -> None:
        req = self._find_waiting(action.rid)
        if req is None:
            return
        self.scheduler.shed(req, self._step_idx)
        self.results[req.rid] = []
        self.tracer.lifecycle("shed", track="queue", rid=req.rid, step=self._step_idx,
                              tenant=req.tenant, priority=req.priority,
                              wait_steps=action.waited_steps)
        self.tracer.flow("f", req.rid, track="queue")

    def _prefill_request(self, req: Request) -> None:
        """Stream the prompt through chunked prefill into the slot's pages,
        from ``req.cached_tokens`` on (a prefix hit's pages already hold the
        rest); a full hit takes its cached logits and dispatches no chunk.

        The prefill syncs with the host once: the first token, the logits'
        finiteness flag and the chunks' dispatch counts come back in one
        transfer (at trace level ``full`` the counts come back per chunk, so
        the routing gauges interleave with the chunk spans as the
        reference's do). Non-finite logits (the ``logits`` fault poisons a
        device copy) end the request with :class:`PoisonedRequest` before
        anything reaches the prefix cache. Then the prompt registers its own
        prefixes in the cache."""
        c = self.ecfg.prefill_chunk
        p_len = len(req.prompt)
        track = f"slot{req.slot}"
        off0 = min(req.cached_tokens, p_len)
        pending: List[torch.Tensor] = []  # chunks' counts awaiting the fetch
        if req.cached_logits is not None and off0 >= p_len:
            last = req.cached_logits
        else:
            table_row = torch.as_tensor(self.cache.block_tables[req.slot:req.slot + 1],
                                        device=self.device)
            for off in range(off0, p_len, c):
                if req.rid in self._cancel_requests:
                    self._record_counts(pending, c)
                    raise RequestCancelled(f"request {req.rid} cancelled mid-prefill",
                                           rid=req.rid)
                n = min(c, p_len - off)
                chunk = np.zeros((1, c), np.int64)
                chunk[0, :n] = req.prompt[off:off + n]
                t0 = self.tracer.now_us()
                logits, counts = paged_prefill_chunk(
                    self.params, self.cache.k, self.cache.v, table_row,
                    torch.as_tensor(chunk, device=self.device), off, n, self.model_cfg,
                    block_size=self.ecfg.block_size, use_otp=self.ecfg.use_otp,
                    qs=self.cache.quant_tables,
                )
                self.tracer.complete("compute", track=track, cat="prefill", start_us=t0,
                                     args={"run": 1})
                self.metrics.record_prefill_runs(1)
                self.tracer.complete(
                    "prefill_chunk", track=track, cat="prefill", start_us=t0,
                    args={"rid": req.rid, "offset": off, "tokens": n, "resume": False,
                          "runs": 1})
                pending.append(counts)
                if self.tracer.full:
                    self._record_counts(pending, c)
            last = logits[0, -1]
        if self.faults is not None:
            spec = self.faults.fire("logits", req.rid)
            if spec is not None:
                self.tracer.lifecycle("fault", track=track, site="logits", mode=spec.mode,
                                      rid=req.rid)
                last = last.clone()
                last[0] = float("nan")
        head = torch.stack([torch.argmax(last), torch.isfinite(last).all().long()])
        host = torch.cat([head] + [t.reshape(-1).long() for t in pending]).cpu().numpy()
        tok, finite = int(host[0]), bool(host[1])
        self._record_counts(pending, c, host[2:])
        if not finite:
            raise PoisonedRequest(f"request {req.rid}: non-finite prefill logits", rid=req.rid)
        self.cache.register_prefix(req.prompt, req.slot, last_logits=last)
        req.out.append(tok)
        req.pos = p_len
        self.metrics.record_tenant_tokens(req.tenant, 1)
        self.tracer.instant("first_token", track=track, cat="prefill", rid=req.rid, token=tok)

    def _record_counts(self, pending: List[torch.Tensor], t: int,
                       host: Optional[np.ndarray] = None) -> None:
        """Feed the capacity gauge from prefill chunks' dispatch counts
        (``host`` holds them fetched and flattened, else they are fetched
        here) and empty ``pending``."""
        if host is None and pending:
            host = torch.cat([x.reshape(-1).long() for x in pending]).cpu().numpy()
        at = 0
        for x in pending:
            self._record_capacity_util(host[at:at + x.numel()].reshape(tuple(x.shape)), t)
            at += x.numel()
        pending.clear()

    def _record_capacity_util(self, counts: np.ndarray, t: int) -> None:
        """One logical step's (decode step or prefill chunk of ``t``
        tokens) routed (token, choice) pairs over the dispatch buffer's
        capacity rows, ``L · num_slots · cap``, in host floats; and, while
        tracing, the routing telemetry."""
        if self._num_slots is None or counts.size == 0:
            return
        cap = dispatch_capacity(self.model_cfg, t)
        denom = counts.shape[0] * self._num_slots * cap
        occupied = np.minimum(counts, cap).sum()
        self.metrics.record_capacity_utilization(float(occupied) / float(denom))
        if self.routing is not None:
            gauges = self.routing.update(counts)
            if gauges:
                self.tracer.counter("routing", track="engine", **gauges)

    # ------------------------------------------------------------ decode
    def _decode_megastep(self) -> None:
        """Advance every active slot up to ``decode_horizon`` tokens, fetch
        tokens, emit mask, activations and dispatch counts in one transfer,
        and apply them on the host; per-logical-step metrics are rebuilt
        from the emit mask (exact) and the megastep's wall time (spread
        evenly)."""
        b, h = self.ecfg.max_slots, self.ecfg.decode_horizon
        tokens = np.zeros((b, 1), np.int64)
        positions = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        budgets = np.zeros((b,), np.int32)
        eos_ids = np.full((b,), -1, np.int32)
        for slot, req in self.scheduler.active.items():
            tokens[slot, 0] = req.out[-1]
            positions[slot] = req.pos
            active[slot] = True
            budgets[slot] = req.max_new - len(req.out)
            eos_ids[slot] = req.eos_id
        dev = self.device
        t0 = time.time()
        t0_us = self.tracer.now_us()
        toks, emits, acts, counts = paged_decode_horizon(
            self.params, self.cache.k, self.cache.v, self.cache.tables_device(),
            torch.as_tensor(tokens, device=dev), torch.as_tensor(positions, device=dev),
            torch.as_tensor(active, device=dev), self.model_cfg,
            block_size=self.ecfg.block_size, horizon=h,
            budgets=torch.as_tensor(budgets, device=dev),
            eos_ids=torch.as_tensor(eos_ids, device=dev), use_otp=self.ecfg.use_otp,
            qs=self.cache.quant_tables,
        )
        # the megastep's one host sync (f64 holds every token id, count and
        # f32 activation exactly)
        host = torch.cat([toks.reshape(-1).double(), emits.reshape(-1).double(),
                          acts.double(), counts.reshape(-1).double()]).cpu().numpy()
        compute_s = time.time() - t0
        self.tracer.complete("compute", track="engine", cat="decode", start_us=t0_us,
                             args={"run": 1})
        hb = h * b
        toks = host[:hb].reshape(h, b).astype(np.int64)  # -1 where not emitted
        emits = host[hb:2 * hb].reshape(h, b) > 0
        acts = host[2 * hb:2 * hb + h]
        counts = host[2 * hb + h:].reshape(tuple(counts.shape)).astype(np.int64)
        self.last_emits, self.last_slot_counts = emits, counts
        dt = time.time() - t0
        # logical steps that emitted ≥ 1 token; trailing all-stopped steps
        # computed nothing that counts
        emitting = np.flatnonzero(emits.any(axis=1))
        steps_run = len(emitting)
        self.metrics.record_megastep(steps_run, compute_s, 0.0, 1, 1)
        self.tracer.complete(
            "megastep", track="engine", cat="decode", start_us=t0_us,
            args={"megastep": self._megastep_idx, "horizon": h, "active": int(active.sum()),
                  "steps": steps_run, "runs": 1})
        for slot, req in self.scheduler.active.items():
            self.tracer.complete("decode", track=f"slot{slot}", cat="decode", start_us=t0_us,
                                 args={"rid": req.rid, "tokens": int(emits[:, slot].sum())})
        self.tracer.counter("pool", track="engine", page_util=self.cache.utilization,
                            queue_depth=self.scheduler.queue_depth, active=int(active.sum()))
        per_step_s = dt / max(steps_run, 1)
        for s in emitting:
            # queue depth and page utilization are constant within a megastep
            self.metrics.record_decode_step(
                per_step_s, int(emits[s].sum()), float(acts[s]), self.scheduler.queue_depth,
                page_utilization=self.cache.utilization)
            self._record_capacity_util(counts[s], b)
        for slot, req in list(self.scheduler.active.items()):
            last_s = emitted = 0
            for s in range(h):
                if emits[s, slot]:
                    req.out.append(int(toks[s, slot]))
                    req.pos += 1
                    last_s = s
                    emitted += 1
            self.scheduler.note_tokens(req.tenant, emitted)
            self.metrics.record_tenant_tokens(req.tenant, emitted)
            if req.done:
                self.scheduler.finish(slot)
                track = f"slot{slot}"
                self.tracer.lifecycle("release", track=track, rid=req.rid, slot=slot,
                                      step=self._step_idx + last_s)
                self.tracer.flow("f", req.rid, track=track)
        self._step_idx += steps_run
        self._megastep_idx += 1
