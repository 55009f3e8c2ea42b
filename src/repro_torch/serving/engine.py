"""Continuous-batching engine over the paged KV pool (port of
``repro/serving/engine.py``).

* **prefill** — an admitted request's prompt streams through
  :func:`paged_prefill_chunk` in fixed-size chunks, writing K/V straight
  into its pages; the last chunk's logits give the first token (TTFT).
* **decode megastep** — every slot advances up to ``decode_horizon``
  tokens through :func:`paged_decode_horizon`: the token chosen on the
  device (greedy argmax, or a temperature draw) feeds the next step, per-slot stop logic rides the
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

The engine serves the ``dense`` and ``vlm`` families (a ``vlm`` model on
tokens alone, as the reference's engine does) and the ``moe`` family,
PMQ-compressed or not. In an MoE model expert capacity is raised to the drop-free bound
(capacity factor = number of experts), so a request's tokens never depend on
who it shares a step with. :func:`dense_greedy_reference` decodes through the
dense cache instead: the oracle the paged engine's greedy tokens are held to.

``kv_bits=8`` stores the pools as uint8 per-row affine codes (read through
``paged_attention_quant``); ``prefix_cache=True`` shares cached prompt
prefixes copy-on-write, so a hit prefills only the uncached suffix and a
full hit dispatches no prefill at all. Greedy outputs are bit-identical with
the cache on or off.

**Growth and preemption.** Admission reserves pages for the context plus
the next megastep's writes (``reserve_full=False``, the default) and the
controller grows every active slot horizon-ahead at each boundary. When the
pool runs short it preempts a policy-ordered victim: ``preempt_mode="swap"``
moves the victim's pages to the host (:class:`~.kvcache.SwappedKV`, CRC
checked) and writes them back at re-admission, ``"recompute"`` drops them
and re-prefills ``prompt + out[:-1]``; a failed or corrupt swap falls back
to the re-prefill. ``reserve_full=True`` reserves ``prompt + max_new`` up
front, so neither happens.

**Host-offloaded expert buckets.** With ``resident_experts`` set (PMQ
params only) the device holds a budget of expert rows per layer and bucket
(:class:`~.offload.ExpertOffloadManager`); cold rows live on the host, or
on disk behind a host row cache with ``offload_dir``. Between megasteps the
controller plans uploads of the routing-EMA-hottest experts
(``upload_experts``), executed at once or, with ``async_offload``, staged on
a side stream right after the next program's dispatch and committed at the
boundary after it. Routing happens inside the program, so a run reports
which experts it used: the engine uploads the missing ones synchronously and
**replays the whole program** until a run finds its working set resident
(:meth:`PagedServingEngine._run_offloaded`). A replay is idempotent on the
port's pools: every KV write of a prefill chunk or decode step lands at a
row its position determines and is written again with the correct values,
and the program's inputs come from host arrays the loop does not change, so
the accepted run's outputs and pool contents are the all-resident engine's.
With offload on the prefill syncs once per run, since each chunk's counts
decide whether it replays before the next chunk runs. The ``upload`` fault
site fires in the manager's recovery ladder (retry, re-fetch, degrade to a
lower bit width, or fail closed with ``ExpertUploadFailed``).

**Sampling.** ``temperature = 0`` (the default) decodes greedily; ``> 0``
draws every token from ``softmax(logits / T)`` by Gumbel-max on the device
(:func:`~repro_torch.models.transformer.sample_gumbel`). A megastep's draws
come from a generator seeded from ``(sample_seed, 0, megastep index)`` and
made anew for every run, so an offload replay draws the same tokens; the
first token after a prefill from ``(sample_seed, 1, rid)``. The reference's
two ``jax.random`` key streams have this structure; torch's generator
cannot give their bits, so sampled tokens are held within the port
(deterministic per seed, unchanged by replay), and card and CPU differ.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.compressed_moe import resolve_ffn_backend
from ..models.moe import dispatch_capacity
from ..models.registry import get_model
from ..models.transformer import (
    extend_cache,
    paged_decode_horizon,
    paged_prefill_chunk,
    sample_gumbel,
)
from ..runtime.fault_tolerance import HeartbeatTable
from .controller import PlanAction, ResourceController
from .faults import (
    DeadlineExceeded,
    ExpertUploadFailed,
    FaultPlan,
    LivelockDetected,
    PoisonedRequest,
    RequestCancelled,
    ServingFault,
    SwapFault,
    WatchdogTimeout,
)
from .kvcache import PagedKVCache, PoolExhausted
from .metrics import ServingMetrics
from .offload import ExpertOffloadManager
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
    # PMQ expert-FFN path: "grouped" (the Hopper kernels on the card, their
    # plain versions on the CPU), "ref" (the plain versions on either) or
    # "scan" (per-expert quant_matmul); None takes REPRO_FFN_BACKEND, else
    # "grouped"
    ffn_backend: Optional[str] = None
    # raise expert capacity to the drop-free bound inside every step
    drop_free_capacity: bool = True
    # per-layer device budget in expert slots for PMQ buckets (None keeps
    # every bucket resident); cold rows live on the host (serving.offload)
    resident_experts: Optional[int] = None
    # decay of the routing EMA that ranks experts for prefetch
    prefetch_ema: float = 0.8
    # stage the controller's expert uploads on a side stream while the next
    # program computes, committed at the boundary after it (outputs unchanged)
    async_offload: bool = False
    # spill the expert store to mmap'd disk images in this directory: disk →
    # host row cache → device, every disk row CRC-checked
    offload_dir: Optional[str] = None
    # byte budget of that host row cache (None: unbounded)
    host_expert_bytes: Optional[int] = None
    decode_horizon: int = 8
    # 0 decodes greedily; > 0 samples softmax(logits / T) on the device, one
    # generator per megastep seeded from sample_seed, so runs (and offload
    # replays) are deterministic
    temperature: float = 0.0
    sample_seed: int = 0
    # how a preempted request is restored: "swap" moves its KV pages to the
    # host and back at re-admission (bit-exact), "recompute" drops them and
    # re-prefills prompt + generated-so-far
    preempt_mode: str = "swap"
    # True reserves prompt + max_new pages at admission, so growth and
    # preemption never happen; False grows pages on demand
    reserve_full: bool = False
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
    # serve a lower-bit copy of an expert row whose upload keeps failing
    # (False fails the engine closed with ExpertUploadFailed instead)
    degrade_experts: bool = False
    # miss-path retries per expert row before degrading or failing
    upload_max_retries: int = 3
    # a megastep slower than this fails the engine closed (None = off)
    watchdog_timeout_s: Optional[float] = None
    # this many consecutive boundaries with work but no progress fail the
    # engine closed with LivelockDetected
    livelock_steps: int = 4096

    def __post_init__(self):
        if self.ffn_backend is not None:
            resolve_ffn_backend(self.ffn_backend)


def dense_greedy_reference(cfg, params, prompt: np.ndarray, max_new: int, *,
                           patch_embeds: Optional[torch.Tensor] = None, device="cuda"):
    """Greedy decode through the dense cache — the oracle the paged engine
    is held to (paged == dense). Returns ``(tokens, per_step_logits)``,
    ``per_step_logits[i]`` the last-token logits ``[V]`` (f32, on the
    host) that chose ``tokens[i]``. Run it with the engine's ``model_cfg``
    so both sides use drop-free expert capacity. A ``vlm`` model's
    ``patch_embeds [1, P, D]`` go ahead of the prompt, and decoding
    continues at ``cache["pos"]`` = prompt + P."""
    bundle = get_model(cfg)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=device)
    batch = {"tokens": tokens}
    if patch_embeds is not None:
        batch["patch_embeds"] = patch_embeds
    cache, logits = bundle.prefill(params, batch)
    cache = extend_cache(cache, max_new)
    toks, steps = [], []
    for step in range(max_new):
        steps.append(logits[0, -1].cpu().numpy())
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks.append(int(cur[0, 0]))
        if step < max_new - 1:
            cache, logits = bundle.decode_step(params, cache, cur, cache["pos"])
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
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"paged serving supports the dense, moe and vlm families, got "
                             f"{cfg.family!r}")
        if ecfg.preempt_mode not in ("swap", "recompute"):
            raise ValueError(f"preempt_mode must be 'swap' or 'recompute', "
                             f"got {ecfg.preempt_mode!r}")
        if ecfg.decode_horizon < 1:
            raise ValueError(f"decode_horizon must be ≥ 1, got {ecfg.decode_horizon}")
        if ecfg.temperature < 0.0:
            raise ValueError(f"temperature must be ≥ 0, got {ecfg.temperature}")
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
        self.offload = None
        if ecfg.resident_experts is not None:
            if any("moe_ce" not in p for p in params["layers"]):
                raise ValueError("resident_experts requires PMQ-compressed params (a 'moe_ce' "
                                 "entry in every layer)")
            self.offload = ExpertOffloadManager(
                [p["moe_ce"] for p in params["layers"]], resident_slots=ecfg.resident_experts,
                ema_decay=ecfg.prefetch_ema, tracer=self.tracer, faults=faults,
                degrade=ecfg.degrade_experts, max_retries=ecfg.upload_max_retries,
                offload_dir=ecfg.offload_dir, host_budget_bytes=ecfg.host_expert_bytes,
                device=self.device)
            self.params = params = dict(params, layers=[
                dict(p, moe_ce=ce) for p, ce in zip(params["layers"], self.offload.ces)])
        elif ecfg.async_offload or ecfg.offload_dir is not None:
            raise ValueError("async_offload/offload_dir require resident_experts (there is no "
                             "expert streaming to overlap or tier)")
        # async streaming: upload_experts targets deferred from the boundary
        # to right after the next program's dispatch
        self._pending_expert_targets: Tuple = ()
        self._last_run_stats: Dict[str, float] = {}
        self.cache = PagedKVCache(
            cfg, num_blocks=ecfg.num_blocks, block_size=ecfg.block_size,
            max_slots=ecfg.max_slots, max_blocks_per_slot=ecfg.max_blocks_per_slot,
            device=self.device, kv_bits=ecfg.kv_bits, prefix_cache=ecfg.prefix_cache,
        )
        self.cache.set_tracer(self.tracer)
        self.cache.faults = faults
        self.scheduler = Scheduler(
            self.cache, reserve_full=ecfg.reserve_full, horizon=ecfg.decode_horizon,
            tracer=self.tracer, policy=ecfg.policy,
            tenant_weights=dict(ecfg.tenant_weights) if ecfg.tenant_weights is not None else None,
        )
        self.controller = ResourceController(
            self.scheduler, offload=self.offload, tracer=self.tracer,
            ttft_budget_steps=ecfg.ttft_budget_steps, ttft_budget_s=ecfg.ttft_budget_s,
            faults=faults,
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
        against the PMQ bit buckets (and the bits a degraded row serves at);
        ``None`` unless the model is PMQ and tracing collected routing
        traffic."""
        if self.routing is None or self._ce_meta is None:
            return None
        degraded = None
        if self.offload is not None and self.offload.degraded:
            degraded = {k: to_bits for k, (_, to_bits) in self.offload.degraded.items()}
        return self.routing.bit_misallocation_report(self._ce_meta, degraded=degraded)

    def summary(self) -> Dict:
        """:meth:`ServingMetrics.summary` plus the engine's own keys: TTFT
        mean and max, prefill chunks (runs less replays), decode tokens,
        seconds and rate (wall clock on the host; the decode time ends in a
        device sync), mean OTP activation, prefix hits and reused tokens."""
        m = self.metrics
        out = m.summary()
        decode_s = float(sum(m.decode_step_s))
        tokens = out["generated_tokens"]
        out.update({
            "ttft_max_s": float(max(m.ttft_s)) if m.ttft_s else 0.0,
            "prefill_chunks": m.prefill_dispatches - m.prefill_replays,
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
        except (ExpertUploadFailed, WatchdogTimeout) as exc:
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
        """Flip a staged async expert batch in (or drop it as stale) before
        the controller observes residency, then execute its plan."""
        if self.offload is not None and self.ecfg.async_offload:
            committed, dropped, nbytes, wait_s = self.offload.commit_async()
            if committed or dropped:
                self.metrics.record_async_commit(committed, dropped, nbytes, wait_s)
        self._execute_plan(self.controller.plan_boundary(self._step_idx, time.time()))

    def _execute_plan(self, plan: List[PlanAction]) -> None:
        for action in plan:
            if action.kind == "admit":
                self._execute_admit(action)
            elif action.kind == "preempt":
                self._execute_preempt(action)
            elif action.kind == "grow":
                self._execute_grow(action)
            elif action.kind == "evict_prefix":
                if self.cache.prefix is not None:
                    self.cache.prefix.evict_for(action.pages, frozenset(action.protect))
            elif action.kind == "shed":
                self._execute_shed(action)
            elif action.kind == "upload_experts":
                if self.ecfg.async_offload:
                    # issued right after the next program's dispatch; the
                    # targets are a boundary stale, which placement
                    # invariance makes safe
                    self._pending_expert_targets = action.targets
                else:
                    t0 = time.time()
                    uploads, nbytes = self.offload.apply_residency(action.targets)
                    if uploads:
                        self.metrics.record_expert_prefetch(uploads, nbytes)
                        self.metrics.record_upload_stall(time.time() - t0)
            else:
                raise ValueError(f"unknown plan action kind {action.kind!r}")

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
        if self.cache.prefix is not None and req.preempt_count == 0:
            if req.cached_tokens > 0:
                self.tracer.lifecycle("prefix_hit", track=track, rid=req.rid,
                                      tokens_saved=req.cached_tokens,
                                      full=req.cached_logits is not None)
            else:
                self.tracer.lifecycle("prefix_miss", track=track, rid=req.rid)
        try:
            if req.swapped is not None:  # swap-restore a preempted slot
                try:
                    nbytes = self.cache.swap_in(req.slot, req.swapped, rid=req.rid)
                except SwapFault:
                    # a failed or corrupt payload: drop it and re-prefill
                    self.tracer.lifecycle("swap_fallback", track=track, rid=req.rid,
                                          site="swap_in")
                    req.swapped = None
                    self._prefill_request(req, resume=True)
                else:
                    self.tracer.lifecycle("swap_in", track=track, rid=req.rid, slot=req.slot,
                                          nbytes=nbytes)
                    req.swapped = None
            elif req.pos > 0:  # recompute-restore: re-prefill the context
                self._prefill_request(req, resume=True)
            else:
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

    def _prefill_request(self, req: Request, resume: bool = False) -> None:
        """Stream the prompt through chunked prefill into the slot's pages,
        from ``req.cached_tokens`` on (a prefix hit's pages already hold the
        rest); a full hit takes its cached logits and dispatches no chunk.
        ``resume=True`` rebuilds a preempted slot: the context is ``prompt +
        out[:-1]`` (everything written to KV before the eviction), every
        chunk is streamed and the final chunk's logits are discarded (they
        re-predict the known ``out[-1]``).

        Without expert offload the prefill syncs with the host once: the
        first token, the logits' finiteness flag and the chunks' dispatch
        counts come back in one transfer (at trace level ``full`` the counts
        come back per chunk, so the routing gauges interleave with the chunk
        spans as the reference's do). With offload each chunk runs under
        :meth:`_run_offloaded`, which fetches its counts after every run.
        Non-finite logits (the ``logits`` fault poisons a device copy) end
        the request with :class:`PoisonedRequest` before anything reaches the
        prefix cache. Then the prompt registers its own prefixes in the
        cache."""
        if resume:
            seq = np.concatenate([req.prompt, np.asarray(req.out[:-1], np.int32)])
            assert len(seq) == req.pos, (len(seq), req.pos)
        else:
            seq = req.prompt
        c = self.ecfg.prefill_chunk
        p_len = len(seq)
        track = f"slot{req.slot}"
        off0 = 0 if resume else min(req.cached_tokens, p_len)
        pending: List[torch.Tensor] = []  # chunks' counts awaiting the fetch
        if not resume and req.cached_logits is not None and off0 >= p_len:
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
                chunk[0, :n] = seq[off:off + n]
                chunk = torch.as_tensor(chunk, device=self.device)
                t0 = self.tracer.now_us()
                (logits, counts), host_counts = self._run_offloaded(
                    lambda: paged_prefill_chunk(
                        self.params, self.cache.k, self.cache.v, table_row, chunk, off, n,
                        self.model_cfg, block_size=self.ecfg.block_size,
                        use_otp=self.ecfg.use_otp, qs=self.cache.quant_tables,
                        ffn_backend=self.ecfg.ffn_backend,
                        decode_from=len(req.prompt) if resume else None,
                        decode_batch=self.ecfg.max_slots),
                    self._fetch_prefill_counts, kind="prefill", track=track)
                runs = int(self._last_run_stats["runs"])
                self.metrics.record_prefill_runs(runs)
                self.tracer.complete(
                    "prefill_chunk", track=track, cat="prefill", start_us=t0,
                    args={"rid": req.rid, "offset": off, "tokens": n, "resume": resume,
                          "runs": runs})
                if host_counts is not None:
                    self._record_capacity_util(host_counts, c)
                else:
                    pending.append(counts)
                    if self.tracer.full:
                        self._record_counts(pending, c)
            if resume:
                self._record_counts(pending, c)
                return
            last = logits[0, -1]
        if self.faults is not None:
            spec = self.faults.fire("logits", req.rid)
            if spec is not None:
                self.tracer.lifecycle("fault", track=track, site="logits", mode=spec.mode,
                                      rid=req.rid)
                last = last.clone()
                last[0] = float("nan")
        gen = self._sample_generator(1, req.rid)
        first = (torch.argmax(last) if gen is None
                 else sample_gumbel(last, self.ecfg.temperature, gen))
        head = torch.stack([first, torch.isfinite(last).all().long()])
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

    def _fetch_prefill_counts(self, out):
        """A prefill run's counts on the host when expert offload needs them
        now (else None: they wait for the prefill's one transfer)."""
        if self.offload is None:
            return out, None
        return out, out[1].cpu().numpy().astype(np.int64)

    # --------------------------------------------------- expert residency
    def _run_offloaded(self, dispatch, fetch, kind: str = "decode", track: str = "engine"):
        """Run one program (a prefill chunk or a decode megastep) under the
        expert-residency contract: ``dispatch()`` enqueues it, ``fetch(out)``
        returns ``(payload, counts)`` with the dispatch counts on the host
        (``[L, S]``, or ``[H, L, S]`` for a megastep). With offload on, the
        program is replayed after a synchronous upload until a run found
        every expert it dispatched to resident; that run's payload is
        returned. A staged async prefetch is issued right after the first
        dispatch, before the fetch, so its copies overlap the program. Each
        run is a ``compute`` (first) or ``replay`` span; ``_last_run_stats``
        holds the run count, the first run's seconds and the rest (uploads
        and replays) as ``offload_s``."""
        if self.offload is not None:
            self.offload.begin_step()
        missed = False
        runs = 0
        compute_s = offload_s = 0.0
        while True:
            t0 = time.time()
            t0_us = self.tracer.now_us()
            out = dispatch()
            if runs == 0 and self._pending_expert_targets:
                targets, self._pending_expert_targets = self._pending_expert_targets, ()
                ti = time.time()
                ups, _ = self.offload.issue_async(targets)
                if ups:
                    self.metrics.record_async_issue(ups, time.time() - ti)
            payload, counts = fetch(out)
            runs += 1
            dt = time.time() - t0
            self.tracer.complete("compute" if runs == 1 else "replay", track=track, cat=kind,
                                 start_us=t0_us, args={"run": runs})
            if runs == 1:
                compute_s = dt
            else:
                offload_s += dt
            if self.offload is None:
                self._last_run_stats = {"runs": runs, "compute_s": compute_s,
                                        "offload_s": offload_s}
                return payload, counts
            t1 = time.time()
            uploads, nbytes = self.offload.ensure_resident(counts)
            if uploads == 0:
                if missed:
                    self.metrics.record_expert_miss_step()
                else:
                    self.metrics.record_expert_hit()
                self.offload.update_stats(counts)
                self._last_run_stats = {"runs": runs, "compute_s": compute_s,
                                        "offload_s": offload_s + (time.time() - t1)}
                return payload, counts
            missed = True
            offload_s += time.time() - t1
            self.metrics.record_expert_miss(uploads, nbytes)

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

    def _sample_generator(self, stream: int, index: int) -> Optional[torch.Generator]:
        """The generator of one sampled draw on the engine's device, seeded
        from ``(sample_seed, stream, index)`` (stream 0: the megastep index;
        1: the request id of a first token); None when decoding greedily."""
        if self.ecfg.temperature <= 0.0:
            return None
        words = np.random.SeedSequence(
            [v % 2**64 for v in (self.ecfg.sample_seed, stream, index)]
        ).generate_state(2, np.uint32)
        return torch.Generator(device=self.device).manual_seed(
            int(words[0]) | int(words[1]) << 32)

    # ---------------------------------------------------- growth/preempt
    def _note_preempt(self, vreq: Request, vslot: int, *, for_rid: int,
                      for_tenant: str) -> None:
        """Lifecycle bookkeeping for one executed preemption."""
        vtrack = f"slot{vslot}"
        self.tracer.lifecycle(
            "preempt", track=vtrack, rid=vreq.rid, slot=vslot, step=self._step_idx,
            mode=self.ecfg.preempt_mode,
            swap_bytes=vreq.swapped.nbytes if vreq.swapped else 0,
            tenant=vreq.tenant, for_rid=for_rid, for_tenant=for_tenant,
        )
        self.tracer.flow("t", vreq.rid, track=vtrack)

    def _execute_preempt(self, action: PlanAction) -> None:
        vreq = self.scheduler.active.get(action.slot)
        if vreq is None or vreq.rid != action.rid:
            return  # plan victims are live actives
        vreq = self.scheduler.preempt(action.slot, swap=self.ecfg.preempt_mode == "swap")
        self._note_preempt(vreq, action.slot, for_rid=action.for_rid,
                           for_tenant=action.for_tenant)

    def _execute_grow(self, action: PlanAction) -> None:
        """Grow one active slot horizon-ahead: pages for every KV write of
        the coming megastep. The controller's ledger mirrors the pools, so
        the pages are there (planned preemptions and evictions ran first);
        the loop below is a safety net for ledger/pool divergence only, and
        falls back to policy-ordered preemption."""
        slot = action.slot
        req = self.scheduler.active.get(slot)
        if req is None or req.rid != action.rid:
            return  # the grower itself was victimized earlier in the plan
        need = self.cache.slot_deficit(
            slot, req.pos + req.next_decode_writes(self.ecfg.decode_horizon))
        if need <= 0:
            return
        swap = self.ecfg.preempt_mode == "swap"
        # evictable prefix pages count: cache.grow evicts them before any
        # preemption is needed
        while self.cache.available_pages() < need and slot in self.scheduler.active:
            vslot = self.scheduler.pick_victim()
            vreq = self.scheduler.preempt(vslot, swap=swap)
            self._note_preempt(vreq, vslot, for_rid=req.rid, for_tenant=req.tenant)
        if slot in self.scheduler.active:
            self.cache.grow(slot, need)

    # ------------------------------------------------------------ decode
    def _decode_megastep(self) -> None:
        """Advance every active slot up to ``decode_horizon`` tokens, fetch
        tokens, emit mask, activations and dispatch counts in one transfer
        per run (replays only with expert offload), and apply them on the
        host; per-logical-step metrics are rebuilt from the emit mask (exact)
        and the megastep's wall time (spread evenly)."""
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
        inputs = [torch.as_tensor(a, device=dev) for a in (tokens, positions, active)]
        tables = self.cache.tables_device()
        stop = dict(budgets=torch.as_tensor(budgets, device=dev),
                    eos_ids=torch.as_tensor(eos_ids, device=dev))
        hb = h * b

        def fetch(out):
            toks, emits, acts, counts = out
            # one host sync per run (f64 holds every token id, count and f32
            # activation exactly)
            host = torch.cat([toks.reshape(-1).double(), emits.reshape(-1).double(),
                              acts.double(), counts.reshape(-1).double()]).cpu().numpy()
            return ((host[:hb].reshape(h, b).astype(np.int64),  # -1 where not emitted
                     host[hb:2 * hb].reshape(h, b) > 0, host[2 * hb:2 * hb + h]),
                    host[2 * hb + h:].reshape(tuple(counts.shape)).astype(np.int64))

        t0 = time.time()
        t0_us = self.tracer.now_us()
        # a fresh generator per run: a replay draws what the first run drew
        (toks, emits, acts), counts = self._run_offloaded(
            lambda: paged_decode_horizon(
                self.params, self.cache.k, self.cache.v, tables, *inputs, self.model_cfg,
                block_size=self.ecfg.block_size, horizon=h, use_otp=self.ecfg.use_otp,
                qs=self.cache.quant_tables, temperature=self.ecfg.temperature,
                generator=self._sample_generator(0, self._megastep_idx),
                ffn_backend=self.ecfg.ffn_backend, **stop),
            fetch)
        self.last_emits, self.last_slot_counts = emits, counts
        dt = time.time() - t0
        stats = self._last_run_stats
        # logical steps that emitted ≥ 1 token; trailing all-stopped steps
        # computed nothing that counts
        emitting = np.flatnonzero(emits.any(axis=1))
        steps_run = len(emitting)
        self.metrics.record_megastep(steps_run, stats["compute_s"], stats["offload_s"],
                                     stats["runs"], stats["runs"])
        self.tracer.complete(
            "megastep", track="engine", cat="decode", start_us=t0_us,
            args={"megastep": self._megastep_idx, "horizon": h, "active": int(active.sum()),
                  "steps": steps_run, "runs": int(stats["runs"])})
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
        if self.offload is not None:
            self.metrics.record_expert_residency(self.offload.resident_bytes)
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
