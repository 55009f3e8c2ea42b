"""Serving observability (port of ``repro/serving/metrics.py``): TTFT,
per-token latency, queue depth, expert activation, page and capacity
utilization, admissions, sheds, controller plans, per-tenant tokens,
preemptions and swap traffic, the fault plane's counts and the decode
megasteps.

:meth:`ServingMetrics.counters` is the wall-clock-free slice: identical
request traces on identical engines give identical counters, and the port's
engine gives the reference engine's counters on the same trace, floats
included (every float in it is computed on the host from integers, as the
reference computes it). Seconds live in :meth:`ServingMetrics.summary`
only. The expert-offload and tier counters stay at zero until the port's
engine has those paths; ``counters()`` keeps their keys.

With a fused decode horizon the engine syncs once per megastep, so
:meth:`ServingMetrics.record_megastep` logs each megastep's wall time and
the engine spreads it evenly over the logical steps that emitted tokens;
the per-step gauges (active slots, expert activation, page and capacity
utilization) stay exact per logical step.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ServingMetrics"]


def _mean(xs) -> float:
    return float(np.mean(xs)) if len(xs) else 0.0


def _p95(xs) -> float:
    return float(np.percentile(xs, 95)) if len(xs) else 0.0


@dataclasses.dataclass
class ServingMetrics:
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    prefill_s: List[float] = dataclasses.field(default_factory=list)
    decode_step_s: List[float] = dataclasses.field(default_factory=list)
    active_per_step: List[int] = dataclasses.field(default_factory=list)
    queue_depth: List[int] = dataclasses.field(default_factory=list)
    expert_activation: List[float] = dataclasses.field(default_factory=list)
    page_utilization: List[float] = dataclasses.field(default_factory=list)
    capacity_utilization: List[float] = dataclasses.field(default_factory=list)
    admissions: List[Dict] = dataclasses.field(default_factory=list)
    # re-admissions of preempted requests (kept out of ``admissions`` so
    # queue-depth / TTFT / mid-flight summaries stay honest under churn —
    # a resumed victim is pool pressure, not fresh demand)
    readmissions: List[Dict] = dataclasses.field(default_factory=list)
    slot_releases: List[Dict] = dataclasses.field(default_factory=list)
    preemptions: List[Dict] = dataclasses.field(default_factory=list)
    # SLO load-sheds: fresh requests past their TTFT budget rejected at
    # a boundary instead of queueing unboundedly
    sheds: List[Dict] = dataclasses.field(default_factory=list)
    # resource-controller reconciliation: plan count + action histogram
    plans: int = 0
    plan_actions: Dict[str, int] = dataclasses.field(default_factory=dict)
    # decode tokens emitted per tenant (fairness witness)
    tenant_tokens: Dict[str, int] = dataclasses.field(default_factory=dict)
    # wall-clock TTFT per tenant (summary only, never in counters)
    ttft_by_tenant: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    # host-offloaded expert buckets (serving.offload)
    expert_prefetch_hits: int = 0
    expert_prefetch_misses: int = 0
    expert_miss_uploads: int = 0
    expert_prefetch_uploads: int = 0
    expert_miss_bytes: int = 0
    expert_prefetch_bytes: int = 0
    expert_resident_bytes: List[int] = dataclasses.field(default_factory=list)
    # async expert streaming (offload.issue_async/commit_async): rows
    # staged while a megastep computed, rows committed at the flip, and
    # rows dropped because a mid-flight miss/grow staled the batch — all
    # deterministic per trace. The seconds live in summary() only:
    # upload_stall_s is boundary wall time *blocked* on uploads (the
    # whole apply_residency call when synchronous, the residual
    # commit wait when async), upload_hidden_s the issue-time staging
    # cost overlapped with compute.
    uploads_overlapped: int = 0
    uploads_committed: int = 0
    uploads_dropped_stale: int = 0
    upload_stall_s: List[float] = dataclasses.field(default_factory=list)
    upload_hidden_s: List[float] = dataclasses.field(default_factory=list)
    # three-tier expert store: per-tier fetch counts
    # and disk bytes read, fed through tier_fetch lifecycle events
    tier_host_hits: int = 0
    tier_disk_hits: int = 0
    tier_disk_bytes: int = 0
    # fused decode-horizon megasteps (one program dispatch + one host sync
    # covers up to H logical decode steps; replays are offload misses)
    # shared-prefix KV reuse (serving.kvcache.PrefixCache): a *hit*
    # is a fresh admission whose prompt matched a cached prefix —
    # ``prefix_tokens_saved`` counts the prompt tokens it did not
    # re-prefill, ``prefix_full_hits`` the admissions that skipped
    # prefill entirely (full-prompt match, cached first-token logits) —
    # and ``cow_copies`` the partial tail pages duplicated
    # copy-on-write. Misses are fresh admissions checked against an
    # enabled cache that matched nothing.
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_full_hits: int = 0
    prefix_tokens_saved: int = 0
    cow_copies: int = 0
    # fault plane (serving.faults): injections observed per site,
    # recoveries (upload retries / swap recompute fallbacks / degraded
    # serves) and typed terminations (cancel / deadline / poisoned) —
    # all integer counts so they replay bit-identically
    fault_injected: int = 0
    faults_by_site: Dict[str, int] = dataclasses.field(default_factory=dict)
    upload_retries: int = 0
    degraded_serves: int = 0
    swap_fallbacks: int = 0
    cancelled: int = 0
    deadline_exceeded: int = 0
    poisoned: int = 0
    megasteps: int = 0
    megastep_logical_steps: List[int] = dataclasses.field(default_factory=list)
    decode_compute_s: List[float] = dataclasses.field(default_factory=list)
    decode_offload_s: List[float] = dataclasses.field(default_factory=list)
    decode_dispatches: int = 0
    decode_replays: int = 0
    decode_host_syncs: int = 0
    prefill_dispatches: int = 0
    prefill_replays: int = 0

    # ------------------------------------------------------------ record
    def record_admission(
        self, rid: int, slot: int, step_idx: int, active_before: int,
        queue_depth: int, resumed: bool = False, tenant: str = "default",
        priority: int = 0, wait_steps: int = -1,
    ) -> None:
        """``queue_depth`` is the waiting-queue depth *at admission time*,
        i.e. including the request being admitted (the engine samples it
        before the scheduler pops the queue head). ``resumed=True``
        delegates to :meth:`record_readmission` — a preempted request
        re-entering is not fresh demand and must not distort queue-depth
        or TTFT bookkeeping (its TTFT anchor stays the original
        ``arrival_s``)."""
        rec = {"rid": rid, "slot": slot, "step": step_idx,
               "active_before": active_before, "queue_depth": queue_depth,
               "resumed": resumed, "tenant": tenant, "priority": priority,
               "wait_steps": wait_steps}
        if resumed:
            self.record_readmission(rec)
        else:
            self.admissions.append(rec)

    def record_readmission(self, rec: Dict) -> None:
        """A preempted request re-acquired a slot (churn, not demand)."""
        self.readmissions.append(dict(rec, resumed=True))

    def record_shed(self, rid: int, step_idx: int, tenant: str = "default",
                    priority: int = 0, wait_steps: int = 0) -> None:
        """One fresh request rejected past its TTFT budget."""
        self.sheds.append(
            {"rid": rid, "step": step_idx, "tenant": tenant,
             "priority": priority, "wait_steps": wait_steps}
        )

    def record_plan(self, n_actions: int, **kind_counts: int) -> None:
        """One non-empty controller plan: total actions plus the
        per-kind histogram (admits/preempts/grows/…)."""
        self.plans += 1
        for k, v in kind_counts.items():
            if v:
                self.plan_actions[k] = self.plan_actions.get(k, 0) + int(v)

    def record_tenant_tokens(self, tenant: str, n: int) -> None:
        if n > 0:
            self.tenant_tokens[tenant] = self.tenant_tokens.get(tenant, 0) + int(n)

    def record_ttft(self, seconds: float, prefill_seconds: float,
                    tenant: str = "default") -> None:
        self.ttft_s.append(seconds)
        self.prefill_s.append(prefill_seconds)
        self.ttft_by_tenant.setdefault(tenant, []).append(seconds)

    def record_decode_step(
        self, seconds: float, n_active: int, expert_activation: float,
        queue_depth: int, page_utilization: Optional[float] = None,
    ) -> None:
        """``page_utilization=None`` means the caller has no pool gauge —
        the sample is skipped, not recorded as a real 0.0 (which would
        drag ``page_util_mean`` down)."""
        self.decode_step_s.append(seconds)
        self.active_per_step.append(n_active)
        self.expert_activation.append(expert_activation)
        self.queue_depth.append(queue_depth)
        if page_utilization is not None:
            self.page_utilization.append(page_utilization)

    def record_megastep(
        self, logical_steps: int, compute_s: float, offload_s: float,
        dispatches: int, syncs: int,
    ) -> None:
        """One fused decode megastep: ``logical_steps`` token-emitting
        horizon steps, timed as ``compute_s`` (first program run — pure
        decode math) + ``offload_s`` (miss uploads and replays, which
        previously conflated into the decode timer); ``dispatches``
        counts program invocations including replays and
        ``syncs`` the device→host fetches. The count fields are
        deterministic per trace and land in :meth:`counters`; the
        seconds land in :meth:`summary` only."""
        self.megasteps += 1
        self.megastep_logical_steps.append(int(logical_steps))
        self.decode_compute_s.append(float(compute_s))
        self.decode_offload_s.append(float(offload_s))
        self.decode_dispatches += int(dispatches)
        self.decode_replays += int(dispatches) - 1
        self.decode_host_syncs += int(syncs)

    def record_prefill_runs(self, dispatches: int) -> None:
        """One prefill chunk's program invocations (> 1 ⇒ offload
        replays)."""
        self.prefill_dispatches += int(dispatches)
        self.prefill_replays += int(dispatches) - 1

    def record_capacity_utilization(self, frac: float) -> None:
        """Routed (token, choice) pairs ÷ total expert capacity rows for
        one logical step (decode step or prefill chunk) — derived from
        the program's reported ``slot_counts``, so it is
        deterministic per trace."""
        self.capacity_utilization.append(float(frac))

    def record_release(self, rid: int, slot: int, step_idx: int) -> None:
        self.slot_releases.append({"rid": rid, "slot": slot, "step": step_idx})

    def record_preemption(
        self, rid: int, slot: int, step_idx: int, mode: str,
        swap_bytes: int = 0, tenant: str = "default", for_rid: int = -1,
        for_tenant: str = "",
    ) -> None:
        """``for_rid``/``for_tenant`` identify the beneficiary — the
        growing/admitting request the freed pages serve (cross-tenant
        preemption is visible as ``tenant != for_tenant``)."""
        self.preemptions.append(
            {"rid": rid, "slot": slot, "step": step_idx, "mode": mode,
             "swap_bytes": swap_bytes, "tenant": tenant,
             "for_rid": for_rid, "for_tenant": for_tenant}
        )
        self.swap_out_bytes += swap_bytes

    def record_swap_in(self, nbytes: int) -> None:
        self.swap_in_bytes += nbytes

    def record_expert_hit(self) -> None:
        """One logical step (decode step / prefill chunk) found its whole
        working set resident on the first run — no replay."""
        self.expert_prefetch_hits += 1

    def record_expert_miss_step(self) -> None:
        """One logical step needed ≥ 1 replay before accepting."""
        self.expert_prefetch_misses += 1

    def record_expert_miss(self, uploads: int, nbytes: int) -> None:
        """One replay's synchronous uploads (``uploads`` expert rows);
        the owning step is counted once via :meth:`record_expert_miss_step`."""
        self.expert_miss_uploads += uploads
        self.expert_miss_bytes += nbytes

    def record_expert_prefetch(self, uploads: int, nbytes: int) -> None:
        """Ahead-of-need uploads driven by the router-stats EMA."""
        self.expert_prefetch_uploads += uploads
        self.expert_prefetch_bytes += nbytes

    def record_expert_residency(self, nbytes: int) -> None:
        self.expert_resident_bytes.append(int(nbytes))

    def record_async_issue(self, uploads: int, hidden_s: float) -> None:
        """One staged (double-buffered) upload batch issued while a
        program computed: ``uploads`` rows overlapped; ``hidden_s`` is
        the host-side staging time hidden behind the dispatch."""
        self.uploads_overlapped += int(uploads)
        self.upload_hidden_s.append(float(hidden_s))

    def record_async_commit(self, committed: int, dropped: int,
                            nbytes: int, wait_s: float) -> None:
        """One boundary flip: ``committed`` staged rows swapped in (they
        count as prefetch uploads — same traffic, different timing) or
        ``dropped`` rows invalidated by a mid-flight miss/grow;
        ``wait_s`` is the residual un-hidden transfer wait."""
        self.uploads_committed += int(committed)
        self.uploads_dropped_stale += int(dropped)
        if committed:
            self.record_expert_prefetch(int(committed), int(nbytes))
        self.upload_stall_s.append(float(wait_s))

    def record_upload_stall(self, seconds: float) -> None:
        """Boundary wall time blocked on a synchronous prefetch upload
        (the whole apply_residency call). Folded into
        ``decode_offload_frac`` so the synchronous baseline's stall is
        attributable — and erasable by async overlap."""
        self.upload_stall_s.append(float(seconds))

    def record_tier_fetch(self, tier: str, nbytes: int) -> None:
        """One expert-row fetch through the tiered backing store."""
        if tier == "host":
            self.tier_host_hits += 1
        else:
            self.tier_disk_hits += 1
            self.tier_disk_bytes += int(nbytes)

    def record_prefix_hit(self, tokens_saved: int, full: bool = False) -> None:
        """One fresh admission reused a cached prefix: ``tokens_saved``
        prompt tokens skipped prefill; ``full`` means the whole prompt
        (and its first-token logits) was cached — zero prefill
        dispatches for the request."""
        self.prefix_hits += 1
        self.prefix_tokens_saved += int(tokens_saved)
        if full:
            self.prefix_full_hits += 1

    def record_prefix_miss(self) -> None:
        """One fresh admission probed an enabled prefix cache and
        matched nothing (it prefills fully, then registers)."""
        self.prefix_misses += 1

    def record_cow_copy(self) -> None:
        """One copy-on-write duplication of a shared partial tail page."""
        self.cow_copies += 1

    # ------------------------------------------------------- fault plane
    def record_fault(self, site: str) -> None:
        """One injected fault fired at ``site`` (FaultPlan.fire)."""
        self.fault_injected += 1
        self.faults_by_site[site] = self.faults_by_site.get(site, 0) + 1

    def record_upload_retry(self) -> None:
        """One expert-upload attempt repeated after a transient fault or
        checksum mismatch (the recovered attempt, not the failure)."""
        self.upload_retries += 1

    def record_degrade(self) -> None:
        """One expert row pinned to a lower rung of the PMQ precision
        ladder after its target-bit upload persistently failed."""
        self.degraded_serves += 1

    def record_swap_fallback(self) -> None:
        """One preempted request whose KV swap payload failed checksum
        or I/O and fell back to bit-exact recompute re-prefill."""
        self.swap_fallbacks += 1

    def record_cancel(self) -> None:
        """One request terminated by client ``cancel(rid)``."""
        self.cancelled += 1

    def record_deadline(self) -> None:
        """One request terminated past its ``deadline_steps``."""
        self.deadline_exceeded += 1

    def record_poisoned(self) -> None:
        """One request terminated by the non-finite logits guard."""
        self.poisoned += 1

    # ----------------------------------------------------------- derived
    @property
    def mid_flight_admissions(self) -> int:
        """Admissions into a batch that was already decoding (turnover).

        Resumed re-admissions of preempted requests are excluded — they
        are pressure artifacts, not the continuous-batching signature
        this metric exists to surface.
        """
        return sum(
            1 for a in self.admissions
            if a["step"] > 0 and a["active_before"] > 0
            and not a.get("resumed")
        )

    @property
    def expert_hit_rate(self) -> float:
        """Fraction of logical steps served without any replay."""
        total = self.expert_prefetch_hits + self.expert_prefetch_misses
        return self.expert_prefetch_hits / total if total else 1.0

    @property
    def expert_upload_bytes(self) -> int:
        """Total host→device expert traffic (prefetch + miss)."""
        return self.expert_miss_bytes + self.expert_prefetch_bytes

    def counters(self) -> Dict:
        """The wall-clock-free slice of the metrics: identical traces on
        identical engines must produce *identical* counters (the
        deterministic-replay test asserts dict equality on this)."""
        return {
            "admissions": list(self.admissions),
            "readmissions": list(self.readmissions),
            "sheds": list(self.sheds),
            "plans": self.plans,
            "plan_actions": dict(sorted(self.plan_actions.items())),
            "tenant_tokens": dict(sorted(self.tenant_tokens.items())),
            "slot_releases": list(self.slot_releases),
            "preemptions": list(self.preemptions),
            "swap_out_bytes": self.swap_out_bytes,
            "swap_in_bytes": self.swap_in_bytes,
            "active_per_step": list(self.active_per_step),
            "queue_depth": list(self.queue_depth),
            "page_utilization": list(self.page_utilization),
            "capacity_utilization": list(self.capacity_utilization),
            "generated_tokens": int(np.sum(self.active_per_step)) if self.active_per_step else 0,
            "expert_prefetch_hits": self.expert_prefetch_hits,
            "expert_prefetch_misses": self.expert_prefetch_misses,
            "expert_miss_uploads": self.expert_miss_uploads,
            "expert_prefetch_uploads": self.expert_prefetch_uploads,
            "expert_miss_bytes": self.expert_miss_bytes,
            "expert_prefetch_bytes": self.expert_prefetch_bytes,
            "expert_resident_bytes": list(self.expert_resident_bytes),
            "uploads_overlapped": self.uploads_overlapped,
            "uploads_committed": self.uploads_committed,
            "uploads_dropped_stale": self.uploads_dropped_stale,
            "tier_host_hits": self.tier_host_hits,
            "tier_disk_hits": self.tier_disk_hits,
            "tier_disk_bytes": self.tier_disk_bytes,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_full_hits": self.prefix_full_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "cow_copies": self.cow_copies,
            "fault_injected": self.fault_injected,
            "faults_by_site": dict(sorted(self.faults_by_site.items())),
            "upload_retries": self.upload_retries,
            "degraded_serves": self.degraded_serves,
            "swap_fallbacks": self.swap_fallbacks,
            "cancelled": self.cancelled,
            "deadline_exceeded": self.deadline_exceeded,
            "poisoned": self.poisoned,
            "megasteps": self.megasteps,
            "megastep_logical_steps": list(self.megastep_logical_steps),
            "decode_dispatches": self.decode_dispatches,
            "decode_replays": self.decode_replays,
            "decode_host_syncs": self.decode_host_syncs,
            "prefill_dispatches": self.prefill_dispatches,
            "prefill_replays": self.prefill_replays,
        }

    def summary(self) -> Dict[str, float]:
        total_decode = float(np.sum(self.decode_step_s)) if self.decode_step_s else 0.0
        gen_tokens = int(np.sum(self.active_per_step)) if self.active_per_step else 0
        return {
            "requests": len(self.ttft_s),
            "ttft_mean_s": _mean(self.ttft_s),
            "ttft_p95_s": _p95(self.ttft_s),
            "prefill_mean_s": _mean(self.prefill_s),
            "decode_step_mean_s": _mean(self.decode_step_s),
            "decode_step_p95_s": _p95(self.decode_step_s),
            # only *active* slots count as generated tokens — no dummy
            # padding inflates throughput here; an empty run reports None
            # (distinguishable from an infinitely-amortized one)
            "tokens_per_s": (
                gen_tokens / total_decode
                if gen_tokens and total_decode else None
            ),
            "generated_tokens": gen_tokens,
            "queue_depth_mean": _mean(self.queue_depth),
            "queue_depth_max": float(max(self.queue_depth)) if self.queue_depth else 0.0,
            "expert_activation_mean": _mean(self.expert_activation),
            "mid_flight_admissions": self.mid_flight_admissions,
            "slot_releases": len(self.slot_releases),
            "preemptions": len(self.preemptions),
            "readmissions": len(self.readmissions),
            "sheds": len(self.sheds),
            "plans": int(self.plans),
            "plan_actions": dict(sorted(self.plan_actions.items())),
            "tenant_tokens": dict(sorted(self.tenant_tokens.items())),
            "ttft_p95_s_by_tenant": {
                t: _p95(xs)
                for t, xs in sorted(self.ttft_by_tenant.items())
            },
            "swap_out_bytes": int(self.swap_out_bytes),
            "swap_in_bytes": int(self.swap_in_bytes),
            "swap_bytes": int(self.swap_out_bytes + self.swap_in_bytes),
            "page_util_mean": _mean(self.page_utilization),
            "page_util_p95": _p95(self.page_utilization),
            "capacity_util_mean": _mean(self.capacity_utilization),
            "capacity_util_p95": _p95(self.capacity_utilization),
            "expert_hit_rate": self.expert_hit_rate,
            "expert_prefetch_misses": int(self.expert_prefetch_misses),
            "expert_miss_uploads": int(self.expert_miss_uploads),
            "expert_prefetch_uploads": int(self.expert_prefetch_uploads),
            "expert_miss_bytes": int(self.expert_miss_bytes),
            "expert_prefetch_bytes": int(self.expert_prefetch_bytes),
            "expert_upload_bytes": int(self.expert_upload_bytes),
            "expert_resident_bytes_last": (
                int(self.expert_resident_bytes[-1])
                if self.expert_resident_bytes else 0
            ),
            "prefix_hits": int(self.prefix_hits),
            "prefix_misses": int(self.prefix_misses),
            "prefix_full_hits": int(self.prefix_full_hits),
            "prefix_tokens_saved": int(self.prefix_tokens_saved),
            "prefix_hit_rate": (
                self.prefix_hits / (self.prefix_hits + self.prefix_misses)
                if (self.prefix_hits + self.prefix_misses) else None
            ),
            "cow_copies": int(self.cow_copies),
            "fault_injected": int(self.fault_injected),
            "upload_retries": int(self.upload_retries),
            "degraded_serves": int(self.degraded_serves),
            "swap_fallbacks": int(self.swap_fallbacks),
            "cancelled": int(self.cancelled),
            "deadline_exceeded": int(self.deadline_exceeded),
            "poisoned": int(self.poisoned),
            "megasteps": int(self.megasteps),
            "decode_compute_mean_s": _mean(self.decode_compute_s),
            "decode_offload_mean_s": _mean(self.decode_offload_s),
            # expert-streaming time a request actually waited for: miss
            # uploads + replays (decode_offload_s) plus boundary upload
            # stalls — synchronous prefetch pays the whole upload here,
            # async overlap only its residual commit wait, which is what
            # the async-offload bench leg gates on
            "decode_offload_frac": (
                (float(np.sum(self.decode_offload_s))
                 + float(np.sum(self.upload_stall_s)))
                / max(float(np.sum(self.decode_compute_s))
                      + float(np.sum(self.decode_offload_s))
                      + float(np.sum(self.upload_stall_s)), 1e-12)
                if (self.decode_compute_s or self.upload_stall_s) else 0.0
            ),
            "upload_stall_s": float(np.sum(self.upload_stall_s)),
            "upload_hidden_s": float(np.sum(self.upload_hidden_s)),
            "uploads_overlapped": int(self.uploads_overlapped),
            "uploads_committed": int(self.uploads_committed),
            "uploads_dropped_stale": int(self.uploads_dropped_stale),
            "tier_host_hits": int(self.tier_host_hits),
            "tier_disk_hits": int(self.tier_disk_hits),
            "tier_disk_bytes": int(self.tier_disk_bytes),
            "decode_dispatches": int(self.decode_dispatches),
            "decode_replays": int(self.decode_replays),
            "decode_host_syncs": int(self.decode_host_syncs),
            "prefill_dispatches": int(self.prefill_dispatches),
            "prefill_replays": int(self.prefill_replays),
            # the horizon's deterministic win: program dispatches and host
            # syncs per generated token drop from ~1 toward ~1/H; None
            # when nothing was generated (0.0 would read as free)
            "dispatches_per_token": (
                self.decode_dispatches / gen_tokens if gen_tokens else None
            ),
            "syncs_per_token": (
                self.decode_host_syncs / gen_tokens if gen_tokens else None
            ),
            # ... and per *logical decode step* from exactly 1 toward 1/H
            # (per-token folds in batch width; per-step isolates the
            # horizon amortization itself)
            "dispatches_per_step": (
                self.decode_dispatches
                / max(int(np.sum(self.megastep_logical_steps)), 1)
                if self.megastep_logical_steps else None
            ),
        }

    def to_json(self, include_counters: bool = False) -> str:
        """Summary as JSON; ``include_counters=True`` nests the
        wall-clock-free :meth:`counters` slice alongside it under
        ``{"summary": …, "counters": …}`` so the deterministic data is
        serializable too (the default shape is unchanged)."""
        if include_counters:
            return json.dumps(
                {"summary": self.summary(), "counters": self.counters()},
                sort_keys=True,
            )
        return json.dumps(self.summary(), sort_keys=True)
