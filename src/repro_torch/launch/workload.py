"""The full-width serving workloads: what ``chip_smoke.py`` serves and
:mod:`repro_torch.launch.profile_decode` traces. One definition, so the
profile describes the run whose tokens/s are reported beside it.

``moonshot-v1-16b-a3b`` at full width and all 48 layers in bf16 with random
PMQ + OTP weights from seed 0 (:func:`build_synthetic`).

* ``ENGINE`` / :func:`requests`: fp KV; 4 requests of 64 prompt tokens
  (numpy seed 2) and 32 new tokens each, served 4 slots at a time with
  16-token pages, 16-token prefill chunks and 8-step megasteps.
* ``SHARED_PREFIX`` / :func:`shared_prefix_requests`: the same geometry
  with int8 KV and the prefix cache — chat serving where every request
  carries one 48-token system prompt (3 pages), plus a retried prompt.
  r0 and r1 add 16 tokens each, r2 adds 8, and r3 repeats r2 exactly: a
  full hit ending mid-page, whose tail page is copied (codes and tables).
  By the reference's admission rules this prefills 6 chunks instead of 16
  (r0 4, r1 1, r2 1, r3 none) with one copy-on-write page copy.

* ``TENANT_MIX`` / :func:`tenant_mix_requests`: multi-tenant chat serving
  through the control plane, fp KV on a pool cut to 14 pages so the tenants
  queue for pages and slots. A long-document ``batch`` tenant (2 × 64
  prompt + 32 new, priority 0) and a burst of ``chat`` turns (3 × 32 + 16,
  priority 1) arrive at the first megastep boundary; latency-bound
  ``interactive`` calls (3 × 16 + 8, priority 2) arrive at boundaries 2, 4
  and 6 (:func:`serve_tenant_mix`). Prompts from numpy seed 3, no EOS.
  ``policy="fair"`` with weights 1 / 2 / 4, a TTFT budget of 7 logical
  steps (a request still blocked past it is shed, not queued), and
  :func:`tenant_mix_faults`: a ``pool`` fault hiding 8 of the 14 pages at
  the two boundaries from logical step 16 on (an outage the interactive
  call arriving then waits out past its budget) and a ``logits`` fault
  poisoning chat request 3. Under ``fair`` and ``priority`` an
  interactive call is first in admission order and needs 2 pages, which
  the pool always has at its arrival; only a shortage that outlasts a
  boundary holds it past a budget, so a one-boundary 4-page fault sheds
  none. With no EOS and full reservation the schedule depends only on
  the lengths, the geometry, the policy and the fault plan, never on the
  weights: ``TENANT_MIX_COUNTERS`` are the reference engine's schedule
  counters on these settings (``tests/test_torch_serving_control.py``
  computes them with ``repro.serving.PagedServingEngine``).

Two more models serve ``ENGINE``'s geometry and :func:`requests` (bf16, fp
KV, random weights from seed 0, :func:`build_uncompressed`):

* ``DENSE`` (:func:`build_dense`): ``qwen3-14b`` at full width, all 40
  layers — d_model 5120, 40 query and 8 KV heads of 128 (G = 5), d_ff
  17408, vocab 151936, ``qk_norm``; ~29.5 GB.
* ``UNCOMPRESSED_MOE`` (:func:`build_uncompressed_moe`):
  ``moonshot-v1-16b-a3b`` at full width and all 48 layers without PMQ or
  OTP — the model MC# compresses; ~57.8 GB. Expert capacity is drop-free,
  and the expert FFN reads all 64 experts of a layer every step, as the
  reference's batched einsum does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..configs import get_config
from ..core.synthetic import build_synthetic, build_uncompressed
from ..serving import EngineConfig, FaultPlan, FaultSpec, Request

__all__ = [
    "ARCH",
    "DENSE",
    "DENSE_ARCH",
    "ENGINE",
    "MAX_NEW",
    "SHARED_PREFIX",
    "SHARED_PREFIX_CHUNKS",
    "SHARED_PREFIX_COW_COPIES",
    "TENANT_MIX",
    "TENANT_MIX_COUNTERS",
    "UNCOMPRESSED_MOE",
    "build",
    "build_dense",
    "build_uncompressed_moe",
    "requests",
    "serve_tenant_mix",
    "shared_prefix_requests",
    "tenant_mix_faults",
    "tenant_mix_requests",
]

ARCH = "moonshot-v1-16b-a3b"
PROMPT_LEN, MAX_NEW, NUM_REQUESTS = 64, 32, 4
ENGINE = EngineConfig(max_slots=4, block_size=16, num_blocks=24, max_blocks_per_slot=6,
                      prefill_chunk=16, decode_horizon=8, reserve_full=True, use_otp=True)
SHARED_PREFIX = dataclasses.replace(ENGINE, kv_bits=8, prefix_cache=True)
SYSTEM_PROMPT_LEN = 48
#: prefill chunks and COW page copies of SHARED_PREFIX under the reference's rules
SHARED_PREFIX_CHUNKS, SHARED_PREFIX_COW_COPIES = 6, 1
DENSE_ARCH = "qwen3-14b"
#: the dense and uncompressed-MoE paths serve the fp workload's geometry
DENSE = UNCOMPRESSED_MOE = ENGINE
#: (tenant, requests, prompt tokens, new tokens, priority, arrival boundaries)
TENANTS = (("batch", 2, 64, 32, 0, (0, 0)),
           ("chat", 3, 32, 16, 1, (0, 0, 0)),
           ("interactive", 3, 16, 8, 2, (2, 4, 6)))
TENANT_WEIGHTS = (("batch", 1.0), ("chat", 2.0), ("interactive", 4.0))
TENANT_MIX = dataclasses.replace(ENGINE, num_blocks=14, policy="fair",
                                 tenant_weights=TENANT_WEIGHTS, ttft_budget_steps=7,
                                 trace_level="spans")
#: the chat request the logits fault poisons
TENANT_MIX_POISONED = 3


def _admit(rid, slot, step, active_before, queue_depth, tenant, priority, wait_steps):
    return {"rid": rid, "slot": slot, "step": step, "active_before": active_before,
            "queue_depth": queue_depth, "resumed": False, "tenant": tenant,
            "priority": priority, "wait_steps": wait_steps}


def _util(free_pages: int) -> float:
    return 1.0 - free_pages / TENANT_MIX.num_blocks


#: ``ServingMetrics.counters()`` of the schedule the reference engine gives on
#: TENANT_MIX (any weights; see the module docstring)
TENANT_MIX_COUNTERS = {
    "admissions": [
        _admit(2, 0, 0, 0, 5, "chat", 1, 0), _admit(3, 1, 0, 1, 4, "chat", 1, 0),
        _admit(4, 1, 0, 1, 3, "chat", 1, 0), _admit(0, 2, 8, 2, 2, "batch", 0, 8),
        _admit(6, 1, 32, 1, 1, "interactive", 2, 0), _admit(7, 1, 39, 0, 1, "interactive", 2, 0),
    ],
    "sheds": [{"rid": 1, "step": 8, "tenant": "batch", "priority": 0, "wait_steps": 8},
              {"rid": 5, "step": 24, "tenant": "interactive", "priority": 2, "wait_steps": 8}],
    "plans": 5,
    "plan_actions": {"admits": 6, "sheds": 2},
    "slot_releases": [{"rid": 2, "slot": 0, "step": 14}, {"rid": 4, "slot": 1, "step": 14},
                      {"rid": 0, "slot": 2, "step": 38}, {"rid": 6, "slot": 1, "step": 38},
                      {"rid": 7, "slot": 1, "step": 45}],
    "active_per_step": [2] * 8 + [3] * 7 + [1] * 17 + [2] * 7 + [1] * 7,
    "queue_depth": [2] * 8 + [0] * 8 + [1] * 8 + [0] * 22,
    "page_utilization": ([_util(8)] * 8 + [_util(2)] * 8 + [_util(8)] * 16 + [_util(6)] * 7
                         + [_util(12)] * 7),
    "megastep_logical_steps": [8, 8, 8, 8, 7, 7],
    "tenant_tokens": {"batch": 32, "chat": 32, "interactive": 16},
    "faults_by_site": {"logits": 1, "pool": 2},
    "poisoned": 1,
}


def build(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width model, built on ``device``."""
    cfg = get_config(ARCH)
    return cfg, build_synthetic(cfg, seed=0, device=device)


def build_dense(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width dense model, built on ``device``."""
    cfg = get_config(DENSE_ARCH)
    return cfg, build_uncompressed(cfg, seed=0, device=device)


def build_uncompressed_moe(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width MoE model without compression."""
    cfg = get_config(ARCH)
    return cfg, build_uncompressed(cfg, seed=0, device=device)


def requests(cfg) -> List[Request]:
    """Fresh :class:`Request`s of the workload (the same prompts each call)."""
    rng = np.random.default_rng(2)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=PROMPT_LEN)
                    .astype(np.int32), max_new=MAX_NEW)
            for i in range(NUM_REQUESTS)]


def tenant_mix_requests(cfg) -> List[Tuple[int, Request]]:
    """``(arrival boundary, Request)`` of the tenant mix, rids in
    :data:`TENANTS` order (the same prompts each call)."""
    rng = np.random.default_rng(3)
    out = []
    for tenant, n, prompt_len, max_new, priority, arrivals in TENANTS:
        for i in range(n):
            prompt = rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int32)
            out.append((arrivals[i], Request(rid=len(out), prompt=prompt, max_new=max_new,
                                             tenant=tenant, priority=priority)))
    return out


def tenant_mix_faults() -> FaultPlan:
    """A ``pool`` fault hiding 8 pages at the first two boundaries at
    logical step ≥ 16, a ``logits`` fault on :data:`TENANT_MIX_POISONED`."""
    return FaultPlan([FaultSpec(site="pool", step=16, arg=8, count=2),
                      FaultSpec(site="logits", mode="corrupt", key=TENANT_MIX_POISONED)])


def serve_tenant_mix(engine, arrivals: List[Tuple[int, Request]]) -> Dict[int, List[int]]:
    """Drive ``engine`` boundary by boundary, submitting each request at its
    arrival boundary; returns every rid's output (empty when shed or
    poisoned)."""
    pending = sorted(arrivals, key=lambda a: a[0])
    boundary = 0
    while pending or engine.scheduler.has_work():
        while pending and pending[0][0] <= boundary:
            engine.submit(pending.pop(0)[1])
        if engine.scheduler.has_work():
            engine.step()
        boundary += 1
    return {req.rid: engine.results[req.rid] for _, req in arrivals}


def shared_prefix_requests(cfg) -> List[Request]:
    """Fresh :class:`Request`s of the shared-prefix workload: one 48-token
    system prompt (numpy seed 3), r0/r1 + 16 tokens, r2 + 8, r3 = r2."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab_size, size=SYSTEM_PROMPT_LEN)
    tails = [rng.integers(0, cfg.vocab_size, size=n) for n in (16, 16, 8)]
    prompts = [np.concatenate([system, t]).astype(np.int32) for t in tails]
    prompts.append(prompts[2].copy())
    return [Request(rid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
