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

* ``PREEMPT``: the fp workload (:func:`requests`) on a pool cut to 11 pages
  with page growth (``reserve_full=False``) and ``preempt_mode="swap"`` —
  the setting of a pool sized below worst-case demand. Admission reserves
  the 64-token context plus the first megastep's 8 writes (5 pages), so two
  requests run at a time; at logical step 16 rid 1's growth finds the pool
  empty and it preempts itself (5 pages to the host; 31,457,280 bytes at
  full width and 48 layers, 7,864,320 at ``CUT_LAYERS``), rid 2 takes its
  slot, and rid 1 is swapped back in beside
  rid 3 at step 47. ``PREEMPT_FAULTS`` corrupts rid 1's payload at swap-in,
  so the CRC trips and rid 1 is re-prefilled from its 80-token context (5
  more prefill chunks). ``PREEMPT_COUNTERS`` are the reference engine's
  schedule counters on these settings, computed as ``TENANT_MIX_COUNTERS``
  were; byte counts are left out (:func:`preempt_schedule`), since they
  depend on the widths. ``PREEMPT_FAULT_EVENTS`` is the reference's event
  count at trace level ``full`` under ``PREEMPT_FAULTS`` on a model without
  PMQ routing telemetry; a PMQ model adds one ``routing`` counter per entry
  of ``capacity_utilization``.

* ``OFFLOAD`` / :func:`offload_requests`: the fp geometry with the PMQ
  experts host-offloaded under ``resident_experts=32`` of 64 slots per layer
  (``_split_budget`` gives 1 / 29 / 2 rows to the buckets of 1 / 59 / 4
  experts): one request of 16 prompt tokens (one prefill chunk; numpy seed
  4) and 4 new tokens at ``decode_horizon=1`` — a device holding about half
  of the model's expert bytes. The synthetic routers are close to uniform,
  so the routing EMA cannot predict the next step's experts and the program
  is replayed about once per layer that misses; one short request keeps
  that bounded. ``OFFLOAD_HOST_BYTES`` (256 MiB) bounds the host row cache
  of the tiered run and :func:`offload_faults` corrupts the first two
  upload payloads (caught by the row CRC and fetched again).

* ``COMPRESS``: the uncompressed ``moonshot-v1-16b-a3b`` below compressed on
  the device by the MC# pipeline (:mod:`repro_torch.core.pipeline`):
  calibration on :func:`calibration_tokens` (4 × 64 tokens, numpy seed 0,
  the reference serving CLI's), then ``compress_for_serving`` at its
  settings (Eq. 6 significance over ``pipeline.EPS_TOKENS`` = 128 tokens,
  the DP plan at ``pipeline.TARGET_AVG_BITS`` = 2.05 made layer-uniform,
  4-bit HQQ attention and shared experts, no OTP routers); served on
  ``ENGINE``'s geometry and :func:`requests`. :func:`tiny_pipeline` runs the
  same steps on the reduced model, to hold one device against another.

Three more models serve ``ENGINE``'s geometry and :func:`requests` (bf16, fp
KV, random weights from seed 0, :func:`build_uncompressed`):

* ``DENSE`` (:func:`build_dense`): ``qwen3-14b`` at full width, all 40
  layers — d_model 5120, 40 query and 8 KV heads of 128 (G = 5), d_ff
  17408, vocab 151936, ``qk_norm``; ~29.5 GB.
* ``COMMAND_R`` (:func:`build_command_r`): ``command-r-35b`` at full width,
  all 40 layers — d_model 8192, 64 query and 8 KV heads of 128 (G = 8),
  d_ff 22528, tied vocab 256000; 60.567 GB (30.28 B parameters, derived).
  Each logits call makes an f32 copy of the tied table (8.389 GB,
  ``models/layers.py: logits``).
* ``UNCOMPRESSED_MOE`` (:func:`build_uncompressed_moe`):
  ``moonshot-v1-16b-a3b`` at full width and all 48 layers without PMQ or
  OTP — the model MC# compresses; ~57.8 GB. Expert capacity is drop-free,
  and the expert FFN reads all 64 experts of a layer every step, as the
  reference's batched einsum does.

Three more of the reference's transformer configs, at full width in bf16
with random weights from seed 0:

* ``VLM`` (:func:`build_vlm`): ``llava-next-mistral-7b``, all 32 layers —
  d_model 4096, 32 query and 8 KV heads of 128 (G = 4), d_ff 14336, vocab
  32000; ~14.5 GB (:func:`build_uncompressed`). Served on ``ENGINE``'s
  geometry and :func:`requests` on tokens alone, as the reference's engine
  serves a ``vlm`` model; then the dense-cache ``prefill`` takes
  :func:`vlm_patches` (the anyres stub's 2880 patch embeddings, numpy seed
  5, normal × 0.02) ahead of the first prompt of :func:`requests` and
  decodes ``VLM_PATCH_NEW`` tokens from position 2944 on (a KV cache of
  0.386 GB, derived).
* ``WINDOWED`` (:func:`build_windowed`): ``gemma3-27b``, all 62 layers —
  d_model 5376, 32 query and 16 KV heads of 128 (G = 2), ``qk_norm``, tied
  embeddings, vocab 262144, 5 local layers with a window of 1024 per global
  layer; ~54.0 GB (:func:`build_uncompressed`). :func:`windowed_requests`:
  2 requests of 1088 prompt tokens (numpy seed 6) and 32 new, 2 slots,
  16-token pages, 64-token prefill chunks, H = 8, full reservation (70
  pages a request). Every decode position lies past the window, so the 52
  local layers mask and the 10 global layers do not; the KV costs 507,904
  bytes a token (derived), 1.14 GB for the pool.
* ``WIDE_MOE`` (:func:`build_wide_moe`): ``kimi-k2-1t-a32b`` at full width
  and ``WIDE_MOE_LAYERS`` = 2 of its 61 layers (the depth is the only cut)
  — d_model 7168, 64 query and 8 KV heads of 128 (G = 8), 384 experts
  top-8, 1 shared expert, expert hidden 2048, vocab 163840, untied
  embeddings — with PMQ + OTP weights from :func:`build_synthetic`
  (``bucket_counts(384)`` = 1 / 363 / 20 experts at 1 / 2 / 3 bits); about
  15.7 GB (derived: 4.7 GB of embeddings, 5.5 GB a layer). Served on ``ENGINE``'s geometry and :func:`requests`:
  the bf16 dequant GEMMs at d_model 7168 walk K in chunks, and drop-free
  capacity gives a prefill chunk a ``[384, 128, 7168]`` dispatch buffer.
* ``OTP``: routers trained by ``core.otp_train.train_otp`` (``OTP_TRAIN``)
  on the ``COMPRESS`` tree, on :func:`otp_tokens`, then served on ``ENGINE``'s
  geometry and :func:`requests`.
* ``TRAIN``: ``tinyllama-1.1b`` at full width in f32, its first
  ``TRAIN_LAYERS`` = 11 of 22 layers, trained for ``TRAIN_STEPS`` steps of
  ``TRAIN_BATCH`` × ``TRAIN_SEQ`` tokens (``HostDataLoader``, seed 0)
  through ``launch.train.train_step``, then checkpointed and resumed.

``TENANT_MIX``, ``PREEMPT``, ``OFFLOAD``, ``COMPRESS``'s sampled runs and
``OTP`` take the first ``CUT_LAYERS`` = 12 of the compressed model's 48 layers
(:func:`first_layers`): their checks hold each run to another of the same
depth (``PREEMPT``'s tokens to an unpressured run at that depth), and
their schedule counters depend on no weight.

The three non-transformer families, at full width in bf16 with weights
from their bundle's ``init`` at seed 0 (:func:`build_family`), decoded
greedily through the dense-cache ``prefill`` and ``decode_step``
(:func:`greedy_family`; the paged engine refuses these families, as the
reference's does):

* ``WHISPER``: ``whisper-small`` (12 encoder and 12 decoder layers, d_model
  768, 12 heads of 64, vocab 51865; 0.589 GB): 4 requests of 64 prompt
  tokens over frames ``[4, 1500, 768]`` (numpy seed 0, normal),
  :data:`FAMILY_MAX_NEW` = 32 greedy tokens.
* ``RECURRENT``: ``recurrentgemma-2b`` (26 layers: 8 × (R, R, A) + 2 R,
  d_model 2560, RG-LRU width 2560, 10 query heads over one KV head of 256,
  window 2048, tied vocab 256000; 5.789 GB): 2 requests of 2080 prompt
  tokens, so decode attends past the window, and 32 greedy tokens.
* ``XLSTM``: ``xlstm-350m`` (12 × (mLSTM, sLSTM), d_model 1024, 4 heads,
  mLSTM head width 512, vocab 50304; 0.757 GB): 4 requests of 64 + 32;
  then, on its first :data:`XLSTM_TRAIN_LAYERS` = 12 layers,
  :data:`XLSTM_TRAIN_STEPS` = 3 ``train_step``s in f32 at
  ``XLSTM_TRAIN_BATCH`` × ``XLSTM_TRAIN_SEQ`` = 4 × 256 tokens with 32-bit
  AdamW (the mLSTM scan's chunked recompute keeps ``C`` at 64-step
  boundaries only).

Requests and prompt lengths are :data:`FAMILY_ARCHS`'s, prompts from numpy
seed 7 (:func:`family_batch`); :func:`teacher_forced_logits` is the
decoded tokens' oracle.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..core import pipeline
from ..core.otp_train import OTPTrainConfig
from ..core.packing import PackedTensor
from ..core.synthetic import build_synthetic, build_uncompressed
from ..core.tree import to_device
from ..data.pipeline import make_calibration_tokens
from ..models.registry import get_model
from ..models.transformer import extend_cache
from ..serving import EngineConfig, FaultPlan, FaultSpec, PagedServingEngine, Request

__all__ = [
    "ARCH",
    "COMMAND_R",
    "COMMAND_R_ARCH",
    "COMPRESS",
    "CUT_LAYERS",
    "DENSE",
    "DENSE_ARCH",
    "ENGINE",
    "FAMILY_ARCHS",
    "FAMILY_MAX_NEW",
    "MAX_NEW",
    "OFFLOAD",
    "OFFLOAD_HOST_BYTES",
    "PREEMPT",
    "PREEMPT_COUNTERS",
    "PREEMPT_FAULT_EVENTS",
    "PREEMPT_FAULTS",
    "SHARED_PREFIX",
    "SHARED_PREFIX_CHUNKS",
    "SHARED_PREFIX_COW_COPIES",
    "TENANT_MIX",
    "TENANT_MIX_COUNTERS",
    "UNCOMPRESSED_MOE",
    "VLM",
    "VLM_PATCH_NEW",
    "WIDE_MOE",
    "WINDOWED",
    "TRAIN_LAYERS",
    "XLSTM_TRAIN_BATCH",
    "XLSTM_TRAIN_LAYERS",
    "XLSTM_TRAIN_SEQ",
    "XLSTM_TRAIN_STEPS",
    "build",
    "build_command_r",
    "build_dense",
    "build_family",
    "build_uncompressed_moe",
    "build_vlm",
    "build_wide_moe",
    "build_windowed",
    "calibration_tokens",
    "family_batch",
    "first_layers",
    "greedy_family",
    "offload_faults",
    "offload_requests",
    "packed_code_bytes",
    "preempt_schedule",
    "otp_tokens",
    "requests",
    "serve_tenant_mix",
    "shared_prefix_requests",
    "teacher_forced_logits",
    "tenant_mix_faults",
    "tenant_mix_requests",
    "tiny_pipeline",
    "vlm_patches",
    "windowed_requests",
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
COMMAND_R_ARCH = "command-r-35b"
#: the dense, command-r, uncompressed-MoE and pipeline-compressed paths
#: serve the fp workload's geometry
DENSE = COMMAND_R = UNCOMPRESSED_MOE = COMPRESS = ENGINE
VLM_ARCH, WINDOWED_ARCH, WIDE_MOE_ARCH = ("llava-next-mistral-7b", "gemma3-27b",
                                          "kimi-k2-1t-a32b")
#: the llava and kimi-k2 paths serve the fp workload's geometry too
VLM = WIDE_MOE = ENGINE
VLM_PATCH_SEED, VLM_PATCH_NEW = 5, 16
WINDOWED_PROMPT_LEN, WINDOWED_MAX_NEW, WINDOWED_REQUESTS = 1088, 32, 2
WINDOWED = EngineConfig(max_slots=2, block_size=16, num_blocks=140, max_blocks_per_slot=70,
                        prefill_chunk=64, decode_horizon=8, reserve_full=True)
WIDE_MOE_LAYERS = 2
#: the compression pipeline's settings (the reference serving CLI's)
CALIB_BATCHES, CALIB_LEN, CALIB_SEED = 4, 64, 0
#: OTP router training on the pipeline-compressed model (``OTP``): the
#: reference's ``test_otp_training_increases_mask_ratio_and_keeps_kl_low``
#: settings (λ = 2, lr 5e-3, batch 4) for 20 steps (30 there: the mask ratio
#: has risen by step 20 at full width, and the script's time limit is shared),
#: on 32 synthetic calibration samples of 64 tokens
OTP_TRAIN = OTPTrainConfig(steps=20, batch=4, lr=5e-3, lam=2.0, tau=1.0, seed=0)
OTP_SAMPLES, OTP_SEQ, OTP_SEED = 32, 64, 3
#: full-width training of a dense model through ``launch.train.train_step``
#: (``TRAIN``): f32 params, AdamW with 32-bit moments at ``train_reduced``'s
#: lr, ``HostDataLoader`` batches; then the same steps with 8-bit moments,
#: whose linear code for ``v`` makes a step of ``lr · m̂ / eps`` where a
#: small ``v`` rounds to 0 and the row's gradient is 0 (as the reference's
#: does), reported beside the 32-bit losses
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = "tinyllama-1.1b", 20, 8, 128, 3e-4
#: ``TRAIN``'s depth: the first 11 of tinyllama-1.1b's 22 layers (cut in PR 25
#: for ``chip_smoke.py``'s time; its 13.2 GB checkpoint round trip dominated)
TRAIN_LAYERS = 11
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


def _admit(rid, slot, step, active_before, queue_depth, tenant, priority, wait_steps,
           resumed=False):
    return {"rid": rid, "slot": slot, "step": step, "active_before": active_before,
            "queue_depth": queue_depth, "resumed": resumed, "tenant": tenant,
            "priority": priority, "wait_steps": wait_steps}


def _util(free_pages: int, pool: int = TENANT_MIX.num_blocks) -> float:
    return 1.0 - free_pages / pool


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


PREEMPT = dataclasses.replace(ENGINE, num_blocks=11, reserve_full=False, preempt_mode="swap")
#: a plan counts its firings: each run takes a fresh copy, ``PREEMPT_FAULTS.replay()``
PREEMPT_FAULTS = FaultPlan([FaultSpec(site="swap_in", mode="corrupt", key=1)])
#: the request PREEMPT preempts, and its pages at the preemption
PREEMPT_VICTIM, PREEMPT_VICTIM_PAGES = 1, 5
PREEMPT_FAULT_EVENTS = 131


def _held(pages: int, steps: int) -> List[float]:
    return [_util(11 - pages, PREEMPT.num_blocks)] * steps


#: the schedule keys of ``ServingMetrics.counters()`` the reference engine
#: gives on PREEMPT (any weights and widths; see the module docstring)
PREEMPT_COUNTERS = {
    "admissions": [_admit(0, 0, 0, 0, 4, "default", 0, 0), _admit(1, 1, 0, 1, 3, "default", 0, 0),
                   _admit(2, 1, 16, 1, 3, "default", 0, 16),
                   _admit(3, 0, 47, 1, 1, "default", 0, 47)],
    "readmissions": [_admit(1, 1, 47, 0, 2, "default", 0, 47, resumed=True)],
    "preemptions": [{"rid": 1, "slot": 1, "step": 16, "mode": "swap", "tenant": "default",
                     "for_rid": 1, "for_tenant": "default"}],
    "plans": 5,
    "plan_actions": {"admits": 5, "grows": 3, "preempts": 1},
    "slot_releases": [{"rid": 0, "slot": 0, "step": 30}, {"rid": 2, "slot": 1, "step": 46},
                      {"rid": 1, "slot": 1, "step": 61}, {"rid": 3, "slot": 0, "step": 77}],
    "active_per_step": [2] * 31 + [1] * 16 + [2] * 15 + [1] * 16,
    "queue_depth": [2] * 47 + [0] * 31,
    "page_utilization": (_held(10, 16) + _held(11, 16) + _held(6, 15) + _held(11, 16)
                         + _held(6, 15)),
    "megastep_logical_steps": [8, 8, 8, 8, 8, 7, 8, 8, 8, 7],
    "megasteps": 10,
    "prefill_dispatches": 16,
    "swap_fallbacks": 0,
    "tenant_tokens": {"default": 128},
}


OFFLOAD = dataclasses.replace(ENGINE, decode_horizon=1, resident_experts=32)
#: the depth the tenant-mix, preemption, offload, sampled and OTP runs take
#: of the 48-layer compressed model
CUT_LAYERS = 12
OFFLOAD_PROMPT_LEN, OFFLOAD_MAX_NEW = 16, 4
OFFLOAD_HOST_BYTES = 256 << 20


#: the non-transformer families' workloads: arch → (requests, prompt tokens)
FAMILY_ARCHS = {"whisper-small": (4, 64), "recurrentgemma-2b": (2, 2080), "xlstm-350m": (4, 64)}
FAMILY_MAX_NEW, FAMILY_SEED, FRAMES_SEED = 32, 7, 0
XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 3, 4, 256
#: the xlstm training's depth: 12 of xlstm-350m's 24 layers (cut in PR 25 for
#: ``chip_smoke.py``'s time)
XLSTM_TRAIN_LAYERS = 12


def first_layers(cfg, params, n: int):
    """``(cfg, params)`` cut to the first ``n`` layers (the tensors shared,
    not copied)."""
    return dataclasses.replace(cfg, num_layers=n), dict(params, layers=params["layers"][:n])


def build_family(arch: str, device="cuda", dtype=None,
                 num_layers: Optional[int] = None) -> Tuple[object, Dict]:
    """``(cfg, params)`` of a whisper, recurrentgemma or xlstm model at full
    width (``dtype`` and ``num_layers`` replacing the config's), its
    bundle's ``init`` at seed 0 on ``device``."""
    cfg = get_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return cfg, get_model(cfg).init(torch.Generator(device=device).manual_seed(0))


def family_batch(cfg, n: int, prompt_len: int, device="cuda") -> Dict[str, torch.Tensor]:
    """``{"tokens" [n, prompt_len]}`` (numpy seed 7), plus whisper's
    ``"frames" [n, encoder_seq, d_model]`` (numpy seed 0, normal) in the
    config's dtype."""
    rng = np.random.default_rng(FAMILY_SEED)
    toks = rng.integers(0, cfg.vocab_size, (n, prompt_len))
    batch = {"tokens": torch.as_tensor(toks, device=device)}
    if cfg.family == "encdec":
        frames = np.random.default_rng(FRAMES_SEED).normal(
            size=(n, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        batch["frames"] = torch.as_tensor(frames, device=device).to(dt)
    return batch


def greedy_family(cfg, params, batch, max_new: int):
    """Greedy decoding through the dense-cache ``prefill`` and
    ``max_new − 1`` ``decode_step``s (a cache holding ``k`` extended by
    ``max_new`` rows first, as the reference's wave batcher does), without a
    graph: ``(tokens [B, max_new] on the host, per-step logits [max_new, B,
    V] f32 on the host, prefill seconds, decode seconds)``; on a CUDA batch
    the device is drained before each clock read."""
    bundle = get_model(cfg)

    def sync():
        if batch["tokens"].is_cuda:
            torch.cuda.synchronize(batch["tokens"].device)

    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        cache, logits = bundle.prefill(params, batch)
        sync()
        t1 = time.perf_counter()
        if "k" in cache:
            cache = extend_cache(cache, max_new)
        pos = cache["pos"]
        steps = [logits[:, -1].float().cpu()]
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks = [cur]
        for i in range(max_new - 1):
            cache, logits = bundle.decode_step(params, cache, cur, pos + i)
            steps.append(logits[:, -1].float().cpu())
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(cur)
        sync()
        t2 = time.perf_counter()
    return torch.cat(toks, dim=1).cpu(), torch.stack(steps), t1 - t0, t2 - t1


def teacher_forced_logits(cfg, params, batch, tokens: torch.Tensor) -> torch.Tensor:
    """One full forward over each prompt and its decoded ``tokens [B, N]``
    (all but the last): the logits ``[B, N, V]`` (f32, on the host) at the
    N positions that chose them."""
    prompt = batch["tokens"]
    s = prompt.shape[1]
    seq = torch.cat([prompt, tokens[:, :-1].to(prompt.device)], dim=1)
    with torch.no_grad():
        hidden = get_model(cfg).hidden(params, dict(batch, tokens=seq))
        return torch.matmul(hidden[:, s - 1:].float(), params["embed"].float().t()).cpu()


def offload_requests(cfg) -> List[Request]:
    """The offload workload's one request (the same prompt each call)."""
    rng = np.random.default_rng(4)
    return [Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, size=OFFLOAD_PROMPT_LEN)
                    .astype(np.int32), max_new=OFFLOAD_MAX_NEW)]


def offload_faults() -> FaultPlan:
    """Corrupt the first two expert upload payloads (any row)."""
    return FaultPlan([FaultSpec(site="upload", mode="corrupt", count=2)])


def preempt_schedule(counters: Dict) -> Dict:
    """``counters``' entries under the keys of :data:`PREEMPT_COUNTERS`, the
    preemption records without their byte counts."""
    out = {k: counters[k] for k in PREEMPT_COUNTERS}
    out["preemptions"] = [{k: v for k, v in p.items() if k != "swap_bytes"}
                          for p in counters["preemptions"]]
    return out


def build(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width model, built on ``device``."""
    cfg = get_config(ARCH)
    return cfg, build_synthetic(cfg, seed=0, device=device)


def build_dense(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width dense model, built on ``device``."""
    cfg = get_config(DENSE_ARCH)
    return cfg, build_uncompressed(cfg, seed=0, device=device)


def build_command_r(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of ``command-r-35b`` at full width, all its layers,
    built on ``device``."""
    cfg = get_config(COMMAND_R_ARCH)
    return cfg, build_uncompressed(cfg, seed=0, device=device)


def build_uncompressed_moe(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width MoE model without compression."""
    cfg = get_config(ARCH)
    return cfg, build_uncompressed(cfg, seed=0, device=device)


def build_vlm(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width VLM backbone."""
    cfg = get_config(VLM_ARCH)
    return cfg, build_uncompressed(cfg, seed=0, device=device)


def build_windowed(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width sliding-window model."""
    cfg = get_config(WINDOWED_ARCH)
    return cfg, build_uncompressed(cfg, seed=0, device=device)


def build_wide_moe(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width 384-expert model at
    ``WIDE_MOE_LAYERS`` layers, PMQ + OTP compressed."""
    cfg = dataclasses.replace(get_config(WIDE_MOE_ARCH), num_layers=WIDE_MOE_LAYERS)
    return cfg, build_synthetic(cfg, seed=0, device=device)


def vlm_patches(cfg, device="cuda") -> torch.Tensor:
    """The patch stub's ``[1, num_patch_tokens, d_model]`` embeddings in the
    config's dtype (numpy seed 5, normal × 0.02)."""
    rng = np.random.default_rng(VLM_PATCH_SEED)
    x = rng.normal(size=(1, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32) * 0.02
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return torch.as_tensor(x, device=device).to(dt)


def windowed_requests(cfg) -> List[Request]:
    """Fresh :class:`Request`s of ``WINDOWED`` (the same prompts each call)."""
    rng = np.random.default_rng(6)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=WINDOWED_PROMPT_LEN)
                    .astype(np.int32), max_new=WINDOWED_MAX_NEW)
            for i in range(WINDOWED_REQUESTS)]


def calibration_tokens(cfg) -> np.ndarray:
    """The calibration batch ``[4, 64]`` (numpy seed 0), as the reference
    serving CLI draws it."""
    rng = np.random.default_rng(CALIB_SEED)
    return rng.integers(0, cfg.vocab_size, (CALIB_BATCHES, CALIB_LEN)).astype(np.int64)


def packed_code_bytes(params) -> torch.Tensor:
    """Every packed code byte of a compressed serving tree (attention, shared
    experts, the expert buckets), flattened in a fixed order, on the host."""
    out = []

    def walk(node):
        if isinstance(node, PackedTensor):
            out.extend(t.reshape(-1).cpu() for t in
                       (node.data if node.bits == 3 else (node.data,)))
        elif isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])

    for layer in params["layers"]:
        walk(layer)
        for _, bucket in sorted(layer["moe_ce"].arrays.items()):
            for name in sorted(bucket):
                out.extend(bucket[name][k].reshape(-1).cpu() for k in ("data", "hi", "lo")
                           if k in bucket[name])
    return torch.cat(out)


def tiny_pipeline(device, params_host=None):
    """The reduced ``ARCH`` (f32, seed 0; or ``params_host``, copied to
    ``device``) compressed by the pipeline on ``device`` on
    :func:`calibration_tokens`, then served greedily (three prompts, numpy
    seed 1, 12 new tokens): ``(cfg, plan, avg_bits, packed code bytes,
    tokens, params_c)``. ``plan`` is ``run_pmq``'s on the eps that
    ``compress_for_serving`` reuses, before it is made layer-uniform."""
    cfg = get_config(ARCH).reduced()
    if params_host is None:
        params_host = build_uncompressed(cfg, seed=0, device="cpu")
    params = to_device(params_host, device)
    calib = pipeline.calibrate(params, torch.as_tensor(calibration_tokens(cfg), device=device),
                               cfg)
    eps = pipeline.compute_eps(params, calib, cfg)
    plan = pipeline.run_pmq(calib, eps, cfg, pipeline.TARGET_AVG_BITS)
    params_c, avg = pipeline.compress_for_serving(params, calib, cfg, eps=eps)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (20, 33, 7)]
    ecfg = EngineConfig(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
                        prefill_chunk=16, decode_horizon=4, reserve_full=True)
    out = PagedServingEngine(cfg, params_c, ecfg, device=device).serve(
        Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(prompts))
    return cfg, plan, avg, packed_code_bytes(params_c), out, params_c


def otp_tokens(cfg) -> np.ndarray:
    """``OTP_SAMPLES`` synthetic calibration samples of ``OTP_SEQ`` tokens
    (``make_calibration_tokens``, seed ``OTP_SEED``), as the reference's
    ``examples/otp_training.py`` draws its training data."""
    return make_calibration_tokens(cfg.vocab_size, OTP_SAMPLES, OTP_SEQ, seed=OTP_SEED)


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
