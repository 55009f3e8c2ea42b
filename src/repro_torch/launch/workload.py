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
from ..serving import EngineConfig, Request

__all__ = [
    "ARCH",
    "DENSE",
    "DENSE_ARCH",
    "ENGINE",
    "MAX_NEW",
    "SHARED_PREFIX",
    "SHARED_PREFIX_CHUNKS",
    "SHARED_PREFIX_COW_COPIES",
    "UNCOMPRESSED_MOE",
    "build",
    "build_dense",
    "build_uncompressed_moe",
    "requests",
    "shared_prefix_requests",
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


def shared_prefix_requests(cfg) -> List[Request]:
    """Fresh :class:`Request`s of the shared-prefix workload: one 48-token
    system prompt (numpy seed 3), r0/r1 + 16 tokens, r2 + 8, r3 = r2."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab_size, size=SYSTEM_PROMPT_LEN)
    tails = [rng.integers(0, cfg.vocab_size, size=n) for n in (16, 16, 8)]
    prompts = [np.concatenate([system, t]).astype(np.int32) for t in tails]
    prompts.append(prompts[2].copy())
    return [Request(rid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
