"""The full-width serving workload: what ``chip_smoke.py`` serves and
:mod:`repro_torch.launch.profile_decode` traces. One definition, so the
profile describes the run whose tokens/s are reported beside it.

``moonshot-v1-16b-a3b`` at full width and all 48 layers in bf16 with random
PMQ + OTP weights from seed 0 (:func:`build_synthetic`); 4 requests of 64
prompt tokens (numpy seed 2) and 32 new tokens each, served 4 slots at a
time with 16-token pages, 16-token prefill chunks and 8-step megasteps.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..configs import get_config
from ..core.synthetic import build_synthetic
from ..serving import EngineConfig, Request

__all__ = ["ARCH", "ENGINE", "MAX_NEW", "build", "requests"]

ARCH = "moonshot-v1-16b-a3b"
PROMPT_LEN, MAX_NEW, NUM_REQUESTS = 64, 32, 4
ENGINE = EngineConfig(max_slots=4, block_size=16, num_blocks=24, max_blocks_per_slot=6,
                      prefill_chunk=16, decode_horizon=8, reserve_full=True, use_otp=True)


def build(device="cuda") -> Tuple[object, Dict]:
    """``(cfg, params)`` of the full-width model, built on ``device``."""
    cfg = get_config(ARCH)
    return cfg, build_synthetic(cfg, seed=0, device=device)


def requests(cfg) -> List[Request]:
    """Fresh :class:`Request`s of the workload (the same prompts each call)."""
    rng = np.random.default_rng(2)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=PROMPT_LEN)
                    .astype(np.int32), max_new=MAX_NEW)
            for i in range(NUM_REQUESTS)]
