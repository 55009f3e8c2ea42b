"""LR schedules (port of ``repro/optim/schedule.py``): pure functions of the
step counter."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step: torch.Tensor, *, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to 1 over ``warmup`` steps, then a cosine down to
    ``floor`` at ``total``; ``step`` a 0-d tensor, the result f32 on its
    device."""
    s = step.float()
    warm = torch.clamp_max(s / max(warmup, 1), 1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
