"""AdamW over trees of tensors, with optional 8-bit block-quantized moments
(port of ``repro/optim/adamw.py``).

* bf16 params with an f32 ``master`` copy (``master=True``);
* 8-bit moments (``state_bits=8``): int8 codes with an f32 absmax scale per
  block of 128 elements (:class:`Q8`), four times less state memory.

Trees are nested dicts and lists of tensors (the port's parameter layout).
The state mirrors the reference's: ``{"step": int32 [], "per_param": <tree
of {"m", "v", ["master"]}>}``, with a :class:`Q8` (fields ``q``, ``scale``)
in place of an 8-bit moment, so a checkpoint names its leaves as the
reference's does (``.../m/.q``). The update is functional: it returns new
params and a new state, the inputs are left as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..core.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "Q8", "adamw_init", "adamw_update"]

_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    state_bits: int = 32  # 32 | 8
    master: bool = False  # keep an f32 master copy of bf16 params


class Q8(NamedTuple):
    q: torch.Tensor  # int8 codes, padded to whole blocks
    scale: torch.Tensor  # f32 per block


def _q8_zeros(x: torch.Tensor) -> Q8:
    nb = -(-x.numel() // _BLOCK)
    return Q8(q=torch.zeros(nb * _BLOCK, dtype=torch.int8, device=x.device),
              scale=torch.zeros(nb, dtype=torch.float32, device=x.device))


def _q8_encode(x: torch.Tensor) -> Q8:
    n = x.numel()
    nb = -(-n // _BLOCK)
    xf = x.reshape(-1).float()
    if nb * _BLOCK != n:
        xf = torch.cat([xf, xf.new_zeros(nb * _BLOCK - n)])
    xb = xf.reshape(nb, _BLOCK)
    scale = xb.abs().amax(dim=1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127).to(torch.int8)
    return Q8(q=q.reshape(-1), scale=scale)


def _q8_decode(s: Q8, shape) -> torch.Tensor:
    xb = s.q.reshape(-1, _BLOCK).float() * s.scale[:, None]
    return xb.reshape(-1)[:math.prod(shape)].reshape(shape)


def adamw_init(params, cfg: AdamWConfig):
    def one(p: torch.Tensor):
        if cfg.state_bits == 8:
            st = {"m": _q8_zeros(p), "v": _q8_zeros(p)}
        else:
            st = {"m": torch.zeros_like(p, dtype=torch.float32),
                  "v": torch.zeros_like(p, dtype=torch.float32)}
        if cfg.master and p.dtype != torch.float32:
            st["master"] = p.detach().float()
        return st

    device = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "per_param": tree_map(one, params)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale: Any = 1.0):
    """One AdamW step: ``(new_params, new_state)``. ``lr_scale`` (a float or
    an f32 0-d tensor, e.g. :func:`~.schedule.warmup_cosine`) multiplies
    ``cfg.lr``."""
    step = state["step"] + 1
    sf = step.float()
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=sf.device) ** sf
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=sf.device) ** sf
    lr = cfg.lr * lr_scale

    def one(p: torch.Tensor, g: torch.Tensor, st: dict):
        g32 = g.float()
        if cfg.state_bits == 8:
            m, v = _q8_decode(st["m"], p.shape), _q8_decode(st["v"], p.shape)
        else:
            m, v = st["m"], st["v"]
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * (g32 * g32)
        mh = m / b1c
        vh = v / b2c
        base = st["master"] if "master" in st else p.float()
        upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * base
        new_master = base - lr * upd
        new_st = {"m": _q8_encode(m) if cfg.state_bits == 8 else m,
                  "v": _q8_encode(v) if cfg.state_bits == 8 else v}
        if "master" in st:
            new_st["master"] = new_master
        new_p = new_master.to(p.dtype)
        return (new_p.requires_grad_() if p.requires_grad else new_p), new_st

    pairs = tree_map(one, params, grads, state["per_param"])
    new_params = tree_map(lambda pr: pr[0], pairs)
    per_param = tree_map(lambda pr: pr[1], pairs)
    return new_params, {"step": step, "per_param": per_param}
