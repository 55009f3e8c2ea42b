"""OTP router training (paper §3.4.2, Eq. 14): port of
``repro/core/otp_train.py``.

End-to-end distillation of the per-layer DM routers on a frozen,
PMQ-compressed backbone: the student runs with Gumbel-sampled masks, the
teacher is the same compressed model without masks (under no grad). Only
the routers require grad; each step is one AdamW update with no weight
decay. The backbone's dequant GEMMs run their kernels forward and a plain
backward for ``x`` (:mod:`repro_torch.kernels.grad`).

All of a step's randomness (the batch's sample indices, each layer's
uniforms) and the routers' initial draws come from one :class:`OTPDraws`
object. The default draws from a CPU ``torch.Generator`` seeded by
``tcfg.seed`` and moves the draws to the model's device, so the card and
the CPU train on the same draws; a caller may hand in any object with the
same two methods (the tests replay the reference's ``PRNGKey`` draws).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from . import otp as otp_mod
from .pipeline import compressed_logits

__all__ = ["OTPDraws", "OTPTrainConfig", "init_otp_params", "train_otp"]


@dataclasses.dataclass(frozen=True)
class OTPTrainConfig:
    steps: int = 100
    batch: int = 8
    lr: float = 2e-3
    lam: float = 1.0  # sparsity weight λ (Eq. 14)
    tau: float = 1.0  # Gumbel temperature
    seed: int = 0


class OTPDraws:
    """The training's random draws from one CPU generator seeded by
    ``seed``: the routers first, then each step's sample indices and
    per-layer uniforms."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def routers(self, cfg) -> List[Dict[str, torch.Tensor]]:
        """One router per layer (:func:`init_otp_params`)."""
        return init_otp_params(self.gen, cfg)

    def step(self, step: int, n: int, batch: int, t: int, k: int,
             num_layers: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``(sel [batch] int64 in [0, n), [uniforms [t, k]] per layer)``."""
        sel = torch.randint(0, n, (batch,), generator=self.gen)
        return sel, [otp_mod.gumbel_uniforms(self.gen, (t, k)) for _ in range(num_layers)]


def init_otp_params(gen: torch.Generator, cfg) -> List[Dict[str, torch.Tensor]]:
    return [otp_mod.init_otp_router(gen, cfg.d_model, cfg.top_k) for _ in range(cfg.num_layers)]


def train_otp(blocks_c, top, cfg, tokens: np.ndarray, tcfg: OTPTrainConfig,
              draws: Optional[OTPDraws] = None) -> Tuple[List[Dict], List[Dict]]:
    """Train the DM routers on ``tokens [N, S]`` calibration samples, on the
    device of ``top["embed"]``. Returns ``(otp_params, history)``: the
    routers (detached) and per step ``{"step", "loss", "kl",
    "mask_ratio"}``."""
    device = top["embed"].device
    draws = draws if draws is not None else OTPDraws(tcfg.seed)
    otp_params = [{name: v.to(device).float().requires_grad_() for name, v in p.items()}
                  for p in draws.routers(cfg)]
    ocfg = AdamWConfig(lr=tcfg.lr, weight_decay=0.0)
    opt_state = adamw_init(otp_params, ocfg)
    data = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=device)
    n, s = data.shape
    history = []
    for step in range(tcfg.steps):
        sel, us = draws.step(step, n, tcfg.batch, tcfg.batch * s, cfg.top_k, cfg.num_layers)
        batch_tokens = data[sel.to(device)]
        student, masks = compressed_logits(
            blocks_c, top, batch_tokens, cfg, otp_params=otp_params,
            otp_rngs=[u.to(device) for u in us], otp_tau=tcfg.tau, collect_masks=True)
        teacher, _ = compressed_logits(blocks_c, top, batch_tokens, cfg)
        mask_cat = torch.cat([m.reshape(-1) for m in masks])
        loss, aux = otp_mod.otp_losses(student, teacher, mask_cat, tcfg.lam)
        leaves = [v for p in otp_params for v in p.values()]
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grads = [{name: next(it) for name in p} for p in otp_params]
        del student, teacher, masks, mask_cat
        otp_params, opt_state = adamw_update(otp_params, grads, opt_state, ocfg)
        history.append({"step": step, "loss": float(loss.detach()),
                        "kl": float(aux["kl"].detach()),
                        "mask_ratio": float(aux["mask_ratio"].detach())})
    return [{name: v.detach() for name, v in p.items()} for p in otp_params], history
