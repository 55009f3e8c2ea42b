"""OTP — Online Top-any Pruning (paper §3.4, Eqs. 10-14).

Port of ``repro/core/otp.py``: a two-layer router ``DM(·)`` per MoE layer
scores the prefix-mask candidates ``C_k`` (keep the m strongest of the
top-k experts, Eq. 10). Training samples a candidate with Gumbel-Softmax
(Eq. 13, temperature τ) through a straight-through estimator, and the loss
(Eq. 14) distills the masked model against the unmasked one plus λ·mean|M|.
Inference takes the argmax candidate (the τ → 0 limit). The mask
multiplies the gates before dispatch, so pruned experts take no capacity
and no FLOPs. Sorts are stable, as ``jnp.argsort`` is, so ties order
identically, and no gradient flows through the order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = [
    "candidate_masks",
    "dm_logits",
    "fixed_uniforms",
    "gumbel_uniforms",
    "init_otp_router",
    "mask_ratio",
    "otp_losses",
    "otp_mask",
    "sample_mask_gumbel",
]

#: the uniforms' open interval, as the reference draws them
U_MIN, U_MAX = 1e-6, 1.0 - 1e-6


def candidate_masks(k: int, device=None) -> torch.Tensor:
    """``C_k [k, k]``: row j keeps the top ``k - j`` experts."""
    ar = torch.arange(k, device=device)
    return (ar[None, :] < (k - ar)[:, None]).float()


def init_otp_router(gen: torch.Generator, d_model: int, k: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """Router ``DM(·)`` per Tab. 1: ``fc1 [d, k]``, ``fc2 [2k, k]``, normal
    draws from ``gen`` scaled by fan-in^-1/2 (on ``gen``'s device, then
    moved to ``device``)."""
    dev = gen.device
    fc1 = torch.randn(d_model, k, generator=gen, device=dev) * (d_model ** -0.5)
    fc2 = torch.randn(2 * k, k, generator=gen, device=dev) * ((2 * k) ** -0.5)
    return {"fc1": fc1.to(device or dev), "fc2": fc2.to(device or dev)}


def dm_logits(p: Dict, x2: torch.Tensor, gates_sorted: torch.Tensor) -> torch.Tensor:
    """Categorical logits over ``C_k`` from the token and its descending
    top-k gates."""
    h = x2.float() @ p["fc1"].float()
    h = torch.cat([F.silu(h), gates_sorted.float()], dim=-1)
    return h @ p["fc2"].float()


def gumbel_uniforms(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Uniforms on ``(1e-6, 1 - 1e-6)`` drawn from ``gen`` (on its device),
    then moved to ``device``."""
    u = torch.rand(shape, generator=gen, device=gen.device) * (U_MAX - U_MIN) + U_MIN
    return u.to(device or gen.device)


def fixed_uniforms(rng: Optional[Union[torch.Tensor, torch.Generator]], t: int, k: int,
                   device=None) -> Optional[torch.Tensor]:
    """``rng`` for a region that may run again (a recomputation in the
    backward): a generator's uniforms ``[t, k]`` drawn now, as
    :func:`sample_mask_gumbel` would draw them, so that every run reads the
    same draws (torch's checkpoint restores its default generators' state,
    not an explicit generator's); uniforms or None as they are."""
    if isinstance(rng, torch.Generator):
        return gumbel_uniforms(rng, (t, k), device)
    return rng


def sample_mask_gumbel(rng: Union[torch.Tensor, torch.Generator], logits: torch.Tensor, k: int,
                       tau: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gumbel-Softmax sample over the candidates (Eqs. 12-13): ``(y [T, k],
    mask [T, k])`` with ``y`` the straight-through one-hot (hard forward,
    soft gradient) and ``mask = y · C_k`` in sorted order.

    ``rng`` is the uniforms (``logits``' shape, on ``(1e-6, 1 - 1e-6)``) or
    a generator to draw them from. The straight-through sum keeps the
    reference's association, ``(y_hard + y_soft) - y_soft.detach()``: its
    zeros are exact, its ones may be an ulp off."""
    u = (gumbel_uniforms(rng, logits.shape, logits.device)
         if isinstance(rng, torch.Generator) else rng.to(logits.device).float())
    g = -torch.log(-torch.log(u))
    y_soft = torch.softmax((logits + g) / tau, dim=-1)
    idx = torch.argmax(y_soft, dim=-1)
    y_hard = F.one_hot(idx, logits.shape[-1]).to(y_soft.dtype)
    y = (y_hard + y_soft) - y_soft.detach()
    return y, y @ candidate_masks(k, logits.device)


def otp_mask(p: Dict, x2: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor, *,
             rng: Optional[Union[torch.Tensor, torch.Generator]] = None,
             tau: float = 1.0) -> torch.Tensor:
    """OTP mask ``[T, k]`` in the original top-k slot order: the argmax
    candidate (inference) when ``rng`` is None, else a Gumbel sample from
    the uniforms or generator ``rng`` (training)."""
    k = gates.shape[-1]
    order = torch.argsort(-gates.detach(), dim=-1, stable=True)  # strongest first
    logits = dm_logits(p, x2, torch.gather(gates, -1, order))
    if rng is None:
        mask_sorted = candidate_masks(k, gates.device)[torch.argmax(logits, dim=-1)]
    else:
        _, mask_sorted = sample_mask_gumbel(rng, logits, k, tau)
    inv = torch.argsort(order, dim=-1, stable=True)
    return torch.gather(mask_sorted, -1, inv)


def mask_ratio(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of (token, expert) slots pruned (the paper's pruning ratio)."""
    return 1.0 - mask.mean()


def otp_losses(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
               masks: torch.Tensor, lam: float = 1.0):
    """Eq. 14: ``KL(teacher ‖ student)`` (mean over positions) plus
    ``λ · mean|M|`` over the concatenated masks. Returns ``(loss, {"kl",
    "mask_l1", "mask_ratio"})``."""
    t = torch.log_softmax(teacher_logits.float(), dim=-1)
    s = torch.log_softmax(student_logits.float(), dim=-1)
    kl = torch.sum(torch.exp(t) * (t - s), dim=-1).mean()
    # |M| with jax's derivative, +1 at 0 (torch's abs has 0 there): a pruned
    # slot's mask is exactly 0 and its straight-through gradient must flow
    sparsity = torch.where(masks >= 0, masks, -masks).mean()
    loss = kl + lam * sparsity
    return loss, {"kl": kl, "mask_l1": sparsity, "mask_ratio": 1.0 - sparsity}
