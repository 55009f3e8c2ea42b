"""OTP — Online Top-any Pruning (paper §3.4), inference only.

Port of ``repro/core/otp.py``: a two-layer router ``DM(·)`` per MoE layer
scores the prefix-mask candidates ``C_k`` (keep the m strongest of the
top-k experts, Eq. 10) and inference takes the argmax candidate (the τ → 0
limit of the Gumbel-Softmax). The mask multiplies the gates before
dispatch, so pruned experts take no capacity and no FLOPs. Sorts are
stable, as ``jnp.argsort`` is, so ties order identically.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

__all__ = ["candidate_masks", "dm_logits", "otp_mask"]


def candidate_masks(k: int, device=None) -> torch.Tensor:
    """``C_k [k, k]``: row j keeps the top ``k - j`` experts."""
    ar = torch.arange(k, device=device)
    return (ar[None, :] < (k - ar)[:, None]).float()


def dm_logits(p: Dict, x2: torch.Tensor, gates_sorted: torch.Tensor) -> torch.Tensor:
    """Categorical logits over ``C_k`` from the token and its descending
    top-k gates."""
    h = x2.float() @ p["fc1"].float()
    h = torch.cat([F.silu(h), gates_sorted.float()], dim=-1)
    return h @ p["fc2"].float()


def otp_mask(p: Dict, x2: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """Deterministic (argmax) OTP mask ``[T, k]`` in the original top-k slot
    order."""
    k = gates.shape[-1]
    order = torch.argsort(-gates, dim=-1, stable=True)  # strongest first
    logits = dm_logits(p, x2, torch.gather(gates, -1, order))
    mask_sorted = candidate_masks(k, gates.device)[torch.argmax(logits, dim=-1)]
    inv = torch.argsort(order, dim=-1, stable=True)
    return torch.gather(mask_sorted, -1, inv)
