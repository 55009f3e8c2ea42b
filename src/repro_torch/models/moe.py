"""MoE routing and capacity dispatch (port of ``repro/models/moe.py``).

Sort-free GShard-style dispatch: a ``[T·k, E]`` one-hot cumsum ranks every
(token, choice) slot within its expert, and an inverse-permutation gather
builds the expert-major ``[E·cap, D]`` layout. Out-of-range destinations
(the drop bucket ``E·cap``) land in one scratch row that is sliced off —
torch has no ``mode="drop"`` scatter.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import linear

__all__ = [
    "capacity_dispatch",
    "combine",
    "count_ids",
    "dispatch_capacity",
    "route_topk",
    "slot_fill_counts",
]


def dispatch_capacity(cfg, t: int, capacity_factor=None) -> int:
    """Per-expert capacity for ``t`` tokens: ``cf·t·k/E``, a multiple of 8
    (floor 8)."""
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity_factor
    cap = int(cf * t * cfg.top_k / cfg.num_experts)
    return max(8, ((cap + 7) // 8) * 8)


def route_topk(router_p, x2: torch.Tensor, k: int):
    """Softmax router + top-k with renormalized gates: ``x2 [T, D]`` →
    probs ``[T, E]``, idx ``[T, k]``, gates ``[T, k]``."""
    logits = linear(router_p, x2.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, idx, gates


def _rank_within_expert(eids: torch.Tensor, e: int) -> torch.Tensor:
    """Stable rank of each slot within its expert (cumsum, no sort). Slots
    with ``eids == e`` (the drop bucket) match no column and rank 0."""
    onehot = (eids[:, None] == torch.arange(e, device=eids.device)[None, :]).long()
    rank = torch.cumsum(onehot, dim=0) - onehot
    return (rank * onehot).sum(dim=1)


def capacity_dispatch(x2, idx, gates, num_experts: int, capacity: int,
                      gate_mask: Optional[torch.Tensor] = None):
    """Expert-major layout: ``(xp [E·cap, D], dest [T·k], valid [T·k],
    gates_flat [T·k])``; ``dest`` maps (token, choice) slots into rows of
    ``xp`` (``E·cap`` = dropped)."""
    t, k = idx.shape
    e = num_experts
    eids = idx.reshape(-1)
    gflat = gates.reshape(-1)
    if gate_mask is not None:
        mflat = gate_mask.reshape(-1)
        gflat = gflat * mflat
        eids = torch.where(mflat > 0, eids, e)  # pruned → drop bucket
    rank = _rank_within_expert(eids, e)
    valid = (rank < capacity) & (eids < e)
    dest = torch.where(valid, eids * capacity + rank, e * capacity)
    # inverse permutation xp row -> source slot (+1; 0 = empty); dropped
    # slots all write the scratch row e·cap, which is cut off
    inv = torch.zeros(e * capacity + 1, dtype=torch.long, device=x2.device)
    inv[dest] = torch.arange(1, t * k + 1, device=x2.device)
    inv = inv[: e * capacity]
    src_token = torch.where(inv > 0, torch.div(inv - 1, k, rounding_mode="floor"), t)
    x2_pad = torch.cat([x2, x2.new_zeros(1, x2.shape[1])], dim=0)
    return x2_pad[src_token], dest, valid, gflat


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(ids)[:n]`` for ``ids`` in ``[0, n]`` (``n`` is the drop
    bucket), counted on the device: ``torch.bincount`` reads the ids'
    min and max back to the host to size its output, a sync per call."""
    ids = ids.long()
    counts = torch.zeros(n + 1, dtype=torch.long, device=ids.device)
    return counts.scatter_add_(0, ids, torch.ones_like(ids))[:n]


def slot_fill_counts(dest, valid, num_units: int, capacity: int) -> torch.Tensor:
    """Occupied rows per dispatch unit of a capacity layout (a prefix of
    each unit, because ranks are dense from 0)."""
    occ = torch.where(valid, torch.div(dest, capacity, rounding_mode="floor"), num_units)
    return count_ids(occ, num_units)


def combine(yp: torch.Tensor, dest, valid, gflat, t: int, k: int) -> torch.Tensor:
    """Gather expert outputs back to token order and mix by gates."""
    d = yp.shape[-1]
    ypad = torch.cat([yp, yp.new_zeros(1, d)], dim=0)
    rows = ypad[torch.where(valid, dest, yp.shape[0])]
    return (rows.reshape(t, k, d) * gflat.reshape(t, k, 1).to(yp.dtype)).sum(dim=1)
