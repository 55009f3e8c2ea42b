"""MoE routing and capacity dispatch (port of ``repro/models/moe.py``).

Sort-free GShard-style dispatch: a ``[T·k, E]`` one-hot cumsum ranks every
(token, choice) slot within its expert, and an inverse-permutation gather
builds the expert-major ``[E·cap, D]`` layout. Out-of-range destinations
(the drop bucket ``E·cap``) land in one scratch row that is sliced off —
torch has no ``mode="drop"`` scatter.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import EPRegionError, current_mesh
from .layers import init_linear, init_mlp, linear, mlp

__all__ = [
    "MoEOut",
    "capacity_dispatch",
    "combine",
    "count_ids",
    "dispatch_capacity",
    "ep_shardmap_ok",
    "expert_ffn",
    "init_moe",
    "load_balance_loss",
    "moe_layer",
    "route_topk",
    "shared_d_ff",
    "slot_fill_counts",
]


def dispatch_capacity(cfg, t: int, capacity_factor=None) -> int:
    """Per-expert capacity for ``t`` tokens: ``cf·t·k/E``, a multiple of 8
    (floor 8)."""
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity_factor
    cap = int(cf * t * cfg.top_k / cfg.num_experts)
    return max(8, ((cap + 7) // 8) * 8)


def shared_d_ff(cfg) -> int:
    """The shared experts' MLP width (one MLP of ``num_shared_experts``
    experts' columns)."""
    return cfg.d_ff_expert * cfg.num_shared_experts


def init_moe(gen: torch.Generator, cfg, dtype=torch.float32):
    """Router (f32, ``N(0, 1/D)``), experts ``[E, D, F]`` / ``[E, F, D]``
    and the shared experts' MLP, drawn from ``gen`` on its device."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    scale = 1.0 / (d ** 0.5)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device, dtype=dtype)

    p = {"router": init_linear(gen, d, e, torch.float32, scale),
         "experts": {"w_gate": normal(e, d, f) * scale, "w_up": normal(e, d, f) * scale,
                     "w_down": normal(e, f, d) * (1.0 / f ** 0.5)}}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, shared_d_ff(cfg), dtype)
    return p


def route_topk(router_p, x2: torch.Tensor, k: int):
    """Softmax router + top-k with renormalized gates: ``x2 [T, D]`` →
    probs ``[T, E]``, idx ``[T, k]``, gates ``[T, k]``."""
    logits = linear(router_p, x2.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, idx, gates


def _rank_within_expert(eids: torch.Tensor, e: int, max_onehot: int = 2**26) -> torch.Tensor:
    """Stable rank of each slot within its expert (cumsum, no sort). Slots
    with ``eids == e`` (the drop bucket) match no column and rank 0.

    Above ``max_onehot`` one-hot elements the slots are ranked in chunks of
    ``max(1, max_onehot // e // 8 * 8)`` rows (padded with the drop id),
    carrying the per-expert counts from chunk to chunk, so each int32
    ``[chunk, E]`` one-hot stays near 256 MiB — the reference's scan. The
    one-shot path, the one serving takes, keeps int64 one-hots: int32 ones
    launch one more device op per call."""
    n = eids.shape[0]
    experts = torch.arange(e, device=eids.device)[None, :]
    if n * e <= max_onehot:
        onehot = (eids[:, None] == experts).long()
        rank = torch.cumsum(onehot, dim=0) - onehot
        return (rank * onehot).sum(dim=1)
    chunk = max(1, max_onehot // e // 8 * 8)
    pad = -n % chunk
    ep = torch.cat([eids, eids.new_full((pad,), e)])
    counts = torch.zeros(e, dtype=torch.int32, device=eids.device)
    ranks = []
    for ch in ep.split(chunk):
        oh = (ch[:, None] == experts).to(torch.int32)
        r = counts[None, :] + torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
        ranks.append((r * oh).sum(dim=1, dtype=torch.int32))
        counts = counts + oh.sum(dim=0, dtype=torch.int32)
    return torch.cat(ranks)[:n].long()


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


def expert_ffn(experts_p, xp: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Batched SwiGLU over the expert dim: ``xp [E·cap, D] → [E·cap, D]``.
    Every expert's weights are read whatever its rows hold, as the
    reference's einsum does."""
    e = num_experts
    x3 = xp.reshape(e, xp.shape[0] // e, -1)
    wg, wu, wd = (experts_p[n].to(x3.dtype) for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(torch.bmm(x3, wg)) * torch.bmm(x3, wu)
    return torch.bmm(h, wd).reshape(xp.shape[0], -1)


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: ``E · Σ_e f_e · p̄_e``."""
    t, k = idx.shape
    f = count_ids(idx.reshape(-1), num_experts).float() / (t * k)
    return num_experts * torch.sum(f * probs.mean(dim=0))


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor
    router_probs: torch.Tensor  # [T, E]
    topk_idx: torch.Tensor  # [T, k]
    topk_gates: torch.Tensor  # [T, k]


def ep_shardmap_ok(cfg, mesh, x, num_units: int) -> bool:
    """Divisibility guard for the shard_map EP region: the model axis
    divides the dispatch units. ``x`` is this rank's block of the batch
    axes, so the reference's other condition — that they divide the global
    batch — holds by construction."""
    if mesh is None or "model" not in mesh.axis_names:
        return False
    return num_units % mesh.shape["model"] == 0


def moe_layer(p, x: torch.Tensor, cfg, *, gate_mask_fn=None, expert_ffn_fn=None,
              capacity: Optional[int] = None) -> MoEOut:
    """The uncompressed MoE block (``moe.py:212``), ``x [B, S, D]``.
    ``gate_mask_fn(x2, idx, gates) -> mask [T, k]`` is the OTP hook;
    ``expert_ffn_fn(xp) -> yp`` overrides the expert compute; ``capacity``
    replaces the per-expert capacity the token count gives.

    Under a mesh the routed experts run the shard_map EP region
    (:func:`repro_torch.parallel.ep_shardmap.moe_region_sharded`, no
    all-to-all; ``x`` is this rank's batch block) and the router outputs are
    None, as in the reference. Where the reference falls back to its GSPMD
    path — an ``expert_ffn_fn``, or an expert count the model axis does not
    divide — the port raises :class:`EPRegionError`."""
    mesh = current_mesh()
    if mesh is not None:
        from ..parallel.ep_shardmap import moe_region_sharded

        if expert_ffn_fn is not None:
            raise EPRegionError("moe_layer under a mesh: expert_ffn_fn overrides the expert "
                                "compute, which leaves the EP region")
        if not ep_shardmap_ok(cfg, mesh, x, cfg.num_experts):
            raise EPRegionError(f"moe_layer under a mesh: ep_shardmap_ok is false "
                                f"({cfg.num_experts} experts over model="
                                f"{mesh.shape.get('model')})")
        y, aux = moe_region_sharded(p, x, cfg, mesh, gate_mask_fn=gate_mask_fn)
        if "shared" in p:
            b, s, d = x.shape
            y = y + mlp(p["shared"], x.reshape(b * s, d), shared_d_ff(cfg)).reshape(b, s, d)
        return MoEOut(y, aux, None, None, None)
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    e, k = cfg.num_experts, cfg.top_k
    probs, idx, gates = route_topk(p["router"], x2, k)
    gate_mask = gate_mask_fn(x2, idx, gates) if gate_mask_fn is not None else None
    cap = capacity or dispatch_capacity(cfg, t)
    xp, dest, valid, gflat = capacity_dispatch(x2, idx, gates, e, cap, gate_mask)
    yp = expert_ffn_fn(xp) if expert_ffn_fn is not None else expert_ffn(p["experts"], xp, e)
    y = combine(yp, dest, valid, gflat, t, k)
    if "shared" in p:
        y = y + mlp(p["shared"], x2, shared_d_ff(cfg))
    return MoEOut(y.reshape(b, s, d), load_balance_loss(probs, idx, e), probs, idx, gates)
