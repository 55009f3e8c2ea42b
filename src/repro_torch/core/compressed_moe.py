"""PMQ-compressed MoE experts: bit-bucketed storage + grouped-GEMM compute.

Port of ``repro/core/compressed_moe.py`` (all experts device-resident,
one expert-parallel shard). Experts are permuted so that equal-width
experts are contiguous and stacked into ≤ 3 buckets, one per bit width.
The capacity-dispatch layout is already expert-major and each slot's
occupied rows are a prefix, so :func:`grouped_bucket_ffn` compacts the
prefixes into back-to-back ``bm``-aligned groups and runs the bucket's
SwiGLU as two grouped GEMMs (fused gate/up with the SwiGLU epilogue, then
down) with a device-side ``block_expert`` table and ``num_active`` block
count — the kernels skip every block past the routed-token frontier.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..models.layers import mlp
from ..models.moe import (
    capacity_dispatch,
    combine,
    count_ids,
    dispatch_capacity,
    route_topk,
    slot_fill_counts,
)
from . import otp as otp_mod
from .quantizers import quantize_parts

__all__ = [
    "BucketMeta",
    "CompressedExperts",
    "build_compressed_experts",
    "compressed_expert_ffn",
    "compressed_moe_layer",
    "gmm_block_rows",
    "grouped_bucket_ffn",
]

_NAMES = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class BucketMeta:
    bits: int
    start: int  # first permuted slot
    count: int  # expert count of the bucket


@dataclasses.dataclass
class CompressedExperts:
    """One layer's quantized experts: ``arrays[f"b{i}"][name]`` holds
    ``data`` (or ``hi``/``lo``), ``scale`` and ``zero`` with a leading
    ``[count]`` expert dim; ``slot_of_expert [E]`` maps original expert
    ids to permuted slots."""

    meta: Tuple[BucketMeta, ...]
    slot_of_expert: torch.Tensor
    arrays: Dict
    num_slots: int
    group: int
    d_model: int
    d_ff: int

    @property
    def weight_bytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for b in self.arrays.values() for w in b.values() for t in w.values()
        )

    def to(self, device) -> "CompressedExperts":
        return dataclasses.replace(
            self,
            slot_of_expert=self.slot_of_expert.to(device),
            arrays={
                b: {n: {key: t.to(device) for key, t in w.items()} for n, w in bw.items()}
                for b, bw in self.arrays.items()
            },
        )


def _pack_stack(ws: torch.Tensor, bits: int, group: int, refine: bool) -> Dict:
    """Quantize + pack one bucket's ``[count, K, N]`` weights (each expert
    exactly as ``quantize_to_packed`` would)."""
    data, scale, zero = quantize_parts(ws, bits, group, refine)
    out = {"scale": scale, "zero": zero}
    if bits == 3:
        out["hi"], out["lo"] = data
    else:
        out["data"] = data
    return out


def build_compressed_experts(experts: Dict, bits_per_expert: Sequence[int], *,
                             group: int = 128, refine: bool = True) -> CompressedExperts:
    """Quantize + bucket one layer's experts: ``experts`` = {"w_gate": [E, D,
    F], "w_up": [E, D, F], "w_down": [E, F, D]} (quantized from f32)."""
    e = len(bits_per_expert)
    bits_arr = np.asarray(bits_per_expert)
    order = np.argsort(bits_arr, kind="stable")  # ascending bit groups
    slot_of_expert = np.full(e, -1, np.int64)
    d, f = experts["w_gate"].shape[1], experts["w_gate"].shape[2]
    meta, arrays, slot = [], {}, 0
    for bits in sorted(set(bits_arr.tolist())):
        ids = [int(i) for i in order if bits_arr[i] == bits]
        slot_of_expert[ids] = slot + np.arange(len(ids))
        pick = torch.as_tensor(ids, device=experts["w_gate"].device)
        arrays[f"b{len(meta)}"] = {
            name: _pack_stack(experts[name].index_select(0, pick).float(), bits, group, refine)
            for name in _NAMES
        }
        meta.append(BucketMeta(bits=bits, start=slot, count=len(ids)))
        slot += len(ids)
    return CompressedExperts(
        meta=tuple(meta),
        slot_of_expert=torch.as_tensor(slot_of_expert, device=experts["w_gate"].device),
        arrays=arrays, num_slots=slot, group=group, d_model=d, d_ff=f,
    )


def gmm_block_rows(cap: int) -> int:
    """Row-block size ``bm`` at capacity ``cap``: divides ``cap`` (slot
    boundaries stay block-aligned), target 16 rows — drop-free serving
    capacities run at single-digit utilization, where the ragged-skip
    granularity matters more than tile height."""
    return math.gcd(cap, 16)


def _parts(w: Dict, bits: int):
    pk = (w["hi"], w["lo"]) if bits == 3 else w["data"]
    return pk, w["scale"], w["zero"]


def grouped_bucket_ffn(xb: torch.Tensor, wdict: Dict, fill: torch.Tensor, *, bits: int,
                       group: int, count: int, cap: int) -> torch.Tensor:
    """One bucket's SwiGLU over its capacity slice ``xb [count·cap, D]`` as
    grouped GEMMs; returns ``[count·cap, D]`` in the same layout.

    ``fill [count]`` gives each slot's occupied-row count (a prefix):
    slot ``s`` row ``j < fill[s]`` moves to ``offsets[s] + j`` with groups
    packed back to back at ``bm`` boundaries; ``num_active`` counts the
    live blocks and unoccupied capacity rows come back exactly zero.
    Everything stays on the device — no host sync.
    """
    m = count * cap
    d = xb.shape[-1]
    bm = gmm_block_rows(cap)
    dev = xb.device
    fill = torch.clamp_max(fill, cap)
    padded = torch.div(fill + bm - 1, bm, rounding_mode="floor") * bm
    nblk = torch.div(padded, bm, rounding_mode="floor")
    offsets = torch.cumsum(padded, 0) - padded
    rows = torch.arange(m, device=dev)
    s_of = torch.div(rows, cap, rounding_mode="floor")
    j_of = rows % cap
    # capacity row (s, j) → compacted row; empty rows → scratch row m
    gdest = torch.where(j_of < fill[s_of], offsets[s_of] + j_of, m)
    inv = torch.zeros(m + 1, dtype=torch.long, device=dev)
    inv[gdest] = rows + 1
    inv = inv[:m]
    src = torch.where(inv > 0, inv - 1, m)
    xg = torch.cat([xb, xb.new_zeros(1, d)], dim=0)[src]
    # expert of each row block; blocks past the frontier repeat the last id
    # (as jnp.repeat's total_repeat_length padding does) and are masked by
    # num_active
    ends = torch.cumsum(nblk, 0)
    blocks = torch.arange(m // bm, device=dev)
    block_expert = torch.clamp_max(
        torch.searchsorted(ends, blocks, right=True), count - 1
    ).to(torch.int32)
    num_active = nblk.sum().to(torch.int32).reshape(1)
    gp, gs, gz = _parts(wdict["w_gate"], bits)
    up, us, uz = _parts(wdict["w_up"], bits)
    dp, ds, dz = _parts(wdict["w_down"], bits)
    h = ops.moe_gmm_swiglu(xg, gp, up, gs, gz, us, uz, block_expert, num_active, bits=bits,
                           group=group, bm=bm)
    yg = ops.moe_gmm(h, dp, ds, dz, block_expert, num_active, bits=bits, group=group, bm=bm)
    return torch.cat([yg, yg.new_zeros(1, d)], dim=0)[gdest]


def compressed_expert_ffn(ce: CompressedExperts, xp: torch.Tensor, cap: int,
                          slot_fill: torch.Tensor) -> torch.Tensor:
    """SwiGLU over the permuted capacity layout ``xp [num_slots·cap, D]``,
    bucket by bucket through :func:`grouped_bucket_ffn`."""
    ys = []
    for i, m in enumerate(ce.meta):
        xb = xp[m.start * cap:(m.start + m.count) * cap]
        fill = slot_fill[m.start:m.start + m.count]
        ys.append(grouped_bucket_ffn(xb, ce.arrays[f"b{i}"], fill, bits=m.bits, group=ce.group,
                                     count=m.count, cap=cap))
    return torch.cat(ys, dim=0)


def compressed_moe_layer(p: Dict, ce: CompressedExperts, x: torch.Tensor, cfg, *,
                         otp_params: Optional[Dict] = None,
                         capacity_factor: Optional[float] = None,
                         count_weight: Optional[torch.Tensor] = None):
    """MoE block with PMQ experts and optional OTP pruning (the reference's
    local path). ``p`` carries the router and the shared experts. Returns
    ``(y [B, S, D], info)``; ``info["mask"]`` is the OTP mask ``[T, k]`` (or
    None) and ``info["slot_counts"]`` the per-slot count of dispatched
    (token, choice) pairs after masking, with tokens where ``count_weight``
    is false left out."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    k = cfg.top_k
    probs, idx, gates = route_topk(p["router"], x2, k)
    mask = None
    if otp_params is not None:
        mask = otp_mod.otp_mask(otp_params, x2, idx, gates)
    slots = ce.slot_of_expert[idx]  # original expert ids → permuted slots
    eff = slots.reshape(-1)
    if mask is not None:
        eff = torch.where(mask.reshape(-1) > 0, eff, ce.num_slots)
    if count_weight is not None:
        cw = count_weight.reshape(-1).bool().repeat_interleave(k)
        eff = torch.where(cw, eff, ce.num_slots)
    slot_counts = count_ids(eff, ce.num_slots)
    cap = dispatch_capacity(cfg, t, capacity_factor)
    xp, dest, valid, gflat = capacity_dispatch(x2, slots, gates, ce.num_slots, cap, mask)
    slot_fill = slot_fill_counts(dest, valid, ce.num_slots, cap)
    yp = compressed_expert_ffn(ce, xp, cap, slot_fill)
    y = combine(yp, dest, valid, gflat, t, k)
    if "shared" in p:
        y = y + mlp(p["shared"], x2)
    info = {"probs": probs, "idx": idx, "gates": gates, "mask": mask,
            "slot_counts": slot_counts}
    return y.reshape(b, s, d), info
