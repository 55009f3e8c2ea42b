"""PMQ-compressed MoE experts: bit-bucketed storage + grouped-GEMM compute.

Port of ``repro/core/compressed_moe.py``. Experts are permuted so that
equal-width experts are contiguous and stacked into ≤ 3 buckets, one per
bit width.
The capacity-dispatch layout is already expert-major and each slot's
occupied rows are a prefix, so :func:`grouped_bucket_ffn` compacts the
prefixes into back-to-back ``bm``-aligned groups and runs the bucket's
SwiGLU as two grouped GEMMs (fused gate/up with the SwiGLU epilogue, then
down) with a device-side ``block_expert`` table and ``num_active`` block
count — the kernels skip every block past the routed-token frontier.

All-resident (the default): each bucket leaf spans the bucket's ``[count,
...]`` expert dim and ``resident_map is None``. Host-offloaded (serving, see
:mod:`repro_torch.serving.offload`): each bucket leaf spans only
``resident_rows[i]`` device rows and ``resident_map[bᵢ] [count]`` int32 maps
each bucket slot to its resident row. The indirection is folded into the
``block_expert`` table (``block_expert = resident_map[block_expert]``), so
the kernels read resident rows directly — bitwise the all-resident result
for every slot whose row holds its weights. A non-resident slot points at
row 0 and must carry no routed tokens (the engine's miss replay sees to
that).

**Backend knob** (``ffn_backend=``, the reference's ``FFN_BACKENDS``):
``"grouped"`` (the default) runs the Hopper kernels on a CUDA tensor and
their plain versions on a CPU one; ``"ref"`` runs the plain grouped GEMMs
on either device, chosen by the caller, never as a fallback; ``"scan"`` is
the reference's per-expert scan, kept as the A/B baseline: each expert's
``cap`` capacity rows go through three ``ops.quant_matmul_parts`` calls
(the ``quant_matmul`` kernel on the card), occupied or not, and a
host-offloaded bucket is gathered back to its full layout first.
``REPRO_FFN_BACKEND`` sets the process default. The reference's
``"interpret"`` (the Pallas interpreter) is refused by name.

**Expert parallelism.** ``build_compressed_experts(ep=)`` pads each bucket
to a multiple of ``ep`` with copies of its last expert (the dummy slots are
never routed to). Under a mesh (:func:`repro_torch.parallel.sharding.sharding_rules`)
:func:`compressed_moe_layer` runs the shard_map region of
:mod:`repro_torch.parallel.ep_shardmap`; where the reference would leave
the region for GSPMD's global path, the port raises
:class:`~repro_torch.parallel.sharding.EPRegionError` naming the failed
condition (a rank holding only its share of the experts cannot compute the
global layout). :func:`compressed_expert_ffn` called directly under a mesh
splits each bucket over the model axis, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from ..models.layers import mlp
from ..models.moe import (
    capacity_dispatch,
    combine,
    count_ids,
    dispatch_capacity,
    route_topk,
    shared_d_ff,
    slot_fill_counts,
)
from ..parallel.sharding import EPRegionError, current_mesh, model_axis_size
from . import otp as otp_mod
from .quantizers import pack_codes, quantize_parts

__all__ = [
    "BucketMeta",
    "CompressedExperts",
    "FFN_BACKENDS",
    "build_compressed_experts",
    "compressed_expert_ffn",
    "compressed_moe_layer",
    "default_ffn_backend",
    "gmm_block_rows",
    "grouped_bucket_ffn",
    "resolve_ffn_backend",
    "scan_bucket_ffn",
]

_NAMES = ("w_gate", "w_up", "w_down")

FFN_BACKENDS = ("grouped", "scan", "ref")
#: the reference's backend the port refuses, and why
_REFUSED = {
    "interpret": "the Pallas interpreter, which has no torch counterpart; 'ref' runs the "
                 "plain versions",
}


def resolve_ffn_backend(backend: Optional[str]) -> str:
    """``backend`` (or the process default) checked against
    :data:`FFN_BACKENDS`; a ValueError names the refused ``"interpret"``."""
    b = backend or default_ffn_backend()
    if b in _REFUSED:
        raise ValueError(f"ffn backend {b!r} is not ported: {_REFUSED[b]}")
    if b not in FFN_BACKENDS:
        raise ValueError(f"ffn backend {b!r} not in {FFN_BACKENDS}")
    return b


def default_ffn_backend() -> str:
    """Process-wide expert-FFN path: ``REPRO_FFN_BACKEND`` or ``grouped``."""
    return os.environ.get("REPRO_FFN_BACKEND", "").strip().lower() or "grouped"


@dataclasses.dataclass(frozen=True)
class BucketMeta:
    bits: int
    start: int  # first permuted slot
    count: int  # padded expert count (a multiple of ep)


@dataclasses.dataclass
class CompressedExperts:
    """One layer's quantized experts: ``arrays[f"b{i}"][name]`` holds
    ``data`` (or ``hi``/``lo``), ``scale`` and ``zero`` with a leading
    ``[count]`` expert dim (``[resident_rows[i]]`` when host-offloaded);
    ``slot_of_expert [E]`` maps original expert ids to permuted slots and
    ``resident_map`` (``{b<i>: [count] int32}``, or None) bucket slots to
    resident rows."""

    meta: Tuple[BucketMeta, ...]
    slot_of_expert: torch.Tensor
    arrays: Dict
    num_slots: int
    group: int
    d_model: int
    d_ff: int
    resident_map: Optional[Dict] = None
    #: ``(model, data)`` extents of the mesh whose share of the buckets
    #: ``arrays`` holds (:func:`repro_torch.parallel.ep_shardmap.shard_experts`),
    #: or None for the whole buckets
    ep_cut: Optional[Tuple[int, int]] = None

    @property
    def resident_rows(self) -> Optional[Tuple[int, ...]]:
        """Device rows per bucket when host-offloaded (the partitions' leading
        dim), else None."""
        if self.resident_map is None:
            return None
        return tuple(self.arrays[f"b{i}"]["w_down"]["scale"].shape[0]
                     for i in range(len(self.meta)))

    @property
    def weight_bytes(self) -> int:
        """Device-resident quantized bytes (all of them when all-resident)."""
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
            resident_map=(None if self.resident_map is None else
                          {b: t.to(device) for b, t in self.resident_map.items()}),
        )


def _bucket_leaves(data, scale, zero, bits: int) -> Dict:
    out = {"scale": scale, "zero": zero}
    if bits == 3:
        out["hi"], out["lo"] = data
    else:
        out["data"] = data
    return out


#: f32 elements of one slice of a bucket quantized at once (1 GiB): HQQ's
#: temporaries are a few times the slice, and a whole bucket can be far
#: larger (kimi-k2's 363-expert 2-bit bucket is 21.3 GB per matrix in f32)
SLICE_ELEMENTS = 1 << 28


def _pack_stack(ws: torch.Tensor, bits: int, group: int, refine: bool) -> Dict:
    """Quantize + pack one bucket's ``[count, K, N]`` weights (each expert
    exactly as ``quantize_to_packed`` would)."""
    return _bucket_leaves(*quantize_parts(ws, bits, group, refine), bits)


def _pack_sliced(w: torch.Tensor, ids: Sequence[int], bits: int, group: int,
                 refine: bool) -> Dict:
    """:func:`_pack_stack` of experts ``ids`` of ``w [E, K, N]``, upcast and
    quantized a slice of the expert axis at a time (at most
    :data:`SLICE_ELEMENTS` f32 elements), the packed leaves concatenated.
    Quantization is per expert and group, so the bytes are the one-shot
    build's."""
    step = max(1, SLICE_ELEMENTS // (w.shape[1] * w.shape[2]))
    parts = []
    for s0 in range(0, len(ids), step):
        pick = torch.as_tensor(ids[s0:s0 + step], device=w.device)
        parts.append(_pack_stack(w.index_select(0, pick).float(), bits, group, refine))
    if len(parts) == 1:
        return parts[0]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def _pack_gptq(results: Sequence, bits: int) -> Dict:
    """Pack one bucket's GPTQ codes, scales and zeros as they are."""
    codes = torch.stack([r.codes for r in results])
    return _bucket_leaves(pack_codes(codes, bits), torch.stack([r.scale for r in results]),
                          torch.stack([r.zero for r in results]), bits)


def build_compressed_experts(experts: Dict[str, Callable[[], torch.Tensor]],
                             bits_per_expert: Sequence[int], *, group: int = 128,
                             ep: int = 1, refine: bool = True,
                             gptq_results: Optional[Dict] = None) -> CompressedExperts:
    """Quantize + bucket one layer's experts. ``experts`` maps each of
    "w_gate", "w_up", "w_down" to a function that makes its matrix (``[E,
    D, F]``, ``[E, D, F]``, ``[E, F, D]``); each is called in that order and
    its matrix dropped once packed, so a caller that draws them on demand
    holds one expert matrix at a time (one layer of kimi-k2-1t-a32b's is
    11.3 GB in bf16). Each bucket is quantized from f32 in slices of the
    expert axis (:func:`_pack_sliced`), or, with ``gptq_results[(expert,
    name)]`` (:class:`~.gptq.GPTQResult`), the GPTQ codes, scales and zeros
    of each expert are packed as they are. ``ep`` = expert-parallel shard
    count: each bucket is padded to a multiple of it with copies of its
    last expert (slots no expert id maps to)."""
    e = len(bits_per_expert)
    bits_arr = np.asarray(bits_per_expert)
    order = np.argsort(bits_arr, kind="stable")  # ascending bit groups
    slot_of_expert = np.full(e, -1, np.int64)
    buckets = []
    meta, slot = [], 0
    for bits in sorted(set(bits_arr.tolist())):
        ids = [int(i) for i in order if bits_arr[i] == bits]
        slot_of_expert[ids] = slot + np.arange(len(ids))
        pick = ids + [ids[-1]] * ((-len(ids)) % ep)  # dummy slots clone the last expert
        buckets.append((bits, pick))
        meta.append(BucketMeta(bits=bits, start=slot, count=len(pick)))
        slot += len(pick)
    arrays = {f"b{i}": {} for i in range(len(buckets))}
    for name in _NAMES:
        w = experts[name]()
        if name == "w_gate":
            d, f, device = w.shape[1], w.shape[2], w.device
        for i, (bits, pick) in enumerate(buckets):
            arrays[f"b{i}"][name] = (
                _pack_sliced(w, pick, bits, group, refine) if gptq_results is None else
                _pack_gptq([gptq_results[(j, name)] for j in pick], bits))
        del w
    return CompressedExperts(
        meta=tuple(meta), slot_of_expert=torch.as_tensor(slot_of_expert, device=device),
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
                       group: int, count: int, cap: int,
                       rmap: Optional[torch.Tensor] = None,
                       ffn_backend: str = "grouped") -> torch.Tensor:
    """One bucket's SwiGLU over its capacity slice ``xb [count·cap, D]`` as
    grouped GEMMs; returns ``[count·cap, D]`` in the same layout.

    ``fill [count]`` gives each slot's occupied-row count (a prefix):
    slot ``s`` row ``j < fill[s]`` moves to ``offsets[s] + j`` with groups
    packed back to back at ``bm`` boundaries; ``num_active`` counts the
    live blocks and unoccupied capacity rows come back exactly zero.
    ``rmap [count]`` (host-offloaded buckets) maps each slot to its row of
    ``wdict``'s resident leaves and is folded into ``block_expert``.
    ``ffn_backend`` (resolved, :data:`FFN_BACKENDS`) picks the GEMMs:
    ``"grouped"`` the :mod:`..kernels.ops` wrappers, ``"ref"`` their plain
    versions (differentiated by autograd, as the reference's are).
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
    if rmap is not None:
        block_expert = rmap[block_expert.long()].to(torch.int32)
    num_active = nblk.sum().to(torch.int32).reshape(1)
    gp, gs, gz = _parts(wdict["w_gate"], bits)
    up, us, uz = _parts(wdict["w_up"], bits)
    dp, ds, dz = _parts(wdict["w_down"], bits)
    if ffn_backend == "ref":
        gmm_swiglu, gmm = ref.moe_gmm_swiglu_ref, ref.moe_gmm_ref
    else:
        gmm_swiglu, gmm = ops.moe_gmm_swiglu, ops.moe_gmm
    h = gmm_swiglu(xg, gp, up, gs, gz, us, uz, block_expert, num_active, bits=bits,
                   group=group, bm=bm)
    yg = gmm(h, dp, ds, dz, block_expert, num_active, bits=bits, group=group, bm=bm)
    return torch.cat([yg, yg.new_zeros(1, d)], dim=0)[gdest]


def _ep_fallback(count: int, ep: int) -> None:
    """A bucket whose padded expert count the model-axis extent does not
    divide loses expert parallelism (every expert runs on every shard); that
    happens only when it was built with another ``ep`` than the mesh it runs
    under — a warning, fatal under ``REPRO_STRICT_EP=1`` (the reference's
    message and switch)."""
    msg = (
        f"compressed_expert_ffn: bucket of {count} padded experts is not "
        f"divisible by the model-axis size {ep}; falling back to ep=1 "
        f"(expert parallelism disabled for this bucket). Rebuild the "
        f"buckets with build_compressed_experts(..., ep={ep}) to restore "
        f"EP, or set REPRO_STRICT_EP=1 to make this fatal."
    )
    strict = os.environ.get("REPRO_STRICT_EP", "0").strip().lower()
    if strict not in ("", "0", "false", "off", "no"):
        raise AssertionError(msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _rows(wdict: Dict, rows: torch.Tensor) -> Dict:
    """The bucket leaves at expert rows ``rows`` (a resident map gathered
    back to the bucket's full layout)."""
    return {n: {key: t.index_select(0, rows.long()) for key, t in w.items()}
            for n, w in wdict.items()}


def _narrow(wdict: Dict, start: int, count: int) -> Dict:
    return {n: {key: t.narrow(0, start, count) for key, t in w.items()}
            for n, w in wdict.items()}


def scan_bucket_ffn(xb: torch.Tensor, wdict: Dict, *, bits: int, group: int, count: int,
                    cap: int) -> torch.Tensor:
    """The reference's per-expert scan over one bucket's capacity slice
    ``xb [count·cap, D]``: each expert's ``cap`` rows through
    ``silu(x @ Wg) * (x @ Wu) @ Wd``, one ``ops.quant_matmul_parts`` (the
    ``quant_matmul`` kernel on the card) per matrix, empty rows included."""

    def mm(x2, w, s):
        pk = (w["hi"][s], w["lo"][s]) if bits == 3 else w["data"][s]
        return ops.quant_matmul_parts(x2, pk, w["scale"][s], w["zero"][s], bits=bits,
                                      group=group)

    ys = []
    for s in range(count):
        x2 = xb[s * cap:(s + 1) * cap]
        h = F.silu(mm(x2, wdict["w_gate"], s)) * mm(x2, wdict["w_up"], s)
        ys.append(mm(h, wdict["w_down"], s))
    return torch.cat(ys, dim=0)


def compressed_expert_ffn(ce: CompressedExperts, xp: torch.Tensor, cap: int,
                          slot_fill: torch.Tensor, backend: Optional[str] = None) -> torch.Tensor:
    """SwiGLU over the permuted capacity layout ``xp [num_slots·cap, D]``,
    bucket by bucket, on the expert-FFN ``backend`` (:data:`FFN_BACKENDS`;
    None = the process default): :func:`grouped_bucket_ffn` (with each
    bucket's resident map when host-offloaded) or :func:`scan_bucket_ffn`
    (resident rows gathered back to the full bucket first).

    Under a mesh each bucket splits over the model axis (ep =
    :func:`~repro_torch.parallel.sharding.model_axis_size`, baked into the
    bucket padding at build time): the grouped path runs each shard's
    ``count / ep`` experts as a bucket of its own, as the reference's vmap
    over the shard axis does; a bucket that ep does not divide falls back
    to ep = 1 (:func:`_ep_fallback`)."""
    backend = resolve_ffn_backend(backend)
    ys = []
    for i, m in enumerate(ce.meta):
        b = ce.arrays[f"b{i}"]
        rmap = None if ce.resident_map is None else ce.resident_map[f"b{i}"]
        ep = model_axis_size()
        if m.count % ep:
            _ep_fallback(m.count, ep)
            ep = 1
        xb = xp[m.start * cap:(m.start + m.count) * cap]
        fill = slot_fill[m.start:m.start + m.count]
        if backend == "scan" or ep > 1:
            if rmap is not None:
                b, rmap = _rows(b, rmap), None
        if backend == "scan":
            ys.append(scan_bucket_ffn(xb, b, bits=m.bits, group=ce.group, count=m.count,
                                      cap=cap))
            continue
        if ep == 1:
            ys.append(grouped_bucket_ffn(xb, b, fill, bits=m.bits, group=ce.group,
                                         count=m.count, cap=cap, rmap=rmap, ffn_backend=backend))
            continue
        local = m.count // ep
        ys.extend(
            grouped_bucket_ffn(xb[e * local * cap:(e + 1) * local * cap], _narrow(b, e * local, local),
                               fill[e * local:(e + 1) * local], bits=m.bits, group=ce.group,
                               count=local, cap=cap, ffn_backend=backend)
            for e in range(ep))
    return torch.cat(ys, dim=0)


def compressed_moe_layer(p: Dict, ce: CompressedExperts, x: torch.Tensor, cfg, *,
                         otp_params: Optional[Dict] = None, otp_rng=None,
                         otp_tau: float = 1.0,
                         capacity_factor: Optional[float] = None,
                         count_weight: Optional[torch.Tensor] = None,
                         ffn_backend: Optional[str] = None,
                         rows: Optional[torch.Tensor] = None,
                         capacity: Optional[int] = None):
    """MoE block with PMQ experts and optional OTP pruning. ``p`` carries
    the router and the shared experts. Returns ``(y [B, S, D], info)``;
    ``info["mask"]`` is the OTP mask ``[T, k]`` (or None), ``info["mask_l1"]``
    its mean (the Eq. 14 ℓ1 term, or None) and ``info["slot_counts"]`` the
    per-slot count of dispatched (token, choice) pairs after masking, with
    tokens where ``count_weight`` is false left out. ``otp_rng`` (uniforms
    ``[T, k]`` or a generator) samples the mask by Gumbel-Softmax at
    temperature ``otp_tau`` (training); without it the mask is the argmax.
    ``ffn_backend`` as in :func:`compressed_expert_ffn`. ``rows`` (``[B,
    S]`` bool) dispatches only those tokens to the routed experts: the
    others' (token, choice) pairs go to the drop bucket, so they take no
    capacity (and their rows of ``y`` hold only the shared experts);
    ``capacity`` replaces the per-slot capacity the token count gives.

    Under a mesh the routed experts run the shard_map EP region
    (:func:`repro_torch.parallel.ep_shardmap.compressed_moe_region_sharded`;
    ``x`` is this rank's block of the batch, ``ce`` the whole buckets or
    this rank's share of them) and ``info`` holds only ``mask_l1``, as the
    reference's. An offloaded ``ce``, a slot count or a bucket that the
    model axis does not divide raise :class:`EPRegionError`."""
    mesh = current_mesh()
    if mesh is not None:
        from ..models.moe import ep_shardmap_ok
        from ..parallel.ep_shardmap import compressed_moe_region_sharded

        model = mesh.shape.get("model", 1)
        if ce.resident_map is not None:
            raise EPRegionError("compressed_moe_layer under a mesh: host-offloaded buckets "
                                "(resident_map) leave the EP region")
        if not ep_shardmap_ok(cfg, mesh, x, ce.num_slots):
            raise EPRegionError(f"compressed_moe_layer under a mesh: ep_shardmap_ok is false "
                                f"({ce.num_slots} slots over model={model})")
        bad = [m.count for m in ce.meta if m.count % model]
        if bad:
            raise EPRegionError(f"compressed_moe_layer under a mesh: bucket counts {bad} are "
                                f"not multiples of model={model} (build with ep={model})")
        y, mask_l1 = compressed_moe_region_sharded(
            p, ce, x, cfg, mesh, otp_params=otp_params, otp_rng=otp_rng, otp_tau=otp_tau,
            capacity_factor=capacity_factor, ffn_backend=ffn_backend)
        if "shared" in p:
            b, s, d = x.shape
            y = y + mlp(p["shared"], x.reshape(b * s, d), shared_d_ff(cfg)).reshape(b, s, d)
        info = {"probs": None, "idx": None, "gates": None, "mask": None,
                "mask_l1": mask_l1 if otp_params is not None else None, "slot_counts": None}
        return y, info
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    k = cfg.top_k
    probs, idx, gates = route_topk(p["router"], x2, k)
    mask = None
    if otp_params is not None:
        mask = otp_mod.otp_mask(otp_params, x2, idx, gates, rng=otp_rng, tau=otp_tau)
    slots = ce.slot_of_expert[idx]  # original expert ids → permuted slots
    eff = slots.reshape(-1)
    if mask is not None:
        eff = torch.where(mask.reshape(-1) > 0, eff, ce.num_slots)
    if count_weight is not None:
        cw = count_weight.reshape(-1).bool().repeat_interleave(k)
        eff = torch.where(cw, eff, ce.num_slots)
    slot_counts = count_ids(eff, ce.num_slots)
    cap = capacity or dispatch_capacity(cfg, t, capacity_factor)
    dmask = mask
    if rows is not None:
        keep = rows.reshape(t, 1).to(gates.dtype).expand(t, k)
        dmask = keep if mask is None else mask * keep
    xp, dest, valid, gflat = capacity_dispatch(x2, slots, gates, ce.num_slots, cap, dmask)
    slot_fill = slot_fill_counts(dest, valid, ce.num_slots, cap)
    yp = compressed_expert_ffn(ce, xp, cap, slot_fill, backend=ffn_backend)
    y = combine(yp, dest, valid, gflat, t, k)
    if "shared" in p:
        y = y + mlp(p["shared"], x2, shared_d_ff(cfg))
    info = {"probs": probs, "idx": idx, "gates": gates, "mask": mask,
            "mask_l1": mask.mean() if mask is not None else None, "slot_counts": slot_counts}
    return y.reshape(b, s, d), info
