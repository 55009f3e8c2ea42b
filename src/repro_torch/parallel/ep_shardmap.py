"""Expert parallelism with no all-to-all (port of ``repro/parallel/ep_shardmap.py``).

The MoE region's input is replicated over the model axis within each data
shard, so every rank (data d, model m)

1. routes its data shard's tokens (the same on every m),
2. keeps the (token, k) slots whose expert lives on model shard m,
3. runs the local capacity dispatch and expert FFN (bf16 einsums, or the
   PMQ buckets through the grouped GEMMs or the per-expert scan),
4. contributes its partial combine; one ``all_reduce`` over ``model`` per
   layer merges the expert outputs.

The reference runs this as a ``shard_map`` body on every device of one
SPMD program; here each rank runs it in its own process on its own
tensors: ``x`` is this rank's block of the batch axes and the result is
too. The experts may arrive whole (each rank cuts its share as a view) or
already cut by :func:`shard_experts` / :func:`shard_params`.

2-D expert sharding (ETP: EP over model × expert-TP over data) splits
``w_gate``/``w_up`` by columns and ``w_down`` by rows of F over data, where
the quant groups align with the F shards. Small batches replicate the
tokens over data (all-gathered here, as GSPMD would for the reference's
``P(None)``) and sum the F partials; large ones keep their tokens and
all-gather the layer's F shards. ``REPRO_ETP_REPLICATE_MAX`` sets the
switch, as in the reference.

Gradients flow through both regions (the reference's ``jax.grad`` through
its ``shard_map``): the routing runs on every rank of a model line alike,
so the router and ``x`` take their gradients whole there, while the
dispatch and combine — each rank's share of the experts — enter through
:func:`~repro_torch.parallel.sharding.enter`, which sums their partial
gradients over ``model``. ``aux`` and ``mask_l1`` are replicated over the
line; their gradients average over the batch axes, as the reference's
``pmean`` and its unmapped ``P()`` output do.

:func:`shard_params` also splits every tensor-parallel pair of every
family's blocks over ``model`` (the reference's ``_PARAM_RULES``:
attention and cross-attention by heads, the MLPs by F, the recurrent and
xLSTM blocks by width or heads) where
:func:`~repro_torch.parallel.sharding.tp_split` allows it (whole heads and
quant groups), and the embeddings by vocabulary rows where
:func:`~repro_torch.parallel.sharding.vocab_split` does; the layers then
run their share and ``all_reduce`` after the row-parallel leaf.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import otp as otp_mod
from ..core.packing import PackedTensor
from ..core.compressed_moe import (
    CompressedExperts,
    grouped_bucket_ffn,
    resolve_ffn_backend,
    scan_bucket_ffn,
)
from ..models import moe as moe_mod
from .sharding import (
    TP_PAIRS,
    EPRegionError,
    Mesh,
    all_gather,
    all_reduce,
    batch_axes,
    enter,
    manual_region,
    shard_tensor,
    tp_kind,
    tp_pairs,
    tp_split,
    tp_width,
    vocab_split,
)

__all__ = [
    "compressed_moe_region_sharded",
    "etp_ok",
    "expert_spec",
    "moe_region_sharded",
    "shard_experts",
    "shard_params",
    "tp_plan",
]

class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _batch_mean_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as it is, its gradient divided by the batch axes' extent: a
    statistic each data shard computes for itself (or all of them alike)
    whose gradient is the mean over the shards — the reference's unmapped
    ``P()`` output, whose cotangent is split over the axes it leaves out."""
    n = mesh.extent(batch_axes(mesh))
    return x if n == 1 else _GradScale.apply(x, 1.0 / n)


def _local_experts(w: torch.Tensor, e: int, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a stacked bf16 expert weight ``[E, ·, ·]``, whole
    or already cut (``[E / model, ·, ·]``)."""
    return shard_tensor(w, ("model", None, None), mesh) if w.shape[0] == e else w


def moe_region_sharded(p: Dict, x: torch.Tensor, cfg, mesh: Mesh, gate_mask_fn=None):
    """The bf16 expert path: ``x [B, S, D]`` (this rank's batch block) →
    ``(y [B, S, D], aux)`` with the load-balance loss averaged over the
    batch axes."""
    e, k = cfg.num_experts, cfg.top_k
    model = mesh.shape["model"]
    eploc = e // model
    ba = batch_axes(mesh)
    wg, wu, wd = (_local_experts(p["experts"][n], e, mesh) for n in ("w_gate", "w_up", "w_down"))
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    t = x2.shape[0]
    with manual_region():
        probs, idx, gates = moe_mod.route_topk(p["router"], x2, k)
        mask = gate_mask_fn(x2, idx, gates) if gate_mask_fn else None
        lo = mesh.coord["model"] * eploc
        sel = ((idx >= lo) & (idx < lo + eploc)).to(gates.dtype)
        if mask is not None:
            sel = sel * enter(mask, mesh, "model")
        local_idx = torch.clamp(idx - lo, 0, eploc - 1)
        cap = moe_mod.dispatch_capacity(cfg, t)
        xp, dest, valid, gflat = moe_mod.capacity_dispatch(
            enter(x2, mesh, "model"), local_idx, enter(gates, mesh, "model"), eploc, cap,
            gate_mask=sel)
        x3 = xp.reshape(eploc, cap, d)
        h = F.silu(torch.bmm(x3, wg.to(x3.dtype))) * torch.bmm(x3, wu.to(x3.dtype))
        yp = torch.bmm(h, wd.to(x3.dtype)).reshape(eploc * cap, d)
        y = all_reduce(moe_mod.combine(yp, dest, valid, gflat, t, k), mesh, "model")
        aux = all_reduce(moe_mod.load_balance_loss(probs, idx, e), mesh, ba) / mesh.extent(ba)
    return y.reshape(b, s, d), aux


def _slot_tables(meta, model: int) -> Tuple[np.ndarray, np.ndarray]:
    """Global permuted slot → (model shard, local slot). Bucket rows shard
    contiguously within each bucket, so shard m's local layout is its share
    of every bucket, in bucket order."""
    num_slots = sum(m.count for m in meta)
    shard_of = np.zeros(num_slots, np.int32)
    local_of = np.zeros(num_slots, np.int32)
    for m in meta:
        cnt_loc = m.count // model
        off = np.arange(m.count)
        shard_of[m.start:m.start + m.count] = off // cnt_loc
        local_of[m.start:m.start + m.count] = m.start // model + off % cnt_loc
    return shard_of, local_of


def etp_ok(ce: CompressedExperts, data: int) -> bool:
    """2-D expert sharding applies: F splits over ``data`` in whole quant
    groups."""
    f = ce.d_ff
    return (data > 1 and f % data == 0 and (f // data) % ce.group == 0
            and (f // ce.group) % data == 0)


def expert_spec(wname: str, ndim: int, etp: bool) -> Tuple:
    """The spec of a bucket leaf (the reference's ``_wspec``): rows over
    model; under ETP also F over data (``w_gate``/``w_up`` columns,
    ``w_down`` rows)."""
    if not etp:
        return ("model",) + (None,) * (ndim - 1)
    if wname in ("w_gate", "w_up"):
        return ("model",) + (None,) * (ndim - 2) + ("data",)
    return ("model", "data") + (None,) * (ndim - 2)


def _cut(ce: CompressedExperts, mesh: Mesh) -> Dict:
    etp = etp_ok(ce, mesh.shape.get("data", 1))
    return {bn: {wn: {key: shard_tensor(a, expert_spec(wn, a.dim(), etp), mesh)
                      for key, a in entry.items()}
                 for wn, entry in bucket.items()}
            for bn, bucket in ce.arrays.items()}


def _extents(mesh: Mesh) -> Tuple[int, int]:
    return mesh.shape["model"], mesh.shape.get("data", 1)


def shard_experts(ce: CompressedExperts, mesh: Mesh) -> CompressedExperts:
    """This rank's share of the whole buckets (copies, so the whole can be
    freed): ``count / model`` rows of each bucket and, under ETP, ``F /
    data`` of its columns or rows (:func:`expert_spec`)."""
    if ce.ep_cut is not None:
        raise ValueError(f"buckets already cut for (model, data) = {ce.ep_cut}")
    bad = [m.count for m in ce.meta if m.count % mesh.shape["model"]]
    if bad:
        raise EPRegionError(f"bucket counts {bad} are not multiples of "
                            f"model={mesh.shape['model']}")
    arrays = {bn: {wn: {key: a.clone() for key, a in entry.items()}
                   for wn, entry in bucket.items()}
              for bn, bucket in _cut(ce, mesh).items()}
    return dataclasses.replace(ce, arrays=arrays, ep_cut=_extents(mesh))


_log = logging.getLogger(__name__)


def tp_plan(block: Dict, mesh: Mesh, cfg) -> Dict[str, bool]:
    """Which tensor-parallel pairs of a whole block (a layer, a group, an
    encoder or decoder block) split over ``model``: ``{path in the block:
    bool}`` for each pair :func:`~repro_torch.parallel.sharding.tp_pairs`
    finds, by :func:`~repro_torch.parallel.sharding.tp_split`. A pair that
    does not split stays whole on every rank."""
    model = mesh.shape.get("model", 1)
    return {path: tp_split(node, kind, model, cfg, tp_width(node, kind))
            for path, kind, node in tp_pairs(block)}


def _cut_cols(w, mesh: Mesh, halves: bool = False):
    if halves:  # ``[a | b]``: this rank's columns of each half, side by side
        n = w.shape[1] // 2
        return torch.cat([_cut_cols(w[:, :n], mesh), _cut_cols(w[:, n:], mesh)], dim=1)
    n = w.shape[1] // mesh.shape["model"]
    n0 = mesh.coord["model"] * n
    if isinstance(w, PackedTensor):
        return w.slice_cols(n0, n0 + n)
    return w[:, n0:n0 + n].clone()


def _cut_rows(w, mesh: Mesh):
    k = w.shape[0] // mesh.shape["model"]
    k0 = mesh.coord["model"] * k
    if isinstance(w, PackedTensor):
        return w.slice_rows(k0, k0 + k)
    return w[k0:k0 + k].clone()


def _tp_block(block: Dict, mesh: Mesh, cfg, whole: set) -> Dict:
    """A copy of ``block`` (nested dicts copied, tensors shared) with each
    pair :func:`tp_plan` splits cut to this rank's share; the paths of the
    pairs it keeps whole are added to ``whole``."""
    plan = tp_plan(block, mesh, cfg)
    whole.update(p or "." for p, ok in plan.items() if not ok)

    def cut(node, prefix):
        node = dict(node)
        for key, child in node.items():
            if isinstance(child, dict):
                node[key] = cut(child, f"{prefix}/{key}" if prefix else key)
        if plan.get(prefix):
            pair = TP_PAIRS[tp_kind(node)]
            for name in pair.cols:
                node[name] = dict(node[name], w=_cut_cols(node[name]["w"], mesh,
                                                          name in pair.halves))
            if pair.row:
                node[pair.row] = dict(node[pair.row], w=_cut_rows(node[pair.row]["w"], mesh))
        return node

    return cut(block, "")


#: the lists of blocks in each family's tree
BLOCK_LISTS = ("layers", "enc_blocks", "dec_blocks", "groups", "tail")


def shard_params(params: Dict, mesh: Mesh, cfg) -> Dict:
    """The port's tree of ``cfg`` as one rank of ``mesh`` holds it: each
    layer's PMQ buckets cut by :func:`shard_experts` and bf16 experts to
    this rank's rows; in every block the pairs of :func:`tp_plan` that
    split — attention's ``wq``/``wk``/``wv`` by this rank's heads and ``wo``
    by their rows, the MLPs' ``w_gate``/``w_up`` by columns and ``w_down`` by
    rows, the recurrent and xLSTM blocks' column leaves by columns (a
    halves leaf half by half) and ``proj_out`` by rows, float or
    PackedTensor alike (copies); and ``embed``/``unembed`` by vocabulary
    rows where :func:`~repro_torch.parallel.sharding.vocab_split` splits
    them. Every other parameter stays whole (shared with ``params``); the
    pairs kept whole are logged."""
    out = dict(params)
    whole: set = set()
    for key in BLOCK_LISTS:
        if key not in params:
            continue
        blocks = []
        for p in params[key]:
            p = dict(p)
            if "moe_ce" in p:
                p["moe_ce"] = shard_experts(p["moe_ce"], mesh)
            if "experts" in p.get("moe", {}):
                e = p["moe"]["experts"]["w_gate"].shape[0]
                p["moe"] = dict(p["moe"], experts={
                    n: _local_experts(w, e, mesh).clone()
                    for n, w in p["moe"]["experts"].items()})
            blocks.append(_tp_block(p, mesh, cfg, whole))
        out[key] = blocks
    model = mesh.shape.get("model", 1)
    for name in ("embed", "unembed"):
        if name in params and vocab_split(cfg.vocab_size, model):
            out[name] = _cut_rows(params[name], mesh)
        elif name in params and model > 1:
            whole.add(name)
    if whole and model > 1:
        _log.info("tensor parallelism over model=%d keeps whole: %s", model,
                  ", ".join(sorted(whole)))
    return out


def _local_buckets(ce: CompressedExperts, mesh: Mesh) -> Dict:
    if ce.ep_cut is None:
        return _cut(ce, mesh)
    if ce.ep_cut != _extents(mesh):
        raise EPRegionError(f"buckets cut for (model, data) = {ce.ep_cut} run on a mesh of "
                            f"{_extents(mesh)}")
    return ce.arrays


def compressed_moe_region_sharded(p: Dict, ce: CompressedExperts, x: torch.Tensor, cfg,
                                  mesh: Mesh, otp_params: Optional[Dict] = None, otp_rng=None,
                                  otp_tau: float = 1.0, capacity_factor: Optional[float] = None,
                                  ffn_backend: Optional[str] = None):
    """The PMQ expert path: ``x [B, S, D]`` (this rank's batch block) →
    ``(y [B, S, D], mask_l1)``. Each of this rank's buckets runs its share
    of the slots through :func:`~repro_torch.core.compressed_moe.grouped_bucket_ffn`
    (the two grouped GEMMs, dead blocks skipped) or, under
    ``ffn_backend="scan"``, :func:`~repro_torch.core.compressed_moe.scan_bucket_ffn`.
    Bucket counts must be multiples of the model extent (build with
    ``ep=model``). Uniforms in ``otp_rng`` are this rank's tokens' rows, as
    ``x`` is (all-gathered with it under ``replicate_tokens``)."""
    backend = resolve_ffn_backend(ffn_backend)
    ba = batch_axes(mesh)
    model = mesh.shape["model"]
    data = mesh.shape.get("data", 1)
    k = cfg.top_k
    eploc = ce.num_slots // model
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity_factor
    shard_of_np, local_of_np = _slot_tables(ce.meta, model)
    shard_of = torch.as_tensor(shard_of_np, device=x.device).long()
    local_of = torch.as_tensor(local_of_np, device=x.device).long()
    etp = etp_ok(ce, data)
    t_global = x.shape[0] * x.shape[1] * mesh.extent(ba)
    etp_mode = None
    if etp:
        thresh = int(os.environ.get("REPRO_ETP_REPLICATE_MAX", 32768))
        etp_mode = "replicate_tokens" if t_global <= thresh else "gather_weights"
    local = _local_buckets(ce, mesh)
    if etp_mode == "gather_weights":
        local = {bn: {wn: {key: all_gather(a, mesh, "data",
                                           a.dim() - 1 if wn in ("w_gate", "w_up") else 1)
                           for key, a in entry.items()}
                      for wn, entry in bucket.items()}
                 for bn, bucket in local.items()}
    xl = all_gather(x, mesh, ba, 0) if etp_mode == "replicate_tokens" else x
    if isinstance(otp_rng, torch.Tensor) and etp_mode == "replicate_tokens":
        otp_rng = all_gather(otp_rng.reshape(x.shape[0], -1, otp_rng.shape[-1]).detach(), mesh,
                             ba, 0).reshape(-1, otp_rng.shape[-1])
    slot_map = ce.slot_of_expert
    if slot_map.dim() > 1:
        slot_map = slot_map[0]
    b, s, d = xl.shape
    x2 = xl.reshape(b * s, d)
    t = x2.shape[0]
    with manual_region():
        probs, idx, gates = moe_mod.route_topk(p["router"], x2, k)
        mask = None
        if otp_params is not None:
            mask = otp_mod.otp_mask(otp_params, x2, idx, gates, rng=otp_rng, tau=otp_tau)
        sidx = slot_map.long()[idx]  # original expert id → permuted slot
        sel = (shard_of[sidx] == mesh.coord["model"]).to(gates.dtype)
        if mask is not None:
            sel = sel * enter(mask, mesh, "model")
        local_idx = local_of[sidx]
        cap = moe_mod.dispatch_capacity(cfg, t, cf)
        xp, dest, valid, gflat = moe_mod.capacity_dispatch(
            enter(x2, mesh, "model"), local_idx, enter(gates, mesh, "model"), eploc, cap,
            gate_mask=sel)
        local_fill = moe_mod.slot_fill_counts(dest, valid, eploc, cap)
        ys = []
        for i, m in enumerate(ce.meta):
            cnt_loc, st_loc = m.count // model, m.start // model
            xb = xp[st_loc * cap:(st_loc + cnt_loc) * cap]
            w = local[f"b{i}"]
            if backend == "scan":
                ys.append(scan_bucket_ffn(xb, w, bits=m.bits, group=ce.group, count=cnt_loc,
                                          cap=cap))
            else:
                ys.append(grouped_bucket_ffn(xb, w, local_fill[st_loc:st_loc + cnt_loc],
                                             bits=m.bits, group=ce.group, count=cnt_loc,
                                             cap=cap, ffn_backend=backend))
        yp = torch.cat(ys, dim=0)
        if etp_mode == "replicate_tokens":
            # F partials of replicated tokens; each data rank's cotangent
            # covers its own tokens only, so the backward sums them
            yp = all_reduce(yp, mesh, "data", backward="all_reduce")
        y = all_reduce(moe_mod.combine(yp, dest, valid, gflat, t, k), mesh, "model")
        m_l1 = (_batch_mean_grad(mask.mean(), mesh) if mask is not None
                else torch.zeros((), device=x.device))
    y = y.reshape(b, s, d)
    if etp_mode == "replicate_tokens":
        y = y.narrow(0, mesh.index(ba) * x.shape[0], x.shape[0])
    return y, m_l1
