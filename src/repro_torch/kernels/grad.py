"""Gradients of the three dequant GEMMs with respect to ``x``.

Each :class:`torch.autograd.Function` here runs the GEMM's wrapper forward
(the Hopper kernel on a CUDA tensor, the plain version on a CPU one) and a
plain PyTorch backward that repeats what autograd through the plain
version (:mod:`.ref`) computes, operation for operation: the weights are
dequantized in the compute type, the output gradient is multiplied in f32
and rounded back through the compute type to ``x``'s dtype. Packed
weights, scales, zeros and block tables get no gradient.

Memory is the point. Autograd through ``moe_gmm_ref`` keeps every gathered
``[nblocks, K, N]`` f32 weight stack alive until the backward (~1.5 GB per
grouped GEMM of one bucket at 2048 × 1408); these keep only ``x`` (the
SwiGLU) and references to the packed weights. The backward dequantizes the
live experts a slice at a time, gathers one weight per live row block of
the slice, multiplies the blocks in one batched product and drops them;
the SwiGLU's ``x @ Wg`` and ``x @ Wu`` are recomputed, not saved. Dead row
blocks (index ≥ ``num_active``) get a zero gradient.
"""
from __future__ import annotations

import torch

from . import moe_gmm as _gmm
from . import quant_matmul as _qm
from .ref import compute_dtype, dequant_ref

__all__ = ["MoeGmm", "MoeGmmSwiglu", "QuantMatmul", "wants_grad"]

#: f32 elements of the experts one backward slice dequantizes at once (1 GiB)
SLICE_ELEMENTS = 1 << 28


def wants_grad(x: torch.Tensor) -> bool:
    """Whether a call with ``x`` records a graph."""
    return torch.is_grad_enabled() and x.requires_grad


def _packed(bits: int, p0, p1):
    return (p0, p1) if bits == 3 else p0


def _back(gy: torch.Tensor, w: torch.Tensor, cd: torch.dtype, dtype: torch.dtype) -> torch.Tensor:
    """``∂(gy · (a @ w))/∂a`` as autograd through ``ref._dot`` gives it:
    an f32 product, rounded to the compute type, then to ``x``'s dtype."""
    return (gy.float() @ w.float().t()).to(cd).to(dtype)


class QuantMatmul(torch.autograd.Function):
    """``y = x @ dq(W)`` (``ops.quant_matmul``); ``x [M, K]``."""

    @staticmethod
    def forward(ctx, x, bits, group, scale, zero, p0, p1):
        ctx.bits, ctx.group, ctx.k, ctx.dtype = bits, group, x.shape[-1], x.dtype
        ctx.save_for_backward(scale, zero, p0, p1)
        return _qm.quant_matmul(x.contiguous(), _packed(bits, p0, p1), scale, zero, bits=bits,
                                group=group)

    @staticmethod
    def backward(ctx, gy):
        scale, zero, p0, p1 = ctx.saved_tensors
        cd = compute_dtype(torch.empty(0, dtype=ctx.dtype))
        w = dequant_ref(_packed(ctx.bits, p0, p1), scale, zero, ctx.bits, ctx.k, ctx.group,
                        dtype=cd)
        return _back(gy, w, cd, ctx.dtype), None, None, None, None, None, None


def _live_slices(block_expert: torch.Tensor, num_active: torch.Tensor, k: int, n: int,
                 operands: int, experts: int):
    """The live row blocks grouped by slices of their experts, at most
    :data:`SLICE_ELEMENTS` dequantized f32 elements per operand and slice:
    ``(ids [experts of the slice], blocks [live blocks whose expert is in
    it], local [each block's expert's position in ids])``, on the tables'
    device. Reads the tables back to the host once: the backward may sync.
    Tables on ``meta`` (the dry run) hold no values: one slice of all
    ``experts`` and every block, the static capacity the forward is counted
    at."""
    if block_expert.device.type == "meta":
        yield (torch.arange(experts, device="meta"),
               torch.arange(block_expert.shape[0], device="meta"), block_expert.long())
        return
    host = torch.cat([num_active.reshape(-1), block_expert]).cpu().long()
    be = host[1:1 + int(host[0])]
    experts = torch.unique(be)
    step = max(1, SLICE_ELEMENTS // (k * n * operands))
    for s0 in range(0, experts.numel(), step):
        ids = experts[s0:s0 + step]
        blocks = torch.nonzero(torch.isin(be, ids)).reshape(-1)
        local = torch.searchsorted(ids, be[blocks])
        yield (t.to(block_expert.device) for t in (ids, blocks, local))


def _dequant_experts(ids, p0, p1, scale, zero, bits, k, group, cd):
    pick = (lambda t: None if t is None else t.index_select(0, ids))
    return dequant_ref(_packed(bits, pick(p0), pick(p1)), pick(scale), pick(zero), bits, k,
                       group, dtype=cd)


def _bmm(a: torch.Tensor, w: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Block-batched f32 product of ``a [nb, bm, ·]`` with ``w [nb, K, N]``
    (or its transpose) — ``ref._dot``'s f32 products."""
    wf = w.float()
    return torch.bmm(a.float(), wf.transpose(1, 2) if transpose else wf)


class MoeGmm(torch.autograd.Function):
    """``ops.moe_gmm``: row block ``i`` of ``x [Mp, K]`` times expert
    ``block_expert[i]``, blocks at or past ``num_active`` zero."""

    @staticmethod
    def forward(ctx, x, bits, group, bm, scale, zero, block_expert, num_active, p0, p1):
        ctx.bits, ctx.group, ctx.bm, ctx.k, ctx.dtype = bits, group, bm, x.shape[-1], x.dtype
        ctx.save_for_backward(scale, zero, block_expert, num_active, p0, p1)
        return _gmm.moe_gmm(x.contiguous(), _packed(bits, p0, p1), scale, zero, block_expert,
                            num_active, bits=bits, group=group, bm=bm)

    @staticmethod
    def backward(ctx, gy):
        scale, zero, block_expert, num_active, p0, p1 = ctx.saved_tensors
        cd = compute_dtype(torch.empty(0, dtype=ctx.dtype))
        bm, k, n = ctx.bm, ctx.k, gy.shape[1]
        dx = gy.new_zeros((gy.shape[0], k), dtype=ctx.dtype)
        dx3, gy3 = dx.view(-1, bm, k), gy.reshape(-1, bm, n)
        for ids, blocks, local in _live_slices(block_expert, num_active, k, n, 1, p0.shape[0]):
            w = _dequant_experts(ids, p0, p1, scale, zero, ctx.bits, k, ctx.group, cd)[local]
            dx3[blocks] = _bmm(gy3[blocks], w, True).to(cd).to(ctx.dtype)
            del w
        return (dx,) + (None,) * 9


class MoeGmmSwiglu(torch.autograd.Function):
    """``ops.moe_gmm_swiglu``: ``silu(x @ Wg[e]) * (x @ Wu[e])`` per row
    block, the two products in f32 as the plain version makes them."""

    @staticmethod
    def forward(ctx, x, bits, group, bm, g_scale, g_zero, u_scale, u_zero, block_expert,
                num_active, g0, g1, u0, u1):
        ctx.bits, ctx.group, ctx.bm, ctx.dtype = bits, group, bm, x.dtype
        ctx.save_for_backward(x, g_scale, g_zero, u_scale, u_zero, block_expert, num_active,
                              g0, g1, u0, u1)
        return _gmm.moe_gmm_swiglu(x.contiguous(), _packed(bits, g0, g1), _packed(bits, u0, u1),
                                   g_scale, g_zero, u_scale, u_zero, block_expert, num_active,
                                   bits=bits, group=group, bm=bm)

    @staticmethod
    def backward(ctx, gy):
        x, gs, gz, us, uz, block_expert, num_active, g0, g1, u0, u1 = ctx.saved_tensors
        cd = compute_dtype(x)
        bm, k, n, bits, group = ctx.bm, x.shape[-1], gy.shape[1], ctx.bits, ctx.group
        dx = torch.zeros_like(x)
        dx3, x3, gy3 = dx.view(-1, bm, k), x.reshape(-1, bm, k), gy.reshape(-1, bm, n)
        for ids, blocks, local in _live_slices(block_expert, num_active, k, n, 2, g0.shape[0]):
            wg = _dequant_experts(ids, g0, g1, gs, gz, bits, k, group, cd)[local]
            wu = _dequant_experts(ids, u0, u1, us, uz, bits, k, group, cd)[local]
            xb = x3[blocks].to(cd)
            g, u = _bmm(xb, wg, False), _bmm(xb, wu, False)
            sg = torch.sigmoid(g)
            dh = gy3[blocks].float()
            dg = dh * u * (sg * (1 + g * (1 - sg)))
            du = dh * (g * sg)
            dx3[blocks] = (_bmm(dg, wg, True).to(cd).to(x.dtype)
                           + _bmm(du, wu, True).to(cd).to(x.dtype))
            del wg, wu, g, u
        return (dx,) + (None,) * 13
