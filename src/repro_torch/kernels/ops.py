"""Public wrappers the model calls (port of ``repro/kernels/ops.py``).

They flatten leading dims, take a :class:`PackedTensor`, check block
shapes, and hand the tensors to the kernel wrappers, which route by
device: a CUDA tensor launches the Hopper kernel (or raises), a CPU tensor
runs the plain version. Models never call a kernel directly.

The three dequant GEMMs are differentiable in ``x``: when ``x`` requires
grad they run through a :class:`torch.autograd.Function` whose forward is
the same kernel (or plain version) and whose backward is plain PyTorch
(:mod:`.grad`). Packed weights, scales and zeros are frozen and get no
gradient. The reference differentiates through its plain versions; it has
no backward kernel either.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.packing import PackedTensor
from . import binary_matmul as _bm
from . import grad as _grad
from . import moe_gmm as _gmm
from . import paged_attention as _pa
from . import quant_matmul as _qm

__all__ = [
    "binary_matmul",
    "moe_gmm",
    "moe_gmm_swiglu",
    "paged_attention",
    "quant_matmul",
    "quant_matmul_parts",
]


def quant_matmul(x: torch.Tensor, pt: PackedTensor) -> torch.Tensor:
    """``y = x @ dequant(pt)`` for any leading x shape; K = pt.shape[0]."""
    return quant_matmul_parts(x, pt.data, pt.scale, pt.zero, bits=pt.bits, group=pt.group)


def quant_matmul_parts(x: torch.Tensor, w_packed, scale, zero, *, bits: int,
                       group: int = 128) -> torch.Tensor:
    """``y = x @ dequant(w)`` from raw packed parts ``[K/per, N]`` (or the
    3-bit ``(hi, lo)`` pair). The kernel masks ragged rows itself, so M
    needs no padding."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if _grad.wants_grad(x2):
        y = _grad.QuantMatmul.apply(x2, bits, group, scale, zero, *_qm.planes(w_packed, bits))
    else:
        y = _qm.quant_matmul(x2.contiguous(), w_packed, scale, zero, bits=bits, group=group)
    return y.reshape(*lead, y.shape[-1])


def moe_gmm(x_padded, w_packed, scale, zero, block_expert, num_active, *, bits: int,
            group: int = 128, bm: int = 16) -> torch.Tensor:
    """Grouped expert GEMM with the ragged skip of row blocks at or past
    ``num_active[0]`` (the routed-token frontier)."""
    if _grad.wants_grad(x_padded):
        return _grad.MoeGmm.apply(x_padded, bits, group, bm, scale, zero, block_expert,
                                  num_active, *_qm.planes(w_packed, bits))
    return _gmm.moe_gmm(x_padded.contiguous(), w_packed, scale, zero, block_expert,
                        num_active, bits=bits, group=group, bm=bm)


def moe_gmm_swiglu(x_padded, wg_packed, wu_packed, g_scale, g_zero, u_scale, u_zero,
                   block_expert, num_active, *, bits: int, group: int = 128,
                   bm: int = 16) -> torch.Tensor:
    """Fused gate/up grouped GEMM + SwiGLU epilogue."""
    if _grad.wants_grad(x_padded):
        return _grad.MoeGmmSwiglu.apply(x_padded, bits, group, bm, g_scale, g_zero, u_scale,
                                        u_zero, block_expert, num_active,
                                        *_qm.planes(wg_packed, bits), *_qm.planes(wu_packed, bits))
    return _gmm.moe_gmm_swiglu(x_padded.contiguous(), wg_packed, wu_packed, g_scale, g_zero,
                               u_scale, u_zero, block_expert, num_active, bits=bits,
                               group=group, bm=bm)


def binary_matmul(x: torch.Tensor, b_packed, alpha) -> torch.Tensor:
    """Eq. 9 ``(x @ (2·B~ − 1)) · alpha`` for any leading x shape."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    y = _bm.binary_matmul(x.reshape(-1, k).contiguous(), b_packed, alpha)
    return y.reshape(*lead, y.shape[-1])


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    window: Optional[int] = None, quant=None) -> torch.Tensor:
    """Decode attention through a paged KV pool (serving hot path);
    ``q [B, Hkv, G, dh]`` → ``[B, Hkv, G, dh]``. ``quant = (k_scale, k_zero,
    v_scale, v_zero)`` (each ``[NB, BS, Hkv]`` f32) reads uint8 pools through
    the int8 kernel's dequant epilogue."""
    if quant is not None:
        return _pa.paged_attention_quant(q.contiguous(), k_pool, v_pool, *quant, block_tables,
                                         lengths, window=window)
    return _pa.paged_attention(q.contiguous(), k_pool, v_pool, block_tables, lengths,
                               window=window)
