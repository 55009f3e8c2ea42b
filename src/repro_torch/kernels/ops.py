"""Public wrappers the model calls (port of ``repro/kernels/ops.py``).

They flatten leading dims, take a :class:`PackedTensor`, check block
shapes, and hand the tensors to the kernel wrappers, which route by
device: a CUDA tensor launches the Hopper kernel (or raises), a CPU tensor
runs the plain version. Models never call a kernel directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.packing import PackedTensor
from . import moe_gmm as _gmm
from . import paged_attention as _pa
from . import quant_matmul as _qm

__all__ = [
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
    y = _qm.quant_matmul(x.reshape(-1, k).contiguous(), w_packed, scale, zero, bits=bits,
                         group=group)
    return y.reshape(*lead, y.shape[-1])


def _gmm_blocks(k: int, group: int) -> None:
    """The kernels tile K one quantization group at a time (the port's
    counterpart of the Pallas ``bk``): K must hold whole groups."""
    if k % group:
        raise ValueError(f"grouped GEMM needs K={k} to be a multiple of group={group}")


def moe_gmm(x_padded, w_packed, scale, zero, block_expert, num_active, *, bits: int,
            group: int = 128, bm: int = 16) -> torch.Tensor:
    """Grouped expert GEMM with the ragged skip of row blocks at or past
    ``num_active[0]`` (the routed-token frontier)."""
    _gmm_blocks(x_padded.shape[-1], group)
    return _gmm.moe_gmm(x_padded.contiguous(), w_packed, scale, zero, block_expert,
                        num_active, bits=bits, group=group, bm=bm)


def moe_gmm_swiglu(x_padded, wg_packed, wu_packed, g_scale, g_zero, u_scale, u_zero,
                   block_expert, num_active, *, bits: int, group: int = 128,
                   bm: int = 16) -> torch.Tensor:
    """Fused gate/up grouped GEMM + SwiGLU epilogue."""
    _gmm_blocks(x_padded.shape[-1], group)
    return _gmm.moe_gmm_swiglu(x_padded.contiguous(), wg_packed, wu_packed, g_scale, g_zero,
                               u_scale, u_zero, block_expert, num_active, bits=bits,
                               group=group, bm=bm)


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode attention through a paged KV pool (serving hot path);
    ``q [B, Hkv, G, dh]`` → ``[B, Hkv, G, dh]``."""
    return _pa.paged_attention(q.contiguous(), k_pool, v_pool, block_tables, lengths,
                               window=window)
