"""``paged_attention`` and ``paged_attention_quant``: decode attention over a
paged KV pool — wrappers of the Hopper kernels in ``csrc/paged_attention.cu``
(ports of ``repro/kernels/paged_attention.py:225 paged_attention_pallas``
and ``:158 paged_attention_quant_pallas``).

``q [B, Hkv, G, dh]``; pools ``[NB, BS, Hkv, dh]`` (one layer) of q's dtype,
or uint8 codes with per-row f32 ``k_scale, k_zero, v_scale, v_zero``
``[NB, BS, Hkv]``; ``block_tables [B, MB]`` int32; ``lengths [B]`` int32
(newest token at ``lengths - 1``); ``window`` an int (None = full
attention). A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .build import DTYPE_CODES, LAUNCHES, check, load_library, stream_ptr
from .quant_matmul import require, ptr

__all__ = ["paged_attention", "paged_attention_quant"]

MAX_G = 8
MAX_HEAD_DIM = 256


def _check(name, q, k_pool, v_pool, block_tables, lengths, pool_dtype):
    b, hkv, g, dh = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    require(q.dtype in DTYPE_CODES, f"{name}: q must be float32 or bfloat16")
    require(g <= MAX_G and dh <= MAX_HEAD_DIM,
            f"{name}: needs G <= {MAX_G} and head_dim <= {MAX_HEAD_DIM}")
    for t in (k_pool, v_pool):
        require(tuple(t.shape) == (nb, bs, hkv, dh) and t.dtype == pool_dtype,
                f"{name}: pool {tuple(t.shape)} {t.dtype} does not match q")
    require(block_tables.dtype == torch.int32 and tuple(block_tables.shape) == (b, mb),
            f"{name}: block_tables must be int32 [B, MB]")
    require(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,),
            f"{name}: lengths must be int32 [B]")
    for t in (q, k_pool, v_pool, block_tables, lengths):
        require(t.device == q.device and t.is_contiguous(),
                f"{name}: operands must be contiguous on one device")
    return b, hkv, g, dh, bs, mb


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, window=window)
    require(q.device.type == "cuda", f"paged_attention: unsupported device {q.device}")
    b, hkv, g, dh, bs, mb = _check("paged_attention", q, k_pool, v_pool, block_tables,
                                   lengths, q.dtype)
    win = mb * bs + 1 if window is None else int(window)
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = load_library().repro_paged_attention(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(block_tables), ptr(lengths), ptr(out), b, hkv,
        g, dh, bs, mb, win, float(dh ** -0.5), DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_attention_quant(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                          k_scale: torch.Tensor, k_zero: torch.Tensor, v_scale: torch.Tensor,
                          v_zero: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """The same attention over uint8 pools, each staged row dequantized as
    ``(code − zero) · scale`` in f32 before the fp math."""
    quant = (k_scale, k_zero, v_scale, v_zero)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, window=window,
                                       quant=quant)
    name = "paged_attention_quant"
    require(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    b, hkv, g, dh, bs, mb = _check(name, q, k_pool, v_pool, block_tables, lengths,
                                   torch.uint8)
    for t in quant:
        require(tuple(t.shape) == tuple(k_pool.shape[:3]) and t.dtype == torch.float32,
                f"{name}: scale/zero tables must be float32 [NB, BS, Hkv]")
        require(t.device == q.device and t.is_contiguous(),
                f"{name}: operands must be contiguous on one device")
    win = mb * bs + 1 if window is None else int(window)
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = load_library().repro_paged_attention_quant(
        ptr(q), ptr(k_pool), ptr(v_pool), *(ptr(t) for t in quant), ptr(block_tables),
        ptr(lengths), ptr(out), b, hkv, g, dh, bs, mb, win, float(dh ** -0.5),
        DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(rc, name)
    LAUNCHES[name] += 1
    return out
