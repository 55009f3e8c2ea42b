"""``paged_attention``: decode attention over a paged fp KV pool — wrapper of
the Hopper kernel in ``csrc/paged_attention.cu`` (port of
``repro/kernels/paged_attention.py:225 paged_attention_pallas``).

``q [B, Hkv, G, dh]``; pools ``[NB, BS, Hkv, dh]`` (one layer); ``block_tables
[B, MB]`` int32; ``lengths [B]`` int32 (newest token at ``lengths - 1``);
``window`` an int (None = full attention). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .build import DTYPE_CODES, LAUNCHES, check, load_library, stream_ptr
from .quant_matmul import require, ptr

__all__ = ["paged_attention"]

MAX_G = 8
MAX_HEAD_DIM = 256


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, window=window)
    require(q.device.type == "cuda", f"paged_attention: unsupported device {q.device}")
    b, hkv, g, dh = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    require(q.dtype in DTYPE_CODES, "paged_attention: q must be float32 or bfloat16")
    require(g <= MAX_G and dh <= MAX_HEAD_DIM,
            f"paged_attention: needs G <= {MAX_G} and head_dim <= {MAX_HEAD_DIM}")
    for t in (k_pool, v_pool):
        require(tuple(t.shape) == (nb, bs, hkv, dh) and t.dtype == q.dtype,
                f"paged_attention: pool {tuple(t.shape)} {t.dtype} does not match q")
    require(block_tables.dtype == torch.int32 and tuple(block_tables.shape) == (b, mb),
            "paged_attention: block_tables must be int32 [B, MB]")
    require(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,),
            "paged_attention: lengths must be int32 [B]")
    for t in (q, k_pool, v_pool, block_tables, lengths):
        require(t.device == q.device and t.is_contiguous(),
                "paged_attention: operands must be contiguous on one device")
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
