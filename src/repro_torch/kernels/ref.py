"""Plain PyTorch versions of the port's kernels.

Each function repeats the reference oracle of the same name in
``repro/kernels/ref.py`` operation for operation: unpack, group-wise affine
dequant ``(q - zero) · scale`` in f32, and products in the compute type —
f32 when the activations are f32, else both operands rounded to bf16 and
accumulated in f32 (``_dot``). The kernel wrappers take these for tensors
on the CPU, and ``chip_smoke.py`` holds every kernel against them on the
card. They are the arithmetic specification, not a speed yardstick.
"""
from __future__ import annotations

import torch

from ..core.packing import unpack_bits

__all__ = [
    "dequant_ref",
    "moe_gmm_ref",
    "moe_gmm_swiglu_ref",
    "paged_attention_ref",
    "quant_matmul_ref",
]

NEG_INF = -1e30


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else torch.bfloat16


def _dot(a: torch.Tensor, b: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``cd`` and f32 accumulation
    (bf16 × bf16 products are exact in f32)."""
    return torch.matmul(a.to(cd).float(), b.to(cd).float())


def dequant_ref(w_packed, scale, zero, bits: int, k: int, group: int = 128,
                dtype=torch.float32) -> torch.Tensor:
    """Unpack + group-wise affine dequant to ``[..., K, N]`` (leading dims
    of the packed planes are kept, e.g. a stack of experts)."""
    codes = unpack_bits(w_packed, bits, axis=-2)[..., :k, :].float()
    n = codes.shape[-1]
    ng = (k + group - 1) // group
    if k % group:
        pad = codes.new_zeros(*codes.shape[:-2], ng * group - k, n)
        codes = torch.cat([codes, pad], dim=-2)
    cg = codes.reshape(*codes.shape[:-2], ng, group, n)
    w = (cg - zero.unsqueeze(-2)) * scale.unsqueeze(-2)
    return w.reshape(*codes.shape[:-2], ng * group, n)[..., :k, :].to(dtype)


def quant_matmul_ref(x, w_packed, scale, zero, *, bits: int, group: int = 128,
                     out_dtype=None) -> torch.Tensor:
    cd = compute_dtype(x)
    w = dequant_ref(w_packed, scale, zero, bits, x.shape[-1], group, dtype=cd)
    return _dot(x, w, cd).to(out_dtype or x.dtype)


def moe_gmm_ref(x_padded, w_packed, scale, zero, block_expert, num_active, *,
                bits: int, group: int = 128, bm: int = 128, out_dtype=None) -> torch.Tensor:
    """Row-block ``i`` of ``x_padded`` hits expert ``block_expert[i]``; blocks
    at index ≥ ``num_active`` are zero (computed, then masked — the kernel
    skips them)."""
    m, k = x_padded.shape
    ws = dequant_ref(w_packed, scale, zero, bits, k, group)  # [E, K, N]
    nblocks = m // bm
    xb = x_padded.reshape(nblocks, bm, k)
    wb = ws[block_expert.long()]  # [nblocks, K, N]
    y = _dot(xb, wb, compute_dtype(x_padded))
    live = torch.arange(nblocks, device=y.device) < num_active.reshape(())
    y = torch.where(live[:, None, None], y, 0.0)
    return y.reshape(m, -1).to(out_dtype or x_padded.dtype)


def moe_gmm_swiglu_ref(x_padded, wg_packed, wu_packed, g_scale, g_zero, u_scale, u_zero,
                       block_expert, num_active, *, bits: int, group: int = 128,
                       bm: int = 128, out_dtype=None) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu)`` per row-block's expert; inactive blocks
    are exactly zero."""
    kw = dict(bits=bits, group=group, bm=bm, out_dtype=torch.float32)
    g = moe_gmm_ref(x_padded, wg_packed, g_scale, g_zero, block_expert, num_active, **kw)
    u = moe_gmm_ref(x_padded, wu_packed, u_scale, u_zero, block_expert, num_active, **kw)
    return (torch.nn.functional.silu(g) * u).to(out_dtype or x_padded.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, *, window=None,
                        out_dtype=None) -> torch.Tensor:
    """Gather each sequence's pages through its block table, then masked
    softmax decode attention in f32 (fp pools).

    ``q [B, Hkv, G, dh]``; pools ``[NB, BS, Hkv, dh]``; ``block_tables
    [B, MB]``; ``lengths [B]`` (newest token at ``lengths - 1``); ``window``
    keeps ``kv_pos > (lengths - 1) - window`` (None = full attention).
    """
    b, hkv, g, dh = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    flat_k = k_pool.reshape(nb * bs, hkv, dh)
    flat_v = v_pool.reshape(nb * bs, hkv, dh)
    ar = torch.arange(bs, device=q.device)
    phys = (block_tables.long()[:, :, None] * bs + ar[None, None, :]).reshape(b, mb * bs)
    k = flat_k[phys].float()  # [B, S_log, Hkv, dh]
    v = flat_v[phys].float()
    kv_pos = torch.arange(mb * bs, device=q.device)
    lengths = lengths.long()
    valid = kv_pos[None, :] < lengths[:, None]
    if window is not None:
        valid &= kv_pos[None, :] > (lengths[:, None] - 1) - window
    s = torch.einsum("bhgd,bshd->bhgs", q.float() * dh**-0.5, k)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v)
    return o.to(out_dtype or q.dtype)
