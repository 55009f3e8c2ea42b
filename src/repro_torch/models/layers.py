"""Shared layers of the port (``repro/models/layers.py`` in torch).

Weights are ``[K_in, N_out]`` (``y = x @ W``), so a :class:`PackedTensor`
leaf substitutes 1:1 and routes through ``ops.quant_matmul``. Activations
are ``[B, S, D]``, attention heads ``[B, S, H, dh]``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.packing import PackedTensor
from ..kernels import ops

__all__ = [
    "apply_rope",
    "attention",
    "embed_tokens",
    "linear",
    "mlp",
    "rms_norm",
]

NEG_INF = -1e30


def linear(p, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    if isinstance(w, PackedTensor):
        return ops.quant_matmul(x, w)
    return x @ w.to(x.dtype)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32; the normalize multiply stays in the activation
    dtype, with the ``1 + w`` gain."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps).to(x.dtype)
    return x * inv * (1.0 + w.to(x.dtype))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. ``x [B, S, H, dh]``, ``positions [S] or [B, S]``;
    angles in f32, the rotation multiply in the activation dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        ang = (positions[:, None].float() * freq[None, :])[None, :, None, :]
    else:
        ang = (positions[..., None].float() * freq)[:, :, None, :]
    sin = torch.sin(ang).to(x.dtype)
    cos = torch.cos(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _q_only(p, x, cfg, positions):
    b, s, _ = x.shape
    q = linear(p["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta)


def _qkv(p, x, cfg, positions):
    q = _q_only(p, x, cfg, positions)
    k, v = _kv_only(p, x, cfg, positions)
    return q, k, v


def _kv_only(p, x, cfg, positions):
    """K/V projection without the query — paged prefill writes K/V itself
    and lets :func:`attention`'s cross-attention path own q."""
    b, s, _ = x.shape
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    k = linear(p["wk"], x).reshape(b, s, hkv, dh)
    v = linear(p["wv"], x).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(k, positions, cfg.rope_theta), v


def _mask_chunk(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """[qc, kc] validity from absolute positions (kv_pos < 0 = padding)."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    return m


def _online_attn(q, k, v, q_pos, kv_pos, *, causal, window, kv_chunk):
    """One q chunk against kv chunks with an online softmax (f32).

    ``q [B, qc, Hkv, G, dh]``; ``k/v [B, Skv, Hkv, dh]``. Returns
    ``[B, qc, Hkv, G, dh]``.
    """
    b, qc, hkv, g, dh = q.shape
    q32 = q.float() * dh**-0.5
    m = torch.full((b, hkv, g, qc), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, qc), device=q.device)
    acc = torch.zeros((b, hkv, g, qc, dh), device=q.device)
    for c0 in range(0, k.shape[1], kv_chunk):
        kc = k[:, c0:c0 + kv_chunk].float()
        vc = v[:, c0:c0 + kv_chunk].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kc)
        mask = _mask_chunk(q_pos, kv_pos[c0:c0 + kv_chunk], causal, window)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4)


def _pad_rows(x: torch.Tensor, pad: int, dim: int, value=0) -> torch.Tensor:
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=dim)


def attention(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              kv_override: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
              causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Cross-attention of ``x``'s queries onto ``kv_override = (k, v,
    kv_pos)`` (``kv_pos < 0`` marks padding) — the paged-prefill path of
    the reference ``attention`` (``layers.py:245``), with the same q-chunk ×
    kv-chunk online-softmax sweep. Returns ``out [B, S, D]`` after ``wo``.
    """
    b, s, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    q = _q_only(p, x, cfg, positions)
    k, v, kv_pos = kv_override
    qc = min(cfg.attn_q_chunk, s)
    kvc = min(cfg.attn_kv_chunk, k.shape[1])
    q_pos = positions if positions.dim() == 1 else positions[0]
    s_pad = (-s) % qc
    q = _pad_rows(q, s_pad, 1)
    q_pos = _pad_rows(q_pos, s_pad, 0, value=-1)
    kv_pad = (-k.shape[1]) % kvc
    k = _pad_rows(k, kv_pad, 1)
    v = _pad_rows(v, kv_pad, 1)
    kv_pos = _pad_rows(kv_pos, kv_pad, 0, value=-1)
    sq = s + s_pad
    q5 = q.reshape(b, sq, hkv, g, dh)
    outs = [
        _online_attn(q5[:, i:i + qc], k, v, q_pos[i:i + qc], kv_pos, causal=causal,
                     window=window, kv_chunk=kvc).to(x.dtype)
        for i in range(0, sq, qc)
    ]
    out = torch.cat(outs, dim=1).reshape(b, sq, hq * dh)[:, :s]
    return linear(p["wo"], out)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    return linear(p["w_down"], F.silu(linear(p["w_gate"], x)) * linear(p["w_up"], x))
