"""Paged decode and chunked prefill of the PMQ + OTP MoE decoder (port of the
paged half of ``repro/models/transformer.py``).

``jax.lax.scan`` over stacked layers becomes a Python loop over
``params["layers"]`` (one dict per layer); the jitted programs with donated
pools become eager functions that write the preallocated pools in place.
Pools are ``[L, NB·BS + 1, Hkv, dh]``: the extra row per layer is a scratch
destination for the KV writes of inactive slots and right-padded prefill
positions (the reference scatters those out of range with ``mode="drop"``;
torch would raise), and ``pool[l, :NB·BS]`` is the layer's paged view.

Params: ``{"embed": [V, D], "final_norm": [D], "unembed"?: [V, D],
"layers": [{"ln1", "attn": {"wq"|"wk"|"wv"|"wo": {"w"}}, "ln2", "moe":
{"router": {"w"}, "shared": {...}}, "moe_ce": CompressedExperts, "otp"?:
{"fc1", "fc2"}}, ...]}`` — attention and shared-expert ``w`` may be
:class:`PackedTensor` leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compressed_moe import compressed_moe_layer
from ..kernels import ops
from . import layers as L

__all__ = [
    "layer_windows_static",
    "paged_decode_horizon",
    "paged_prefill_chunk",
]


def layer_windows_static(cfg, s: int) -> np.ndarray:
    """Per-layer effective attention window (host ints)."""
    idx = np.arange(cfg.num_layers)
    if cfg.local_global_ratio > 0 and cfg.local_window > 0:
        is_global = (idx % (cfg.local_global_ratio + 1)) == cfg.local_global_ratio
        return np.where(is_global, s + 1, cfg.local_window).astype(np.int32)
    if cfg.local_window > 0:
        return np.full((cfg.num_layers,), cfg.local_window, np.int32)
    return np.full((cfg.num_layers,), s + 1, np.int32)


def _out_embedding(params):
    return params.get("unembed", params["embed"])


def _logits(params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), _out_embedding(params).float().t())


def _ffn_delta(p, h, cfg, *, use_otp: bool, count_weight=None):
    """FFN half of a block: ``(Δx, expert_activation [B, S], slot_counts)``.

    ``expert_activation`` is the per-token executed fraction of the top-k
    slots — the mean of the OTP mask when OTP runs, else 1.
    """
    if "moe_ce" not in p:
        raise ValueError("the port serves PMQ-compressed MoE layers ('moe_ce') only")
    otp = p.get("otp") if use_otp else None
    y, info = compressed_moe_layer(p["moe"], p["moe_ce"], h, cfg, otp_params=otp,
                                   count_weight=count_weight)
    act = torch.ones(h.shape[:2], device=h.device)
    if info["mask"] is not None:
        act = info["mask"].mean(dim=-1).reshape(h.shape[:2])
    return y, act, info["slot_counts"]


def _paged_decode_core(params, kf, vf, tables, token, positions, active, cfg, nb: int,
                       bs: int, *, use_otp: bool):
    """One decode step over the flattened pools ``kf``/``vf`` ``[L, NB·BS+1,
    Hkv, dh]`` (written in place). ``tables [B, MB]`` int32, ``token [B, 1]``,
    ``positions [B]``, ``active [B]`` bool. Returns ``(logits [B, 1, V],
    per_slot_act [B], slot_counts [L, num_slots])``."""
    x = L.embed_tokens(params["embed"], token)
    b = token.shape[0]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    mb = tables.shape[1]
    windows = layer_windows_static(cfg, mb * bs)
    page_idx = torch.clamp_max(torch.div(positions, bs, rounding_mode="floor"), mb - 1)
    page = torch.gather(tables.long(), 1, page_idx[:, None].long())[:, 0]
    dest = torch.where(active, page * bs + positions % bs, nb * bs)  # inactive → scratch
    lengths = (positions + 1).to(torch.int32)
    acts, counts = [], []
    for l, p_l in enumerate(params["layers"]):
        h = L.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        q, k_new, v_new = L._qkv(p_l["attn"], h, cfg, positions[:, None])
        kf[l].index_copy_(0, dest, k_new[:, 0].to(kf.dtype))
        vf[l].index_copy_(0, dest, v_new[:, 0].to(vf.dtype))
        attn = ops.paged_attention(
            q.reshape(b, hkv, g, dh),
            kf[l, : nb * bs].view(nb, bs, hkv, dh),
            vf[l, : nb * bs].view(nb, bs, hkv, dh),
            tables, lengths, window=int(windows[l]),
        )
        x = x + L.linear(p_l["attn"]["wo"], attn.reshape(b, 1, hq * dh).to(x.dtype))
        h2 = L.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        delta, act, cnt = _ffn_delta(p_l, h2, cfg, use_otp=use_otp, count_weight=active)
        x = x + delta
        acts.append(act)
        counts.append(cnt)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    per_slot = torch.stack(acts).mean(dim=(0, 2))  # [B]
    return _logits(params, x), per_slot, torch.stack(counts)


def _masked_activation(per_slot, active):
    w = active.float()
    return torch.sum(per_slot * w) / torch.clamp_min(w.sum(), 1.0)


def paged_decode_horizon(params, kf, vf, tables, token, positions, active, cfg, *,
                         block_size: int, horizon: int, budgets, eos_ids,
                         use_otp: bool = True):
    """``H`` greedy decode steps, each exactly :func:`_paged_decode_core`,
    with on-device argmax feeding the next step and per-slot stop logic in
    the carried ``active`` mask (budget spent, EOS emitted). Nothing syncs
    with the host inside the horizon.

    Returns ``(tokens [H, B] (-1 where not emitted), emits [H, B],
    expert_activation [H], slot_counts [H, L, num_slots])``.
    """
    if horizon < 1:
        raise ValueError(f"horizon must be ≥ 1, got {horizon}")
    bs = block_size
    nb = (kf.shape[1] - 1) // bs
    cur, pos, act, budget = token, positions, active, budgets
    toks, emits, acts, counts = [], [], [], []
    for _ in range(horizon):
        logits, per_slot, cnt = _paged_decode_core(
            params, kf, vf, tables, cur, pos, act, cfg, nb, bs, use_otp=use_otp
        )
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        emit = act
        budget = budget - emit.to(torch.int32)
        stop = (budget <= 0) | ((eos_ids >= 0) & (nxt == eos_ids))
        toks.append(torch.where(emit, nxt, -1))
        emits.append(emit)
        acts.append(_masked_activation(per_slot, act))
        counts.append(cnt)
        cur, pos, act = nxt[:, None], pos + emit.to(pos.dtype), act & ~stop
    return torch.stack(toks), torch.stack(emits), torch.stack(acts), torch.stack(counts)


def paged_prefill_chunk(params, kf, vf, table_row, tokens, start: int, valid_len: int,
                        cfg, *, block_size: int, use_otp: bool = True):
    """Chunked prefill of ONE request into its pages.

    ``tokens [1, C]`` is one fixed-size chunk (the tail right-padded);
    ``start`` counts tokens already written and ``valid_len ≤ C`` is the
    chunk's real length (host ints). Padded positions write the scratch
    row and never enter the gathered kv. ``table_row [1, MB]``. Returns
    ``(logits [1, 1, V] of the last valid token, slot_counts [L, num_slots])``.
    """
    bs = block_size
    x = L.embed_tokens(params["embed"], tokens)
    c = tokens.shape[1]
    nb = (kf.shape[1] - 1) // bs
    dev = tokens.device
    mb = table_row.shape[1]
    s_log = mb * bs
    windows = layer_windows_static(cfg, s_log)
    row = table_row[0].long()
    posf = start + torch.arange(c, device=dev)
    pos2d = posf[None, :]
    page = row[torch.clamp_max(torch.div(posf, bs, rounding_mode="floor"), mb - 1)]
    chunk = torch.arange(c, device=dev)
    dest = torch.where(chunk < valid_len, page * bs + posf % bs, nb * bs)
    logical = torch.arange(s_log, device=dev)
    kv_pos = torch.where(logical < start + valid_len, logical, -1)
    phys = row[torch.div(logical, bs, rounding_mode="floor")] * bs + logical % bs
    count_weight = chunk < valid_len
    counts = []
    for l, p_l in enumerate(params["layers"]):
        h = L.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        k_new, v_new = L._kv_only(p_l["attn"], h, cfg, pos2d)
        kf[l].index_copy_(0, dest, k_new[0].to(kf.dtype))
        vf[l].index_copy_(0, dest, v_new[0].to(vf.dtype))
        x = x + L.attention(
            p_l["attn"], h, cfg, positions=pos2d, causal=True, window=int(windows[l]),
            kv_override=(kf[l][phys][None], vf[l][phys][None], kv_pos),
        )
        h2 = L.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        delta, _, cnt = _ffn_delta(p_l, h2, cfg, use_otp=use_otp, count_weight=count_weight)
        x = x + delta
        counts.append(cnt)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x[:, valid_len - 1:valid_len]), torch.stack(counts)
