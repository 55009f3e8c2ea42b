"""What a recompute-mode resume rewrites, shared by the CPU test
(``tests/test_torch_preemption.py``) and the card test
(``tests/test_torch_kernels_cuda.py``). Imports torch and the port only.

:func:`reprefilled_rows`: a prompt prefilled in 16-token chunks, ``h``
tokens decoded by one megastep over ``slots`` slots (the request in slot 0,
the others idle), then the context ``prompt + out[:-1]`` re-prefilled into
other pages as the engine's resume does (``decode_from`` = the prompt's
length). :func:`op_deltas` takes the first layer's decode-era rows through
each op of the layer at the decode's shape and at the chunk's, on the same
inputs, and reports how far apart each op's outputs are.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import (_ffn_delta, layer_windows_static,
                                            paged_decode_horizon, paged_prefill_chunk)
from repro_torch.serving.kvcache import PagedKVCache

BS = 16


def _prefill(params, cfg, cache, slot, seq, decode_from=None, decode_batch=1):
    table = cache.tables_device()[slot:slot + 1]
    dev = seq.device
    for off in range(0, len(seq), BS):
        n = min(BS, len(seq) - off)
        chunk = torch.zeros((1, BS), dtype=torch.long, device=dev)
        chunk[0, :n] = seq[off:off + n]
        logits, _ = paged_prefill_chunk(params, cache.k, cache.v, table, chunk, off, n, cfg,
                                        block_size=BS, decode_from=decode_from,
                                        decode_batch=decode_batch)
    return logits


def _rows(cache, slot, n):
    pos = torch.arange(n)
    blocks = torch.as_tensor(cache.slot_blocks[slot])
    idx = (blocks[pos // BS] * BS + pos % BS).to(cache.k.device)
    return cache.k[:, idx], cache.v[:, idx]


def reprefilled_rows(params, cfg, dev, *, p_len: int = 64, h: int = 16, slots: int = 1,
                     seed: int = 2):
    """``(decoded, again, context)``: the request's K and V rows ``[L, p_len
    + h, Hkv, dh]`` as the prefill and the decode wrote them, the same rows
    as the resume rewrote them, and the resumed context ``[p_len + h]``."""
    blocks = -(-(p_len + h) // BS)
    cache = PagedKVCache(cfg, num_blocks=blocks * (slots + 1), block_size=BS,
                         max_slots=slots + 1, max_blocks_per_slot=blocks, device=dev)
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (p_len,), generator=gen).to(dev)
    slot = cache.acquire_slot(p_len + h)
    for _ in range(slots - 1):
        cache.acquire_slot(BS)
    first = _prefill(params, cfg, cache, slot, prompt)[0, -1].argmax()
    i32 = dict(dtype=torch.int32, device=dev)
    token = torch.zeros((slots, 1), dtype=torch.long, device=dev)
    token[0, 0] = first
    active = torch.zeros(slots, dtype=torch.bool, device=dev)
    active[0] = True
    toks, _, _, _ = paged_decode_horizon(
        params, cache.k, cache.v, cache.tables_device()[:slots], token,
        torch.tensor([p_len] + [0] * (slots - 1), **i32), active, cfg, block_size=BS,
        horizon=h, budgets=torch.tensor([h + 1] + [0] * (slots - 1), **i32),
        eos_ids=torch.full((slots,), -1, **i32))
    decoded = _rows(cache, slot, p_len + h)
    context = torch.cat([prompt, first.reshape(1), toks[:h - 1, 0].long()])
    again_slot = cache.acquire_slot(p_len + h)
    _prefill(params, cfg, cache, again_slot, context, decode_from=p_len, decode_batch=slots)
    return decoded, _rows(cache, again_slot, p_len + h), context


def _delta(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def op_deltas(params, cfg, dev, decoded, context, *, p_len: int = 64,
              slots: int = 1) -> Dict[str, float]:
    """The first layer's ops on the decode-era rows at the decode's shape
    (``slots`` rows a call) and at the chunk's (16 rows), from the same
    inputs: ``{op: max|Δ|}`` — the projections, the attention (the decode
    kernel against the prefill's sweep), ``wo``, the router, the whole FFN
    block — and ``dropped``, the decode-era (token, choice) pairs the
    chunk's capacity dispatch drops (the decode's ``slots`` tokens never
    fill a capacity of 8)."""
    p = params["layers"][0]
    a = p["attn"]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tok = context[p_len:p_len + BS]
    pos = torch.arange(p_len, p_len + BS, device=dev)
    x = L.embed_tokens(params["embed"], tok[None])
    hn = L.rms_norm(x, p["ln1"], cfg.norm_eps)

    def by_rows(fn, t):  # the decode's shape: ``[slots, 1, ...]`` a call, row 0 kept
        return torch.cat([fn(t[0, i][None, None].expand(slots, 1, *t.shape[2:]).contiguous(),
                             i)[:1] for i in range(t.shape[1])], dim=1)

    out: Dict[str, float] = {}
    q_chunk, k_chunk, v_chunk = L._qkv(a, hn, cfg, pos[None])
    q_rows = by_rows(lambda t, i: L._qkv(a, t, cfg, pos[i:i + 1].expand(slots)[:, None])[0], hn)
    out["q"] = _delta(q_chunk, q_rows)
    out["k"] = _delta(k_chunk, by_rows(
        lambda t, i: L._qkv(a, t, cfg, pos[i:i + 1].expand(slots)[:, None])[1], hn))
    k_all, v_all = decoded[0][0, :p_len + BS], decoded[1][0, :p_len + BS]
    kv_pos = torch.arange(p_len + BS, device=dev)
    nb = (p_len + BS + BS - 1) // BS
    win = int(layer_windows_static(cfg, nb * BS)[0])
    sweep = L.attend(q_chunk, k_all[None], v_all[None], pos, kv_pos, cfg, causal=True,
                     window=win, dtype=hn.dtype)
    kp = k_all.reshape(nb, BS, hkv, dh)
    vp = v_all.reshape(nb, BS, hkv, dh)
    table = torch.arange(nb, dtype=torch.int32, device=dev)[None].expand(BS, -1).contiguous()
    kern = ops.paged_attention(q_chunk[0].reshape(BS, hkv, hq // hkv, dh), kp, vp, table,
                               (pos + 1).to(torch.int32), window=win)
    kern = kern.reshape(1, BS, hq * dh).to(hn.dtype)
    out["attention"] = _delta(sweep, kern)
    wo_chunk = L.linear(a["wo"], kern)
    out["wo"] = _delta(wo_chunk, by_rows(lambda t, i: L.linear(a["wo"], t), kern))
    x2 = x + wo_chunk
    h2 = L.rms_norm(x2, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        router = p["moe"]["router"]
        out["router"] = _delta(L.linear(router, h2[0].float()),
                               by_rows(lambda t, i: L.linear(router, t[:, 0].float())[:, None],
                                       h2)[0])
        out["dropped"] = float(dropped(p, h2[0], cfg))
    ffn = _ffn_delta(p, h2, cfg)[0]
    out["ffn"] = _delta(ffn, by_rows(lambda t, i: _ffn_delta(p, t, cfg)[0], h2))
    return out


def dropped(p, x2: torch.Tensor, cfg) -> int:
    """The (token, choice) pairs of ``x2 [T, D]`` that one capacity dispatch
    of the layer ``p`` drops (the OTP mask first, as the layer applies it)."""
    from repro_torch.core import otp as otp_mod

    _, idx, gates = moe_mod.route_topk(p["moe"]["router"], x2.float(), cfg.top_k)
    mask = otp_mod.otp_mask(p["otp"], x2, idx, gates) if "otp" in p else None
    ids, n = (p["moe_ce"].slot_of_expert[idx], p["moe_ce"].num_slots) if "moe_ce" in p else \
        (idx, cfg.num_experts)
    cap = moe_mod.dispatch_capacity(cfg, x2.shape[0])
    _, _, valid, _ = moe_mod.capacity_dispatch(x2, ids, gates, n, cap, mask)
    live = torch.ones_like(valid) if mask is None else mask.reshape(-1) > 0
    return int((live & ~valid).sum())


def compare(decoded, again, p_len: int) -> Tuple[list, list]:
    """Per layer, the largest difference of the decode-era rows and the
    largest |row| (K and V together)."""
    deltas, scales = [], []
    for a, b in zip(decoded, again):
        da = (a[:, p_len:].float() - b[:, p_len:].float()).abs().amax(dim=(1, 2, 3))
        deltas.append(da)
        scales.append(a[:, p_len:].float().abs().amax(dim=(1, 2, 3)))
    return (torch.stack(deltas).amax(0).tolist(), torch.stack(scales).amax(0).tolist())
