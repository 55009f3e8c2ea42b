"""The decoder-only LM of the dense, MoE and VLM-backbone families (port of
``repro/models/transformer.py``): the dense-cache prefill and decode step,
and the paged decode and chunked prefill the serving engine runs. A ``vlm``
model's dense-cache prefill takes ``batch["patch_embeds"] [B, P, D]`` ahead
of the prompt's embeddings, as the reference's anyres patch stub does; the
paged path serves tokens alone, as the reference's engine does.

``jax.lax.scan`` over stacked layers becomes a Python loop over
``params["layers"]`` (one dict per layer); the jitted programs with donated
pools become eager functions that write the preallocated pools in place.
Pools are ``[L, NB·BS + 1, Hkv, dh]``: the extra row per layer is a scratch
destination for the KV writes of inactive slots and right-padded prefill
positions (the reference scatters those out of range with ``mode="drop"``;
torch would raise), and ``pool[l, :NB·BS]`` is the layer's paged view.
int8 pools (``kv_bits=8``) are uint8 codes with four per-row f32 tables
``qs = (k_scale, k_zero, v_scale, v_zero)``, each ``[L, NB·BS + 1, Hkv]``
with the same scratch row; ``qs = ()`` means fp pools.

Params: ``{"embed": [V, D], "final_norm": [D], "unembed"?: [V, D],
"layers": [{"ln1", "attn": {"wq"|"wk"|"wv"|"wo": {"w"}, "q_norm"?,
"k_norm"?}, "ln2", <ffn>}, ...]}`` where ``<ffn>`` is one of
``"mlp": {"w_gate"|"w_up"|"w_down": {"w"}}`` (dense family), ``"moe":
{"router": {"w"}, "experts": {"w_gate", "w_up", "w_down"} [E, ·, ·],
"shared"?: {...}}`` (uncompressed MoE) or ``"moe": {"router", "shared"?},
"moe_ce": CompressedExperts, "otp"?: {"fc1", "fc2"}`` (PMQ + OTP) —
attention, MLP and shared-expert ``w`` may be :class:`PackedTensor` leaves.
The dense cache is ``{"k": [L, B, S, Hkv, dh], "v": ..., "pos"}``.

Training: :func:`init_lm` draws a model from a ``torch.Generator`` (on the
generator's device) and :func:`train_loss` is the reference's streaming
cross-entropy plus the MoE load-balance term (``aux_weight``). The PMQ
layers' ``ffn_backend`` (``compressed_moe.FFN_BACKENDS``) is threaded
through every path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.compressed_moe import compressed_moe_layer
from ..core.otp import fixed_uniforms
from ..core.quantizers import dequantize_kv_rows, quantize_kv_rows
from ..kernels import ops
from . import layers as L
from .moe import dispatch_capacity, init_moe, moe_layer

__all__ = [
    "KV_QUANT_BITS",
    "decode_step",
    "extend_cache",
    "forward_hidden",
    "hidden",
    "init_lm",
    "layer_windows_static",
    "paged_decode_horizon",
    "paged_prefill_chunk",
    "prefill",
    "sample_gumbel",
    "train_loss",
]


KV_QUANT_BITS = 8


def _write_kv(kf, vf, qs, l: int, dest, k_rows, v_rows):
    """Write the new K/V rows ``[n, Hkv, dh]`` of layer ``l`` to the flat
    rows ``dest`` — as they are on fp pools, or quantized per row (codes
    plus their four table entries) on int8 pools."""
    if not qs:
        kf[l].index_copy_(0, dest, k_rows.to(kf.dtype))
        vf[l].index_copy_(0, dest, v_rows.to(vf.dtype))
        return
    kc, ks, kz = quantize_kv_rows(k_rows, KV_QUANT_BITS)
    vc, vs, vz = quantize_kv_rows(v_rows, KV_QUANT_BITS)
    kf[l].index_copy_(0, dest, kc)
    vf[l].index_copy_(0, dest, vc)
    for table, rows in zip(qs, (ks, kz, vs, vz)):
        table[l].index_copy_(0, dest, rows)


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


def _logits(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits ``[..., V]`` in f32 (the whole vocabulary under a mesh too:
    :func:`~repro_torch.models.layers.logits`)."""
    return L.logits(x, _out_embedding(params), cfg.vocab_size)


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ------------------------------------------------------------------- init
def init_lm(gen: torch.Generator, cfg):
    """A model of ``cfg`` in the port's layout, every tensor drawn from
    ``gen`` on its device in ``cfg.dtype`` (the reference's ``init_lm``
    shapes and scales: attention and MLP ``N(0, 1/K)``, embeddings ``N(0,
    0.02²)``, norms zero; its draws are jax's and are not reproduced)."""
    dt, dev, d = _dtype(cfg), gen.device, cfg.d_model
    embed = torch.randn(cfg.vocab_size, d, generator=gen, device=dev, dtype=dt) * 0.02
    layers = []
    for _ in range(cfg.num_layers):
        p = {"ln1": torch.zeros(d, dtype=dt, device=dev),
             "attn": L.init_attention(gen, cfg, dt),
             "ln2": torch.zeros(d, dtype=dt, device=dev)}
        if cfg.is_moe:
            p["moe"] = init_moe(gen, cfg, dt)
        else:
            p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dt)
        layers.append(p)
    params = {"embed": embed, "layers": layers,
              "final_norm": torch.zeros(d, dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = torch.randn(cfg.vocab_size, d, generator=gen, device=dev,
                                        dtype=dt) * 0.02
    return params


def _ffn_delta(p, h, cfg, *, use_otp: bool = True, count_weight=None, ffn_backend=None,
               otp_rng=None, otp_tau: float = 1.0, rows=None, capacity=None):
    """FFN half of a block: ``(Δx, expert_activation [B, S], slot_counts,
    aux)``, for the dense ``mlp``, the PMQ-compressed MoE or the
    uncompressed :func:`moe_layer`; shared by the dense-cache and paged
    paths.

    ``expert_activation`` is the per-token executed fraction of the top-k
    slots — the mean of the OTP mask when OTP runs, else 1.
    ``slot_counts`` is the compressed layer's per-slot dispatch count, and
    empty (``[0]``) on the other two branches. ``aux`` is the MoE
    load-balance loss (uncompressed MoE), the Gumbel mask's mean (PMQ +
    OTP training, Eq. 14's ℓ1 term) or 0. ``otp_rng`` (uniforms ``[T, k]``
    or a generator) samples the OTP mask by Gumbel-Softmax at ``otp_tau``,
    the reference's ``moe_hooks``. ``rows`` (``[B, S]`` bool) dispatches only
    those tokens to the routed experts (:func:`compressed_moe_layer`), at
    ``capacity`` rows a slot where given.
    """
    ones = torch.ones(h.shape[:2], device=h.device)
    no_counts = torch.zeros(0, dtype=torch.long, device=h.device)
    zero = torch.zeros((), device=h.device)
    if not cfg.is_moe:
        return L.mlp(p["mlp"], h, cfg.d_ff), ones, no_counts, zero
    if "moe_ce" in p:
        otp = p.get("otp") if use_otp else None
        y, info = compressed_moe_layer(p["moe"], p["moe_ce"], h, cfg, otp_params=otp,
                                       otp_rng=otp_rng, otp_tau=otp_tau,
                                       count_weight=count_weight, ffn_backend=ffn_backend,
                                       rows=rows, capacity=capacity)
        act = ones
        if info["mask"] is not None:
            act = info["mask"].mean(dim=-1).reshape(h.shape[:2])
        aux = info["mask_l1"] if info["mask_l1"] is not None else zero
        return y, act, info["slot_counts"], aux
    def keep(x2, idx, gates):
        return rows.reshape(-1, 1).to(gates.dtype).expand_as(gates)

    out = moe_layer(p["moe"], h, cfg, gate_mask_fn=keep if rows is not None else None,
                    capacity=capacity)
    return out.y, ones, no_counts, out.aux_loss


# ------------------------------------------------------- dense-cache path
def _attn_half(p, x, cfg, positions, window: int):
    """The attention half of a block over a whole sequence: ``(x after the
    attention, (k, v))``."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, kv = L.attention(p["attn"], h, cfg, positions=positions, causal=True,
                               window=window)
    return x + attn_out, kv


def _ffn_half(p, x, cfg, ffn_backend=None, **hooks):
    """The FFN half of a block: ``(x after the FFN, aux)`` (``hooks``:
    :func:`_ffn_delta`'s OTP options)."""
    delta, _, _, aux = _ffn_delta(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                                  ffn_backend=ffn_backend, **hooks)
    return x + delta, aux


def _block(p, x, cfg, *, positions, window: int, ffn_backend=None, **hooks):
    """One transformer block over a whole sequence: ``(x, aux, (k, v))``
    with ``aux`` :func:`_ffn_delta`'s (``hooks``: its OTP options), under
    ``cfg.remat``. With ``"block"`` the block is recomputed in the backward
    (:func:`~repro_torch.models.layers.remat_block`); a PMQ layer's in two
    pieces, the attention half and the FFN half, so that the MoE region's
    output is saved across the attention's recomputation (the reference's
    ``moe_out``) and the region reruns only for its own backward, on the
    Gumbel draws of its first run (:func:`~repro_torch.core.otp.fixed_uniforms`)."""
    if "moe_ce" not in p:
        def whole(p, x):
            x, kv = _attn_half(p, x, cfg, positions, window)
            return (*_ffn_half(p, x, cfg, ffn_backend, **hooks), kv)

        return L.remat_block(cfg, whole, p, x)
    x, kv = L.remat_block(cfg, _attn_half, p, x, cfg, positions, window)
    if hooks.get("use_otp", True) and p.get("otp") is not None:
        hooks = dict(hooks, otp_rng=fixed_uniforms(hooks.get("otp_rng"), x.shape[0] * x.shape[1],
                                                   cfg.top_k, x.device))
    x, aux = L.remat_block(cfg, lambda p, x, hooks: _ffn_half(p, x, cfg, ffn_backend, **hooks),
                           p, x, hooks)
    return x, aux, kv


def _embed_inputs(params, cfg, tokens, patch_embeds=None):
    """Token embeddings ``[B, S, D]``; a ``vlm`` model's ``patch_embeds
    [B, P, D]`` go ahead of them (``[B, P + S, D]``)."""
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    if cfg.family == "vlm" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def forward_hidden(params, tokens: torch.Tensor, cfg, *,
                   patch_embeds: Optional[torch.Tensor] = None, collect_cache: bool = False,
                   ffn_backend: Optional[str] = None, use_otp: bool = True, otp_rng=None,
                   otp_tau: float = 1.0):
    """Run all blocks over ``tokens [B, S]`` (after ``patch_embeds [B, P,
    D]`` for a ``vlm`` model): ``(hidden [B, P + S, D], aux, cache | None)``
    with ``aux`` the layers' summed aux terms (f32) and the cache ``{"k",
    "v"}`` ``[L, B, P + S, Hkv, dh]``. ``use_otp``, ``otp_rng`` and
    ``otp_tau`` are the reference's ``moe_hooks`` for the compressed layers
    (every layer samples its mask from the same ``otp_rng``)."""
    x = _embed_inputs(params, cfg, tokens, patch_embeds)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    windows = layer_windows_static(cfg, s)
    ks, vs = [], []
    aux = torch.zeros((), device=x.device)
    for p_l, win in zip(params["layers"], windows):
        x, a, (k, v) = _block(p_l, x, cfg, positions=positions, window=int(win),
                              ffn_backend=ffn_backend, use_otp=use_otp, otp_rng=otp_rng,
                              otp_tau=otp_tau)
        aux = aux + a
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux, ({"k": torch.stack(ks), "v": torch.stack(vs)} if collect_cache else None)


def hidden(params, batch, cfg, **_):
    """The states ``[B, S, D]`` after the final norm at ``batch["tokens"]``'s
    positions (a ``vlm`` batch's ``patch_embeds`` run ahead of them and are
    dropped)."""
    patch = batch.get("patch_embeds")
    h, _, _ = forward_hidden(params, batch["tokens"], cfg, patch_embeds=patch)
    return h if patch is None else h[:, patch.shape[1]:]


def train_loss(params, batch, cfg, *, aux_weight: float = 0.01):
    """Streaming next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (−1 ignored; a ``vlm`` batch's ``patch_embeds``
    positions carry no loss) plus ``aux_weight`` times the layers' mean aux
    term. Returns ``(loss, {"nll", "aux"})``."""
    patch = batch.get("patch_embeds")
    hidden, aux, _ = forward_hidden(params, batch["tokens"], cfg, patch_embeds=patch)
    if patch is not None:
        hidden = hidden[:, patch.shape[1]:]
    nll = L.chunked_xent(hidden, _out_embedding(params), batch["labels"], cfg.logits_chunk,
                         cfg.vocab_size)
    loss = nll + aux_weight * aux / max(cfg.num_layers, 1)
    return loss, {"nll": nll, "aux": aux}


def prefill(params, batch, cfg, *, ffn_backend: Optional[str] = None):
    """Build the dense KV cache of ``batch["tokens"] [B, S]`` (after
    ``batch["patch_embeds"] [B, P, D]``, if given): ``(cache, logits [B, 1,
    V])`` of the last token, ``cache["pos"] = S + P``, where decoding
    continues."""
    tokens = batch["tokens"]
    patch = batch.get("patch_embeds")
    hidden, _, cache = forward_hidden(params, tokens, cfg, patch_embeds=patch,
                                      collect_cache=True, ffn_backend=ffn_backend)
    cache["pos"] = tokens.shape[1] + (patch.shape[1] if patch is not None else 0)
    return cache, _logits(params, hidden[:, -1:], cfg)


def extend_cache(cache, rows: int):
    """The dense cache with ``rows`` zero positions appended to ``k`` and
    ``v`` (a prefill cache covers exactly its inputs; decode steps write
    past them), every other entry carried as it is — recurrent states,
    ``cross_k``/``cross_v``, ``pos`` — as the reference's wave batcher pads
    a cache. A cache without ``k`` (xlstm's) raises ``KeyError``, as there."""
    pad = cache["k"].new_zeros((*cache["k"].shape[:2], rows, *cache["k"].shape[3:]))
    return dict(cache, k=torch.cat([cache["k"], pad], dim=2),
                v=torch.cat([cache["v"], pad], dim=2))


def _decode_block(p, x, cfg, *, k_cache, v_cache, pos: int, window: int, ffn_backend=None):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, (k_cache, v_cache) = L.decode_attention(
        p["attn"], h, cfg, k_cache=k_cache, v_cache=v_cache, pos=pos, window=window)
    x = x + attn_out
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    delta, _, _, _ = _ffn_delta(p, h, cfg, ffn_backend=ffn_backend)
    return x + delta, (k_cache, v_cache)


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg, *,
                ffn_backend: Optional[str] = None):
    """One decode step over the dense cache: ``token [B, 1]`` at position
    ``pos`` (a host int). Each layer's new K/V row is written into
    ``cache["k"]``/``cache["v"]`` in place, as the reference's donated
    carry is. Returns ``(cache, logits [B, 1, V])``."""
    x = L.embed_tokens(params["embed"], token, cfg.vocab_size)
    kf, vf = cache["k"], cache["v"]
    windows = layer_windows_static(cfg, kf.shape[2])
    for l, p_l in enumerate(params["layers"]):
        x, _ = _decode_block(p_l, x, cfg, k_cache=kf[l], v_cache=vf[l], pos=pos,
                             window=int(windows[l]), ffn_backend=ffn_backend)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return {"k": kf, "v": vf, "pos": pos + 1}, _logits(params, x, cfg)


# ------------------------------------------------------------ paged path
def _paged_decode_core(params, kf, vf, tables, token, positions, active, cfg, nb: int,
                       bs: int, *, use_otp: bool, qs=(), ffn_backend=None):
    """One decode step over the flattened pools ``kf``/``vf`` ``[L, NB·BS+1,
    Hkv, dh]`` (written in place; ``qs`` their int8 tables or ``()``).
    ``tables [B, MB]`` int32, ``token [B, 1]``, ``positions [B]``, ``active
    [B]`` bool. Returns ``(logits [B, 1, V], per_slot_act [B], slot_counts
    [L, num_slots])``."""
    x = L.embed_tokens(params["embed"], token, cfg.vocab_size)
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
        _write_kv(kf, vf, qs, l, dest, k_new[:, 0], v_new[:, 0])
        attn = ops.paged_attention(
            q.reshape(b, hkv, g, dh),
            kf[l, : nb * bs].view(nb, bs, hkv, dh),
            vf[l, : nb * bs].view(nb, bs, hkv, dh),
            tables, lengths, window=int(windows[l]),
            quant=tuple(t[l, : nb * bs].view(nb, bs, hkv) for t in qs) if qs else None,
        )
        x = x + L.linear(p_l["attn"]["wo"], attn.reshape(b, 1, hq * dh).to(x.dtype))
        h2 = L.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        delta, act, cnt, _ = _ffn_delta(p_l, h2, cfg, use_otp=use_otp, count_weight=active,
                                        ffn_backend=ffn_backend)
        x = x + delta
        acts.append(act)
        counts.append(cnt)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    per_slot = torch.stack(acts).mean(dim=(0, 2))  # [B]
    return _logits(params, x, cfg), per_slot, torch.stack(counts)


def _masked_activation(per_slot, active):
    w = active.float()
    return torch.sum(per_slot * w) / torch.clamp_min(w.sum(), 1.0)


def sample_gumbel(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits [..., V]`` from
    ``softmax(logits / T)`` by Gumbel-max, ``argmax(lg / T − log(−log U))``
    with ``U ~ U[tiny, 1)`` from ``generator`` (``torch.rand``'s 0 raised to
    the smallest normal float, as ``jax.random.gumbel`` bounds it, so no
    entry's noise is −inf) — what ``jax.random.categorical`` computes (not
    its bits). All on the device: no host sync."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min_(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits.float() / temperature - torch.log(-torch.log(u)), dim=-1)


def paged_decode_horizon(params, kf, vf, tables, token, positions, active, cfg, *,
                         block_size: int, horizon: int, budgets, eos_ids,
                         use_otp: bool = True, qs=(), temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         ffn_backend: Optional[str] = None):
    """``H`` decode steps, each exactly :func:`_paged_decode_core`, with the
    on-device token choice feeding the next step and per-slot stop logic in
    the carried ``active`` mask (budget spent, EOS emitted). Nothing syncs
    with the host inside the horizon.

    ``temperature = 0`` (default) is greedy argmax; ``> 0`` draws each step's
    token with :func:`sample_gumbel` from ``generator`` (one draw per step, in
    step order), so a run seeded the same — an offload replay of the
    megastep — draws the same tokens.

    Returns ``(tokens [H, B] (-1 where not emitted), emits [H, B],
    expert_activation [H], slot_counts [H, L, num_slots])``.
    """
    if horizon < 1:
        raise ValueError(f"horizon must be ≥ 1, got {horizon}")
    greedy = temperature <= 0.0
    if not greedy and generator is None:
        raise ValueError("temperature sampling needs an explicit generator")
    bs = block_size
    nb = (kf.shape[1] - 1) // bs
    cur, pos, act, budget = token, positions, active, budgets
    toks, emits, acts, counts = [], [], [], []
    for _ in range(horizon):
        logits, per_slot, cnt = _paged_decode_core(
            params, kf, vf, tables, cur, pos, act, cfg, nb, bs, use_otp=use_otp, qs=qs,
            ffn_backend=ffn_backend)
        if greedy:
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        else:
            nxt = sample_gumbel(logits[:, -1, :], temperature, generator).to(torch.int32)
        emit = act
        budget = budget - emit.to(torch.int32)
        stop = (budget <= 0) | ((eos_ids >= 0) & (nxt == eos_ids))
        toks.append(torch.where(emit, nxt, -1))
        emits.append(emit)
        acts.append(_masked_activation(per_slot, act))
        counts.append(cnt)
        cur, pos, act = nxt[:, None], pos + emit.to(pos.dtype), act & ~stop
    return torch.stack(toks), torch.stack(emits), torch.stack(acts), torch.stack(counts)


def _resumed_ffn(p, h2, cfg, chunk, d0: int, valid_len: int, decode_batch: int, **kw):
    """The MoE half of a resumed chunk's layer: ``(Δx, slot_counts)``. The
    prompt's rows ``[0, d0)`` take the chunk's dispatch as the first prefill
    gave it (a token's capacity rank counts only the tokens before it). The
    decode-era rows ``[d0, valid_len)`` are dispatched at the capacity of
    the decode megastep's ``decode_batch`` tokens, that many rows at a time
    with the chunk's other tokens out of the dispatch: as in the decode, no
    token of theirs is dropped and the grouped GEMMs run the decode's row
    blocks. Every call sees the whole chunk (the router's and the OTP's
    shapes as the first prefill's) and counts the rows it owns, so the
    counts are the one dispatch's."""
    cap = dispatch_capacity(cfg, decode_batch)
    spans = ([(0, d0)] if d0 else []) + [(r, min(r + cap, valid_len))
                                         for r in range(d0, valid_len, cap)]
    delta, counts = torch.zeros_like(h2), None
    for lo, hi in spans:
        own = ((chunk >= lo) & (chunk < hi))[None]
        dec = lo >= d0
        d, _, cnt, _ = _ffn_delta(p, h2, cfg, count_weight=own, rows=own if dec else None,
                                  capacity=cap if dec else None, **kw)
        delta = torch.where(own[..., None], d, delta)
        counts = cnt if counts is None else counts + cnt
    return delta, counts


def paged_prefill_chunk(params, kf, vf, table_row, tokens, start: int, valid_len: int,
                        cfg, *, block_size: int, use_otp: bool = True, qs=(),
                        ffn_backend: Optional[str] = None, decode_from: Optional[int] = None,
                        decode_batch: int = 1):
    """Chunked prefill of ONE request into its pages.

    ``tokens [1, C]`` is one fixed-size chunk (the tail right-padded);
    ``start`` counts tokens already written and ``valid_len ≤ C`` is the
    chunk's real length (host ints). Padded positions write the scratch
    row and never enter the gathered kv. ``table_row [1, MB]``. On int8
    pools (``qs``) the gathered rows are dequantized with
    :func:`dequantize_kv_rows`, the decode kernel's epilogue, so attention
    over a shared prefix page reads the floats every later decode reads.

    ``decode_from`` (a recompute resume; None otherwise) is the position
    where the rows a decode step wrote begin, ``decode_batch`` the decode
    megastep's batch (the engine's slots). Each query row at or past it
    attends through ``ops.paged_attention`` — one query, that row's length,
    over the pages this chunk has just written — and takes the MoE as the
    decode step did (:func:`_resumed_ffn`), so the resume rewrites those
    rows bit for bit. Earlier rows run as any prefill's.

    Returns ``(logits [1, 1, V] of the last valid token, slot_counts [L,
    num_slots])``.
    """
    bs = block_size
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
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
    d0 = valid_len if decode_from is None else min(max(decode_from - start, 0), valid_len)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    counts = []
    for l, p_l in enumerate(params["layers"]):
        h = L.rms_norm(x, p_l["ln1"], cfg.norm_eps)
        k_new, v_new = L._kv_only(p_l["attn"], h, cfg, pos2d)
        _write_kv(kf, vf, qs, l, dest, k_new[0], v_new[0])
        if qs:
            ks, kz, vs, vz = (t[l][phys] for t in qs)
            k_log = dequantize_kv_rows(kf[l][phys], ks, kz)
            v_log = dequantize_kv_rows(vf[l][phys], vs, vz)
        else:
            k_log, v_log = kf[l][phys], vf[l][phys]
        q = L._q_only(p_l["attn"], h, cfg, pos2d)
        heads = L.attend(q, k_log[None], v_log[None], posf, kv_pos, cfg, causal=True,
                         window=int(windows[l]), dtype=h.dtype)
        if d0 < valid_len:  # the decode-era rows, as the decode step attends
            n = valid_len - d0
            dec = ops.paged_attention(
                q[0, d0:valid_len].reshape(n, hkv, hq // hkv, dh),
                kf[l, : nb * bs].view(nb, bs, hkv, dh),
                vf[l, : nb * bs].view(nb, bs, hkv, dh),
                table_row.to(torch.int32).expand(n, -1).contiguous(),
                (posf[d0:valid_len] + 1).to(torch.int32),
                window=int(windows[l]),
                quant=tuple(t[l, : nb * bs].view(nb, bs, hkv) for t in qs) if qs else None,
            )
            heads = torch.cat([heads[:, :d0], dec.reshape(1, n, hq * dh).to(heads.dtype),
                               heads[:, valid_len:]], dim=1)
        x = x + L.linear(p_l["attn"]["wo"], heads)
        h2 = L.rms_norm(x, p_l["ln2"], cfg.norm_eps)
        if d0 < valid_len and cfg.is_moe:
            delta, cnt = _resumed_ffn(p_l, h2, cfg, chunk, d0, valid_len, decode_batch,
                                      use_otp=use_otp, ffn_backend=ffn_backend)
        else:
            delta, _, cnt, _ = _ffn_delta(p_l, h2, cfg, use_otp=use_otp,
                                          count_weight=count_weight, ffn_backend=ffn_backend)
        x = x + delta
        counts.append(cnt)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x[:, valid_len - 1:valid_len], cfg), torch.stack(counts)
