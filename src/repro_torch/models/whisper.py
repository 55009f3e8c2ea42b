"""Whisper-style encoder–decoder backbone (port of
``repro/models/whisper.py``; the audio frontend is a stub).

Frames arrive as precomputed embeddings ``batch["frames"] [B, S_enc, D]``
(whisper-small: 1500). Encoder: bidirectional attention over the frames
plus sinusoidal positions. Decoder blocks: causal self-attention (cached),
cross-attention onto the encoder's output (its K/V cached at prefill) and a
SwiGLU MLP; absolute sinusoidal positions, no rotation anywhere.

Params: ``{"embed": [V, D], "enc_blocks": [{"ln1", "attn", "ln2", "mlp"},
...], "dec_blocks": [{"ln1", "attn", "lnx", "cross", "ln2", "mlp"}, ...],
"enc_norm": [D], "final_norm": [D]}``. The cache: ``k``/``v`` ``[L, B, S,
Hkv, dh]`` (self-attention), ``cross_k``/``cross_v`` ``[L, B, S_enc, Hkv,
dh]`` and ``pos``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..parallel.sharding import enter, tp_share
from . import layers as L
from .transformer import _dtype, _logits

__all__ = ["decode_step", "encode", "hidden", "init_whisper", "prefill", "train_loss"]


def _init_block(gen: torch.Generator, cfg, dt, cross: bool) -> Dict:
    d, dev = cfg.d_model, gen.device
    p = {"ln1": torch.zeros(d, dtype=dt, device=dev), "attn": L.init_attention(gen, cfg, dt)}
    if cross:
        p["lnx"] = torch.zeros(d, dtype=dt, device=dev)
        p["cross"] = L.init_attention(gen, cfg, dt)
    p["ln2"] = torch.zeros(d, dtype=dt, device=dev)
    p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, dt)
    return p


def init_whisper(gen: torch.Generator, cfg) -> Dict:
    """A model of ``cfg`` drawn from ``gen`` on its device in ``cfg.dtype``
    (the reference's shapes and scales, not its draws)."""
    dt, dev, d = _dtype(cfg), gen.device, cfg.d_model
    enc = [_init_block(gen, cfg, dt, cross=False) for _ in range(cfg.encoder_layers)]
    dec = [_init_block(gen, cfg, dt, cross=True) for _ in range(cfg.num_layers)]
    return {"embed": torch.randn(cfg.vocab_size, d, generator=gen, device=dev, dtype=dt) * 0.02,
            "enc_blocks": enc, "dec_blocks": dec,
            "enc_norm": torch.zeros(d, dtype=dt, device=dev),
            "final_norm": torch.zeros(d, dtype=dt, device=dev)}


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def encode(params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """``frames [B, S_enc, D]`` (stub embeddings) → the encoder's states.
    Under ``cfg.remat == "block"`` each encoder and decoder block is
    recomputed in the backward (:func:`~repro_torch.models.layers.remat_block`)."""
    pos = _positions(frames.shape[1], frames.device)
    x = frames + L.sinusoidal_positions(pos, cfg.d_model)[None].to(frames.dtype)
    for p_l in params["enc_blocks"]:
        x = L.remat_block(cfg, _enc_block, p_l, x, cfg, pos)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_block(p_l, x: torch.Tensor, cfg, pos: torch.Tensor) -> torch.Tensor:
    a, _ = L.attention(p_l["attn"], L.rms_norm(x, p_l["ln1"], cfg.norm_eps), cfg,
                       positions=pos, causal=False, rope=False)
    x = x + a
    return x + L.mlp(p_l["mlp"], L.rms_norm(x, p_l["ln2"], cfg.norm_eps), cfg.d_ff)


def _cross_kv(p_cross, enc_out: torch.Tensor, cfg):
    """The cross-attention K/V ``[B, S_enc, Hkv, dh]`` of the encoder's
    states (this rank's KV heads where ``cross`` is split by heads: the
    encoder's states enter the rank's share there)."""
    mesh = tp_share(p_cross, "attn", cfg.num_heads * cfg.head_dim, cfg)
    if mesh is not None:
        enc_out = enter(enc_out, mesh, "model")
    return (L.linear(p_cross["wk"], enc_out).unflatten(-1, (-1, cfg.head_dim)),
            L.linear(p_cross["wv"], enc_out).unflatten(-1, (-1, cfg.head_dim)))


def _embed(params, tokens: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    return x + L.sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)


def _dec_stack(params, x: torch.Tensor, cfg, enc_out: torch.Tensor, positions: torch.Tensor,
               collect_cache: bool = False):
    """The decoder blocks over ``x [B, S, D]`` (embedded, positions added):
    ``(hidden after the final norm, (k, v, cross_k, cross_v) stacked over
    layers | None)``."""
    enc_pos = _positions(enc_out.shape[1], enc_out.device)
    ys = []
    for p_l in params["dec_blocks"]:
        x, kv = L.remat_block(cfg, _dec_block, p_l, x, cfg, enc_out, positions, enc_pos)
        if collect_cache:
            ys.append(kv)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, (tuple(torch.stack(t) for t in zip(*ys)) if collect_cache else None)


def _dec_block(p_l, x: torch.Tensor, cfg, enc_out: torch.Tensor, positions: torch.Tensor,
               enc_pos: torch.Tensor):
    """One decoder block: ``(x, (k, v, cross_k, cross_v))``."""
    a, kv = L.attention(p_l["attn"], L.rms_norm(x, p_l["ln1"], cfg.norm_eps), cfg,
                        positions=positions, causal=True, rope=False)
    x = x + a
    ck, cv = _cross_kv(p_l["cross"], enc_out, cfg)
    a, _ = L.attention(p_l["cross"], L.rms_norm(x, p_l["lnx"], cfg.norm_eps), cfg,
                       positions=positions, causal=False, rope=False,
                       kv_override=(ck, cv, enc_pos))
    x = x + a
    return x + L.mlp(p_l["mlp"], L.rms_norm(x, p_l["ln2"], cfg.norm_eps), cfg.d_ff), \
        (*kv, ck, cv)


def _forward(params, batch, cfg, collect_cache: bool = False):
    """Encode ``batch["frames"]`` and run the decoder over ``batch["tokens"]
    [B, S]``: :func:`_dec_stack`'s ``(hidden, cache entries | None)``."""
    enc_out = encode(params, batch["frames"], cfg)
    pos = _positions(batch["tokens"].shape[1], enc_out.device)
    return _dec_stack(params, _embed(params, batch["tokens"], pos, cfg), cfg, enc_out, pos,
                      collect_cache=collect_cache)


def hidden(params, batch, cfg, **_):
    """The decoder's states ``[B, S, D]`` after the final norm over
    ``batch["tokens"]`` given ``batch["frames"]``."""
    return _forward(params, batch, cfg)[0]


def train_loss(params, batch, cfg, **_):
    """Streaming next-token cross-entropy of ``batch["tokens"]`` given
    ``batch["frames"]``: ``(nll, {"nll"})``."""
    nll = L.chunked_xent(hidden(params, batch, cfg), params["embed"], batch["labels"],
                         cfg.logits_chunk, cfg.vocab_size)
    return nll, {"nll": nll}


def prefill(params, batch, cfg, **_):
    """Encode ``batch["frames"]`` and run the decoder over ``batch["tokens"]
    [B, S]``: ``(cache, logits [B, 1, V])``, ``cache["pos"] = S``."""
    h, (k, v, ck, cv) = _forward(params, batch, cfg, collect_cache=True)
    cache = {"k": k, "v": v, "cross_k": ck, "cross_v": cv, "pos": batch["tokens"].shape[1]}
    return cache, _logits(params, h[:, -1:], cfg)


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg, **_):
    """One token ``token [B, 1]`` at ``pos`` (a host int): the self-attention
    K/V row is written into ``cache["k"]``/``cache["v"]`` in place (``pos``
    must lie inside them), the cross K/V only read. ``(cache, logits [B, 1,
    V])``."""
    x = _embed(params, token, torch.tensor([pos], device=token.device), cfg)
    for l, p_l in enumerate(params["dec_blocks"]):
        a, _ = L.decode_attention(p_l["attn"], L.rms_norm(x, p_l["ln1"], cfg.norm_eps), cfg,
                                  k_cache=cache["k"][l], v_cache=cache["v"][l], pos=pos,
                                  rope=False)
        x = x + a
        a, _ = L.decode_attention(p_l["cross"], L.rms_norm(x, p_l["lnx"], cfg.norm_eps), cfg,
                                  k_cache=cache["cross_k"][l], v_cache=cache["cross_v"][l],
                                  pos=pos, cross=True)
        x = x + a
        x = x + L.mlp(p_l["mlp"], L.rms_norm(x, p_l["ln2"], cfg.norm_eps), cfg.d_ff)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dict(cache, pos=pos + 1), _logits(params, x, cfg)
