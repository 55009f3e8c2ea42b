"""RecurrentGemma-style hybrid (port of ``repro/models/recurrent.py``):
RG-LRU recurrent blocks and local attention in the pattern ``(rglru, rglru,
attn)``.

The RG-LRU recurrence ``h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙
x_t)`` is a first-order linear scan; the reference's
``jax.lax.associative_scan`` of the pair ``(a, b)`` becomes a log-depth
(Hillis–Steele) scan over whole tensors (:func:`_linear_scan`). Decode keeps
O(1) state per recurrent block (the RNN state and a width-4 causal conv
tail); attention blocks keep the dense KV cache and attend a
``cfg.local_window`` window.

Params: ``{"embed": [V, D], "groups": [{"rg1", "rg2", "attn"}, ...],
"tail": [<rg block>, ...], "final_norm": [D]}`` — 26 layers are 8 groups of
(R, R, A) and 2 trailing R blocks (:func:`_layout`). A recurrent block is
``{"ln1", "gate_in", "proj_in", "conv" [4, W], "wa", "wx", "lam" [W] (f32),
"proj_out", "ln2", "mlp"}``; an attention block ``{"ln1", "attn", "ln2",
"mlp"}``. The cache is the reference's: ``conv1``/``conv2`` ``[G, B, 3,
W]``, ``h1``/``h2`` ``[G, B, W]`` (f32), ``k``/``v`` ``[G, B, S, Hkv, dh]``,
``tail_conv`` ``[T, B, 3, W]``, ``tail_h`` ``[T, B, W]`` and ``pos``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import all_gather, all_reduce, enter, tp_share
from . import layers as L
from .transformer import _dtype, _logits

__all__ = ["decode_step", "hidden", "init_recurrent", "prefill", "train_loss"]

CONV_W = 4
RGLRU_C = 8.0


# --------------------------------------------------------------- RG block
def _init_rg_block(gen: torch.Generator, cfg, dt) -> Dict:
    d, w, dev = cfg.d_model, cfg.rglru_width, gen.device
    return {
        "ln1": torch.zeros(d, dtype=dt, device=dev),
        "gate_in": L.init_linear(gen, d, w, dt),  # gelu branch
        "proj_in": L.init_linear(gen, d, w, dt),  # recurrence branch
        "conv": torch.randn(CONV_W, w, generator=gen, device=dev, dtype=dt) * 0.1,
        "wa": L.init_linear(gen, w, w, dt),  # recurrence gate r_t
        "wx": L.init_linear(gen, w, w, dt),  # input gate i_t
        "lam": torch.full((w,), 2.0, device=dev),  # Λ (f32): a = sigmoid(Λ)
        "proj_out": L.init_linear(gen, w, d, dt),
        "ln2": torch.zeros(d, dtype=dt, device=dev),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, dt),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width 4: ``x [B, S, W]``, ``kernel [4, W]``.
    With ``state [B, 3, W]`` (decode) it is prepended instead of zeros.
    Returns ``(y, new_state)``, the state the last 3 inputs."""
    b, s, w = x.shape
    if state is None:
        pad = x.new_zeros((b, CONV_W - 1, w))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + s] * kernel[i] for i in range(CONV_W))
    return y, xp[:, -(CONV_W - 1):]


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t · h_{t−1} + b_t`` over dim 1 from ``h_{−1} = 0``, in
    ⌈log₂ S⌉ whole-tensor steps: after the step of offset ``d`` each
    position holds the composition of the ``2d`` elements ending there."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _gates(p, u: torch.Tensor, u_in: Optional[torch.Tensor] = None):
    """``(a, sqrt(1 − a²), i)`` in f32 for ``u [B, S, W]``; ``u_in`` (the
    whole width, under tensor parallelism) feeds the gates' projections."""
    u_in = u if u_in is None else u_in
    r = torch.sigmoid(L.linear(p["wa"], u_in).float())
    i = torch.sigmoid(L.linear(p["wx"], u_in).float())
    a = torch.exp(RGLRU_C * r * F.logsigmoid(p["lam"].float()))  # per-step decay ≤ 1
    return a, torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)), i


def _rglru(p, u: torch.Tensor, h0: Optional[torch.Tensor] = None,
           u_in: Optional[torch.Tensor] = None):
    """RG-LRU over ``u [B, S, W]`` from ``h0`` (f32; zeros if None):
    ``(h in u's dtype, h_last [B, W] f32)``."""
    a, norm, i = _gates(p, u, u_in)
    gated = norm * (i * u.float())
    if h0 is not None:  # fold h0 into step 0
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0.float())[:, None], gated[:, 1:]], dim=1)
    h = _linear_scan(a, gated)
    return h.to(u.dtype), h[:, -1]


def _tp_rg(p, cfg):
    """``(mesh, p)`` for a rank holding its share of a split RG-LRU
    (:func:`~repro_torch.parallel.sharding.tp_share`): its ``conv`` and
    ``lam`` columns (whole on every rank, entered so their gradients sum
    over ``model``); ``(None, p)`` for a whole one."""
    mesh = tp_share(p, "rglru", cfg.rglru_width, cfg)
    if mesh is None:
        return None, p
    w = p["proj_out"]["w"].shape[0]
    c0 = mesh.index("model") * w
    return mesh, dict(p, conv=enter(p["conv"], mesh, "model")[:, c0:c0 + w],
                      lam=enter(p["lam"], mesh, "model")[c0:c0 + w])


def _rg_mix(p, x: torch.Tensor, cfg, conv_state, step):
    """The recurrent half of a block: ``x`` plus the RG-LRU branch, and the
    new states. ``step(p, u, u_in)`` runs the recurrence over ``u`` (the
    rank's columns) with the gates' input ``u_in`` (the whole width). Under
    tensor parallelism the rank runs its columns of both branches, gathers
    ``u`` for the gates and sums ``proj_out``'s partial product over
    ``model``."""
    mesh, p = _tp_rg(p, cfg)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if mesh is not None:
        h = enter(h, mesh, "model")
    gate = F.gelu(L.linear(p["gate_in"], h), approximate="tanh")
    u, conv_state = _causal_conv(L.linear(p["proj_in"], h), p["conv"], conv_state)
    u_in = u if mesh is None else all_gather(u, mesh, "model", u.dim() - 1)
    y, state = step(p, u, u_in)
    out = L.linear(p["proj_out"], y.to(x.dtype) * gate)
    return x + (out if mesh is None else all_reduce(out, mesh, "model")), conv_state, state


def _rg_block(p, x: torch.Tensor, cfg, conv_state=None, h0=None):
    """One recurrent block over a sequence: ``(x, (conv_state, h_last))``."""
    x, conv_state, h_last = _rg_mix(p, x, cfg, conv_state,
                                    lambda q, u, u_in: _rglru(q, u, h0, u_in))
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.d_ff)
    return x, (conv_state, h_last)


# ------------------------------------------------------------- attn block
def _init_attn_block(gen: torch.Generator, cfg, dt) -> Dict:
    d, dev = cfg.d_model, gen.device
    return {"ln1": torch.zeros(d, dtype=dt, device=dev), "attn": L.init_attention(gen, cfg, dt),
            "ln2": torch.zeros(d, dtype=dt, device=dev), "mlp": L.init_mlp(gen, d, cfg.d_ff, dt)}


def _attn_block(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Local causal attention block (window ``cfg.local_window``):
    ``(x, (k, v))``."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, kv = L.attention(p["attn"], h, cfg, positions=positions, causal=True,
                        window=cfg.local_window)
    x = x + a
    return x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.d_ff), kv


# ---------------------------------------------------------------- model
def _layout(cfg):
    """``(num_groups, trailing recurrent blocks)``: 26 = 8 × (R, R, A) + 2 R."""
    group = len(cfg.block_pattern)
    n_groups = cfg.num_layers // group
    return n_groups, cfg.num_layers - n_groups * group


def init_recurrent(gen: torch.Generator, cfg) -> Dict:
    """A model of ``cfg`` drawn from ``gen`` on its device in ``cfg.dtype``
    (the reference's shapes and scales; its draws are jax's and are not
    reproduced)."""
    dt, dev = _dtype(cfg), gen.device
    n_groups, trailing = _layout(cfg)
    groups = [{"rg1": _init_rg_block(gen, cfg, dt), "rg2": _init_rg_block(gen, cfg, dt),
               "attn": _init_attn_block(gen, cfg, dt)} for _ in range(n_groups)]
    tail = [_init_rg_block(gen, cfg, dt) for _ in range(trailing)]
    embed = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen, device=dev, dtype=dt) * 0.02
    return {"embed": embed, "groups": groups, "tail": tail,
            "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=dev)}


def _group(p_g, x: torch.Tensor, cfg, pos: torch.Tensor):
    """One (R, R, A) group: ``(x, (conv1, h1, conv2, h2, k, v))``."""
    x, st1 = _rg_block(p_g["rg1"], x, cfg)
    x, st2 = _rg_block(p_g["rg2"], x, cfg)
    x, kv = _attn_block(p_g["attn"], x, cfg, pos)
    return x, (*st1, *st2, *kv)


def _forward(params, tokens: torch.Tensor, cfg, collect_cache: bool = False):
    """All blocks over ``tokens [B, S]``: ``(hidden [B, S, D], cache |
    None)``; the cache (without ``pos``) as the module docstring lays out.
    Under ``cfg.remat == "block"`` each group and each trailing block is
    recomputed in the backward (:func:`~repro_torch.models.layers.remat_block`;
    the reference checkpoints its groups and runs the two trailing blocks
    plain)."""
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device)
    states = []
    for p_g in params["groups"]:
        x, st = L.remat_block(cfg, _group, p_g, x, cfg, pos)
        states.append(st)
    tail = []
    for p_rg in params["tail"]:
        x, st = L.remat_block(cfg, _rg_block, p_rg, x, cfg)
        tail.append(st)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return x, None
    w = cfg.rglru_width
    cache = dict(zip(("conv1", "h1", "conv2", "h2", "k", "v"),
                     (torch.stack(t) for t in zip(*states))))
    if tail:
        cache["tail_conv"] = torch.stack([t[0] for t in tail])
        cache["tail_h"] = torch.stack([t[1] for t in tail])
    else:
        cache["tail_conv"] = x.new_zeros((0, b, CONV_W - 1, w))
        cache["tail_h"] = torch.zeros((0, b, w), device=x.device)
    return x, cache


def hidden(params, batch, cfg, **_):
    """The states ``[B, S, D]`` after the final norm over ``batch["tokens"]``."""
    return _forward(params, batch["tokens"], cfg)[0]


def train_loss(params, batch, cfg, **_):
    """Streaming next-token cross-entropy: ``(nll, {"nll"})``."""
    nll = L.chunked_xent(hidden(params, batch, cfg), params["embed"], batch["labels"],
                         cfg.logits_chunk, cfg.vocab_size)
    return nll, {"nll": nll}


def prefill(params, batch, cfg, **_):
    """``(cache, logits [B, 1, V])`` of ``batch["tokens"] [B, S]``;
    ``cache["pos"] = S``."""
    h, cache = _forward(params, batch["tokens"], cfg, collect_cache=True)
    cache["pos"] = batch["tokens"].shape[1]
    return cache, _logits(params, h[:, -1:], cfg)


def _rg_decode(p, x: torch.Tensor, cfg, conv_state: torch.Tensor, h_prev: torch.Tensor):
    """One token through a recurrent block: ``x [B, 1, D]`` →
    ``(x, (conv_state, h_new f32))``."""
    def step(q, u, u_in):
        a, norm, i = _gates(q, u, u_in)
        h_new = a[:, 0] * h_prev.float() + norm[:, 0] * (i[:, 0] * u[:, 0].float())
        return h_new[:, None], h_new

    x, conv_state, h_new = _rg_mix(p, x, cfg, conv_state, step)
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.d_ff)
    return x, (conv_state, h_new)


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg, **_):
    """One token ``token [B, 1]`` at ``pos`` (a host int): ``(cache,
    logits [B, 1, V])``. The attention blocks write their K/V row into
    ``cache["k"]``/``cache["v"]`` in place (``pos`` must lie inside them);
    the recurrent states come back as new tensors."""
    x = L.embed_tokens(params["embed"], token, cfg.vocab_size)
    states = []
    for g, p_g in enumerate(params["groups"]):
        x, st1 = _rg_decode(p_g["rg1"], x, cfg, cache["conv1"][g], cache["h1"][g])
        x, st2 = _rg_decode(p_g["rg2"], x, cfg, cache["conv2"][g], cache["h2"][g])
        pa = p_g["attn"]
        a, _ = L.decode_attention(pa["attn"], L.rms_norm(x, pa["ln1"], cfg.norm_eps), cfg,
                                  k_cache=cache["k"][g], v_cache=cache["v"][g], pos=pos,
                                  window=cfg.local_window)
        x = x + a
        x = x + L.mlp(pa["mlp"], L.rms_norm(x, pa["ln2"], cfg.norm_eps), cfg.d_ff)
        states.append((*st1, *st2))
    tail = [None] * len(params["tail"])
    for i, p_rg in enumerate(params["tail"]):
        x, tail[i] = _rg_decode(p_rg, x, cfg, cache["tail_conv"][i], cache["tail_h"][i])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    new = dict(zip(("conv1", "h1", "conv2", "h2"), (torch.stack(t) for t in zip(*states))))
    new.update(k=cache["k"], v=cache["v"], pos=pos + 1,
               tail_conv=torch.stack([t[0] for t in tail]) if tail else cache["tail_conv"],
               tail_h=torch.stack([t[1] for t in tail]) if tail else cache["tail_h"])
    return new, _logits(params, x, cfg)
