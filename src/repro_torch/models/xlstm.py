"""xLSTM, alternating mLSTM and sLSTM blocks (port of
``repro/models/xlstm.py``; arXiv:2405.04517).

``mLSTM``: a matrix memory ``C [B, H, dh, dh]`` with exponential gates and
the max-state stabilizer, stepped over time (:func:`_mlstm_scan`); above 64
steps the sequence runs in 64-step chunks whose inner steps are recomputed
in the backward pass, so autograd keeps ``C`` at chunk boundaries only.
Under ``cfg.remat == "block"`` each (mLSTM, sLSTM) group is recomputed in
the backward as well, as the reference's checkpointed scan body.
``sLSTM``: a scalar memory per channel with exponential gates and a
normalizer state, then a gated FFN (width 4/3 · D rounded to 64). Both
blocks carry a width-4 causal conv (:func:`repro_torch.models.recurrent.
_causal_conv`). ``d_ff = 0`` in the config: every weight is a block's.

Params: ``{"embed": [V, D], "groups": [{"m": <mLSTM>, "s": <sLSTM>}, ...],
"final_norm": [D]}``. The cache is the reference's: ``"m": (C [G, B, H,
dh, dh], n [G, B, H, dh], m [G, B, H])``, ``"mconv" [G, B, 3, 2D]``, ``"s":
(c, n, m)`` each ``[G, B, D]``, ``"sconv" [G, B, 3, D]`` and ``pos``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..launch.counting import scan
from ..parallel.sharding import all_gather, all_reduce, enter, tp_share
from . import layers as L
from .transformer import _dtype, _logits
from .recurrent import _causal_conv

__all__ = ["decode_step", "hidden", "init_xlstm", "prefill", "train_loss"]

#: steps per recomputed chunk of the mLSTM scan (taken when S > MLSTM_CHUNK)
MLSTM_CHUNK = 64
#: the stabilizer's initial state: finite, so ``f + m − m_new`` is never inf − inf
M_INIT = -1e30


# ------------------------------------------------------------ mLSTM block
def _init_mlstm(gen: torch.Generator, cfg, dt) -> Dict:
    d, h, dev = cfg.d_model, cfg.num_heads, gen.device
    ip = 2 * d  # inner (up-projected) width
    return {
        "ln": torch.zeros(d, dtype=dt, device=dev),
        "proj_in": L.init_linear(gen, d, 2 * ip, dt),  # u ‖ z-gate
        "conv": torch.randn(4, ip, generator=gen, device=dev, dtype=dt) * 0.1,
        "wq": L.init_linear(gen, ip, ip, dt),
        "wk": L.init_linear(gen, ip, ip, dt),
        "wv": L.init_linear(gen, ip, ip, dt),
        "w_if": L.init_linear(gen, ip, 2 * h, dt),  # per-head ĩ, f̃
        "out_norm": torch.zeros(ip, dtype=dt, device=dev),
        "proj_out": L.init_linear(gen, ip, d, dt),
    }


def _mlstm_steps(c, n, m, q, k, v, ig, fg):
    """The stabilized recurrence over the time axis of ``q/k/v [T, B, H,
    dh]``, ``ig/fg [T, B, H]`` (f32) from ``(c, n, m)``: ``(h [T, B, H,
    dh], c, n, m)``. Each step reads its own rows (the scan's ``xs``), so
    the backward writes O(T) bytes of input gradients."""
    def step(t, state, qt, kt, vt, it, ft):
        c, n, m = state
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        vk = vt[..., :, None] * kt[..., None, :]
        c = f_p[..., None, None] * c + i_p[..., None, None] * vk
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = torch.matmul(c, qt[..., None])[..., 0]
        den = torch.clamp_min(torch.abs((n * qt).sum(dim=-1)), 1.0)
        return (c, n, m_new), num / den[..., None]

    (c, n, m), hs = scan(q.shape[0], step, (c, n, m), xs=(q, k, v, ig, fg), stack=0)
    return hs, c, n, m


def _mlstm_scan(q, k, v, ig, fg, state=None):
    """The mLSTM over ``q/k/v [B, S, H, dh]``, ``ig/fg [B, S, H]``:
    ``(h [B, S, H, dh] in q's dtype, (C, n, m))`` from ``state`` (zeros and
    :data:`M_INIT` if None). Above :data:`MLSTM_CHUNK` steps the sequence is
    zero-padded to whole chunks — the padded steps update the state, as the
    reference's do — and each chunk is recomputed in the backward pass."""
    b, s, h, dh = q.shape
    xs = [t.float().transpose(0, 1) for t in (q, k, v, ig, fg)]
    xs[1] = xs[1] / dh**0.5
    if state is None:
        c = q.new_zeros((b, h, dh, dh), dtype=torch.float32)
        n = q.new_zeros((b, h, dh), dtype=torch.float32)
        m = torch.full((b, h), M_INIT, device=q.device)
    else:
        c, n, m = state
    if s <= MLSTM_CHUNK:
        hs, c, n, m = _mlstm_steps(c, n, m, *xs)
        return hs.transpose(0, 1).to(q.dtype), (c, n, m)
    pad = (-s) % MLSTM_CHUNK
    if pad:
        xs = [torch.cat([t, t.new_zeros((pad, *t.shape[1:]))]) for t in xs]

    def chunk(i, state, *rows):
        hs, c, n, m = _mlstm_steps(*state, *rows)
        return (c, n, m), hs

    (c, n, m), hs = scan((s + pad) // MLSTM_CHUNK, chunk, (c, n, m),
                         xs=tuple(L._chunks(t, 0, MLSTM_CHUNK) for t in xs), stack=0,
                         remat=True)
    return hs.flatten(0, 1)[:s].transpose(0, 1).to(q.dtype), (c, n, m)


def _columns(t: torch.Tensor, mesh, width: int) -> torch.Tensor:
    """This rank's ``width`` columns of a whole parameter that the block
    reads at its columns only (entered: its gradient sums over ``model``)."""
    c0 = mesh.index("model") * width
    return enter(t, mesh, "model")[..., c0:c0 + width]


def _rms_norm_cols(x: torch.Tensor, w: torch.Tensor, eps: float, mesh) -> torch.Tensor:
    """:func:`~repro_torch.models.layers.rms_norm` over a width split over
    ``model``: ``x`` holds this rank's columns; the mean of squares sums the
    ranks' partial sums."""
    xf = x.float()
    sq = all_reduce((xf * xf).sum(dim=-1, keepdim=True), mesh, "model", backward="all_reduce")
    inv = torch.rsqrt(sq / (x.shape[-1] * mesh.shape["model"]) + eps).to(x.dtype)
    return x * inv * (1.0 + w.to(x.dtype))


def _mlstm_block(p, x: torch.Tensor, cfg, state=None, conv_state=None):
    """``(x, (state, conv_state))`` over ``x [B, S, D]``. Under tensor
    parallelism (:func:`~repro_torch.parallel.sharding.tp_share`) the rank
    runs its heads: its columns of ``[u | z]``, of the convolution and of
    q, k, v and the gates (from ``u`` gathered over ``model``), the output
    norm over the whole width, and ``proj_out``'s rows, summed over
    ``model``."""
    b, s, _ = x.shape
    mesh = tp_share(p, "mlstm", 2 * cfg.d_model, cfg)
    hn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if mesh is not None:
        hn = enter(hn, mesh, "model")
    uz = L.linear(p["proj_in"], hn)
    ip = uz.shape[-1] // 2
    u, z = uz[..., :ip], uz[..., ip:]
    conv = p["conv"] if mesh is None else _columns(p["conv"], mesh, ip)
    cu, conv_state = _causal_conv(u, conv, conv_state)
    cu = F.silu(cu)
    u_in, cu_in = u, cu
    if mesh is not None:
        u_in, cu_in = (all_gather(t, mesh, "model", t.dim() - 1) for t in (u, cu))
    h = p["w_if"]["w"].shape[1] // 2
    dh = ip // h
    q = L.linear(p["wq"], cu_in).reshape(b, s, h, dh)
    k = L.linear(p["wk"], cu_in).reshape(b, s, h, dh)
    v = L.linear(p["wv"], u_in).reshape(b, s, h, dh)
    gif = L.linear(p["w_if"], cu_in).float()
    hseq, state = _mlstm_scan(q, k, v, gif[..., :h], F.logsigmoid(gif[..., h:]), state)
    hseq = hseq.reshape(b, s, ip)
    if mesh is None:
        hseq = L.rms_norm(hseq, p["out_norm"], cfg.norm_eps) * F.silu(z)
        return x + L.linear(p["proj_out"], hseq), (state, conv_state)
    hseq = _rms_norm_cols(hseq, _columns(p["out_norm"], mesh, ip), cfg.norm_eps, mesh) * F.silu(z)
    return x + all_reduce(L.linear(p["proj_out"], hseq), mesh, "model"), (state, conv_state)


# ------------------------------------------------------------ sLSTM block
def ffn_width(d: int) -> int:
    """The sLSTM's gated FFN width: 4/3 · D rounded to 64."""
    return int(round(d * 4 / 3 / 64)) * 64


def _init_slstm(gen: torch.Generator, cfg, dt) -> Dict:
    d, dev = cfg.d_model, gen.device
    f = ffn_width(d)
    return {
        "ln": torch.zeros(d, dtype=dt, device=dev),
        "conv": torch.randn(4, d, generator=gen, device=dev, dtype=dt) * 0.1,
        "w_z": L.init_linear(gen, d, d, dt),
        "w_o": L.init_linear(gen, d, d, dt),
        "w_if": L.init_linear(gen, d, 2 * d, dt),
        "ln2": torch.zeros(d, dtype=dt, device=dev),
        "ffn": {"proj_in": L.init_linear(gen, d, 2 * f, dt),
                "proj_out": L.init_linear(gen, f, d, dt)},
    }


def _slstm_seq(z, o, ig, fg, state=None):
    """The scalar-memory recurrence over ``[B, S, D]`` inputs (f32 gates):
    ``(h [B, S, D] f32, (c, n, m))``. Each step reads its own rows (the
    scan's ``xs``), so the backward writes O(S) bytes of input gradients."""
    b, s, d = z.shape
    if state is None:
        c = torch.zeros((b, d), device=z.device)
        n = torch.zeros((b, d), device=z.device)
        m = torch.full((b, d), M_INIT, device=z.device)
    else:
        c, n, m = state

    def step(t, state, *rows):
        h, c, n, m = _slstm_step(*state, *rows)
        return (c, n, m), h

    (c, n, m), hs = scan(s, step, (c, n, m), stack=1,
                         xs=tuple(t.float().transpose(0, 1) for t in (z, o, ig, fg)))
    return hs, (c, n, m)


def _slstm_step(c, n, m, z, o, ig, fg):
    """One step of the recurrence: ``(h, c, n, m)``."""
    m_new = torch.maximum(fg + m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(fg + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    return o * c / torch.clamp_min(n, 1.0), c, n, m_new


def _slstm_block(p, x: torch.Tensor, cfg, state=None, conv_state=None):
    """``(x, (state, conv_state))`` over ``x [B, S, D]``. Under tensor
    parallelism the rank runs its channels of the recurrence (the
    convolution whole) and all-gathers them; the FFN its columns of ``[u |
    v]`` and ``proj_out``'s rows, summed over ``model``."""
    mesh = tp_share(p, "slstm", cfg.d_model, cfg)
    hnorm = L.rms_norm(x, p["ln"], cfg.norm_eps)
    cx, conv_state = _causal_conv(hnorm, p["conv"], conv_state)
    cx = F.silu(cx)
    if mesh is not None:
        hnorm, cx = enter(hnorm, mesh, "model"), enter(cx, mesh, "model")
    z = torch.tanh(L.linear(p["w_z"], hnorm))
    o = torch.sigmoid(L.linear(p["w_o"], hnorm))
    gif = L.linear(p["w_if"], cx).float()
    d = z.shape[-1]
    hseq, state = _slstm_seq(z, o, gif[..., :d], F.logsigmoid(gif[..., d:]), state)
    if mesh is not None:
        hseq = all_gather(hseq, mesh, "model", hseq.dim() - 1, backward="split")
    x = x + hseq.to(x.dtype)
    ffn = p["ffn"]
    fmesh = tp_share(ffn, "ffn", ffn_width(cfg.d_model), cfg)
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if fmesh is not None:
        h2 = enter(h2, fmesh, "model")
    uv = L.linear(ffn["proj_in"], h2)
    f = uv.shape[-1] // 2
    out = L.linear(ffn["proj_out"], F.silu(uv[..., :f]) * uv[..., f:])
    return x + (out if fmesh is None else all_reduce(out, fmesh, "model")), (state, conv_state)


# ------------------------------------------------------------------ model
def init_xlstm(gen: torch.Generator, cfg) -> Dict:
    """A model of ``cfg`` drawn from ``gen`` on its device in ``cfg.dtype``
    (the reference's shapes and scales, not its draws)."""
    dt, dev = _dtype(cfg), gen.device
    groups = [{"m": _init_mlstm(gen, cfg, dt), "s": _init_slstm(gen, cfg, dt)}
              for _ in range(cfg.num_layers // 2)]
    embed = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen, device=dev, dtype=dt) * 0.02
    return {"embed": embed, "groups": groups,
            "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=dev)}


def _stack_states(states):
    """Per-group ``((m-state, mconv), (s-state, sconv))`` → the stacked
    cache entries (without ``pos``)."""
    mst, mconv, sst, sconv = zip(*((ms, mc, ss, sc) for (ms, mc), (ss, sc) in states))
    return {"m": tuple(torch.stack(t) for t in zip(*mst)), "mconv": torch.stack(mconv),
            "s": tuple(torch.stack(t) for t in zip(*sst)), "sconv": torch.stack(sconv)}


def _group(p_g, x: torch.Tensor, cfg):
    """One (mLSTM, sLSTM) group: ``(x, ((m-state, mconv), (s-state, sconv)))``."""
    x, mst = _mlstm_block(p_g["m"], x, cfg)
    x, sst = _slstm_block(p_g["s"], x, cfg)
    return x, (mst, sst)


def _forward(params, tokens: torch.Tensor, cfg, collect_cache: bool = False):
    """All blocks over ``tokens [B, S]``: ``(hidden [B, S, D], cache |
    None)``. Under ``cfg.remat == "block"`` each group is recomputed in the
    backward (:func:`~repro_torch.models.layers.remat_block`)."""
    x = L.embed_tokens(params["embed"], tokens, cfg.vocab_size)
    states = []
    for p_g in params["groups"]:
        x, st = L.remat_block(cfg, _group, p_g, x, cfg)
        states.append(st)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, (_stack_states(states) if collect_cache else None)


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


def decode_step(params, cache, token: torch.Tensor, pos: int, cfg, **_):
    """One token ``token [B, 1]``: ``(cache with every state new and pos +
    1, logits [B, 1, V])``; the states are O(1) in the context."""
    x = L.embed_tokens(params["embed"], token, cfg.vocab_size)
    states = []
    for g, p_g in enumerate(params["groups"]):
        x, mst = _mlstm_block(p_g["m"], x, cfg, state=tuple(t[g] for t in cache["m"]),
                              conv_state=cache["mconv"][g])
        x, sst = _slstm_block(p_g["s"], x, cfg, state=tuple(t[g] for t in cache["s"]),
                              conv_state=cache["sconv"][g])
        states.append((mst, sst))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dict(_stack_states(states), pos=pos + 1), _logits(params, x, cfg)
