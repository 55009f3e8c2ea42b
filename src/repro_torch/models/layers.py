"""Shared layers of the port (``repro/models/layers.py`` in torch).

Weights are ``[K_in, N_out]`` (``y = x @ W``), so a :class:`PackedTensor`
leaf substitutes 1:1 and routes through ``ops.quant_matmul``. Activations
are ``[B, S, D]``, attention heads ``[B, S, H, dh]``. Every ``init_*``
draws from an explicit ``torch.Generator`` on the generator's device.

Under a mesh (``parallel.sharding.sharding_rules``) a rank that holds its
share of a tensor-parallel pair (cut by ``parallel.ep_shardmap.shard_params``
under ``parallel.sharding.tp_split``, found by ``tp_share``) runs that
share — its heads, its columns of ``w_gate``/``w_up`` — enters it through
``enter`` (its input's gradient summed over
``model``) and ``all_reduce``s the partial product of ``wo`` / ``w_down``
over ``model``. A whole pair runs whole, as without a mesh. The streaming
losses sum over the batch axes, so under a mesh they are the global
batch's, as the reference's are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.packing import PackedTensor
from ..kernels import ops
from ..launch.counting import checkpoint, scan
from ..parallel.sharding import (all_gather, all_reduce, batch_axes, current_mesh, enter,
                                 tp_share, vocab_share)

__all__ = [
    "apply_rope",
    "attend",
    "attention",
    "chunked_kl",
    "chunked_xent",
    "decode_attention",
    "embed_tokens",
    "init_attention",
    "init_linear",
    "init_mlp",
    "linear",
    "logits",
    "mlp",
    "remat_block",
    "rms_norm",
    "sinusoidal_positions",
]

NEG_INF = -1e30


def init_linear(gen: torch.Generator, k: int, n: int, dtype=torch.float32,
                scale: Optional[float] = None):
    """``{"w": N(0, 1) · scale}`` of shape ``[k, n]`` (scale ``k^-1/2``
    unless given), drawn in ``dtype``."""
    scale = scale if scale is not None else 1.0 / (k ** 0.5)
    return {"w": torch.randn(k, n, generator=gen, device=gen.device, dtype=dtype) * scale}


def init_attention(gen: torch.Generator, cfg, dtype=torch.float32):
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": init_linear(gen, d, hq * dh, dtype), "wk": init_linear(gen, d, hkv * dh, dtype),
         "wv": init_linear(gen, d, hkv * dh, dtype), "wo": init_linear(gen, hq * dh, d, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(dh, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros(dh, dtype=dtype, device=gen.device)
    return p


def init_mlp(gen: torch.Generator, d: int, f: int, dtype=torch.float32):
    return {"w_gate": init_linear(gen, d, f, dtype), "w_up": init_linear(gen, d, f, dtype),
            "w_down": init_linear(gen, f, d, dtype)}


def linear(p, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    if isinstance(w, PackedTensor):
        return ops.quant_matmul(x, w)
    return x @ w.to(x.dtype)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """``embed[tokens]``. Under a mesh, an ``embed`` holding this rank's
    rows of a ``vocab``-row table (:func:`~repro_torch.parallel.sharding.vocab_share`)
    looks up the tokens it holds, zeroes the others and sums the ranks'
    rows over ``model``: each token's gradient lands on its owner's rows."""
    mesh = vocab_share(embed, vocab)
    if mesh is None:
        return embed[tokens]
    rows = embed.shape[0]
    local = tokens - mesh.index("model") * rows
    mine = (local >= 0) & (local < rows)
    out = embed[torch.where(mine, local, 0)] * mine[..., None].to(embed.dtype)
    return all_reduce(out, mesh, "model")


def logits(x: torch.Tensor, emb: torch.Tensor, vocab: Optional[int] = None) -> torch.Tensor:
    """``x @ embᵀ`` in f32 (``[..., V]``). Under a mesh, an ``emb`` holding
    this rank's vocabulary rows gives its columns, gathered over ``model``
    into the whole vocabulary in the single process's order."""
    mesh = vocab_share(emb, vocab)
    if mesh is None:
        return torch.matmul(x.float(), emb.float().t())
    part = torch.matmul(enter(x, mesh, "model").float(), emb.float().t())
    return all_gather(part, mesh, "model", part.dim() - 1, backward="split")


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


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings ``[..., d]`` (f32) of ``positions``
    (whisper): ``sin`` then ``cos`` of ``pos · exp(-log(10000) · i /
    max(d/2 - 1, 1))``."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    log_base = torch.log(torch.tensor(10000.0, device=positions.device))  # in f32
    freq = torch.exp(-log_base * i / max(half - 1, 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _q_only(p, x, cfg, positions, rope: bool = True):
    b, s, _ = x.shape
    q = linear(p["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta) if rope else q


def _qkv(p, x, cfg, positions, rope: bool = True):
    q = _q_only(p, x, cfg, positions, rope)
    k, v = _kv_only(p, x, cfg, positions, rope)
    return q, k, v


def _kv_only(p, x, cfg, positions, rope: bool = True):
    """K/V projection without the query — paged prefill writes K/V itself
    and lets :func:`attention`'s cross-attention path own q."""
    b, s, _ = x.shape
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    k = linear(p["wk"], x).reshape(b, s, hkv, dh)
    v = linear(p["wv"], x).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (apply_rope(k, positions, cfg.rope_theta) if rope else k), v


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


def _sweep_start(q):
    """A q chunk's scaled f32 queries and online-softmax state ``(m, l,
    acc)``."""
    b, qc, hkv, g, dh = q.shape
    return q.float() * dh**-0.5, (torch.full((b, hkv, g, qc), NEG_INF, device=q.device),
                                  torch.zeros((b, hkv, g, qc), device=q.device),
                                  torch.zeros((b, hkv, g, qc, dh), device=q.device))


def _sweep_chunk(m, l, acc, k, v, q32, q_pos, kv_pos, *, causal, window):
    """The state after one kv chunk ``k/v [B, kc, Hkv, dh]``."""
    kc, vc = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kc)
    mask = _mask_chunk(q_pos, kv_pos, causal, window)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
    return m_new, l, acc


def _sweep_end(l, acc, dtype):
    """The chunk's output ``[B, qc, Hkv, G, dh]`` in ``dtype``."""
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).to(dtype)


def _chunks(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` with ``dim`` cut into chunks of ``size`` rows, the chunk index
    first (a view): a :func:`~repro_torch.launch.counting.scan`'s ``xs``."""
    return t.unflatten(dim, (t.shape[dim] // size, size)).movedim(dim, 0)


def _online_attn(q, k, v, q_pos, kv_pos, *, causal, window, kv_chunk, dtype):
    """One q chunk against kv chunks with an online softmax (f32), each kv
    chunk's scores and probabilities recomputed in the backward, never kept
    (the reference's checkpointed scan body).

    ``q [B, qc, Hkv, G, dh]``; ``k/v [B, Skv, Hkv, dh]``, ``Skv`` whole kv
    chunks. Returns ``[B, qc, Hkv, G, dh]`` in ``dtype``.
    """
    def chunk(j, st, k, v, q32):
        c0 = j * kv_chunk
        return _sweep_chunk(*st, k, v, q32, q_pos, kv_pos[c0:c0 + kv_chunk], causal=causal,
                            window=window), None

    q32, state = _sweep_start(q)
    (_, l, acc), _ = scan(k.shape[1] // kv_chunk, chunk, state, (q32,),
                          xs=(_chunks(k, 1, kv_chunk), _chunks(v, 1, kv_chunk)), remat=True)
    return _sweep_end(l, acc, dtype)


def _pad_rows(x: torch.Tensor, pad: int, dim: int, value=0) -> torch.Tensor:
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim=dim)


def _tp_attention(p, cfg):
    """``(mesh, p, cfg)`` for a rank holding its heads of a split attention
    under a mesh (:func:`~repro_torch.parallel.sharding.tp_share`) — ``p``'s
    shared norms entered, ``cfg``'s head counts this rank's — or None for a
    whole one."""
    mesh = tp_share(p, "attn", cfg.num_heads * cfg.head_dim, cfg)
    if mesh is None:
        return None
    model = mesh.shape["model"]
    p = dict(p, **{n: enter(p[n], mesh, "model") for n in ("q_norm", "k_norm") if n in p})
    return mesh, p, dataclasses.replace(cfg, num_heads=cfg.num_heads // model,
                                        num_kv_heads=cfg.num_kv_heads // model)


def attention(p, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
              causal: bool = True, window: Optional[int] = None, rope: bool = True):
    """Full-sequence attention (``layers.py:245``): the q-chunk × kv-chunk
    online-softmax sweep. ``kv_override = (k, v, kv_pos)`` (``kv_pos < 0``
    marks padding) makes it cross-attention onto given rows, as paged
    prefill and whisper's decoder do; without it ``x`` gives q, k and v at
    ``positions``. ``rope=False`` leaves q and k unrotated (whisper's
    absolute positions). Returns ``(out [B, S, D] after wo, (k, v))`` — k/v
    for cache builds (this rank's KV heads under tensor parallelism)."""
    tp = _tp_attention(p, cfg)
    if tp is not None:
        mesh, p, cfg = tp
        out, kv = attention(p, enter(x, mesh, "model"), cfg, positions=positions,
                            kv_override=kv_override, causal=causal, window=window, rope=rope)
        return all_reduce(out, mesh, "model"), kv
    if kv_override is not None:
        q = _q_only(p, x, cfg, positions, rope)
        k, v, kv_pos = kv_override
    else:
        q, k, v = _qkv(p, x, cfg, positions, rope)
        kv_pos = positions if positions.dim() == 1 else positions[0]
    q_pos = positions if positions.dim() == 1 else positions[0]
    out = attend(q, k, v, q_pos, kv_pos, cfg, causal=causal, window=window, dtype=x.dtype)
    return linear(p["wo"], out), (k, v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
           kv_pos: torch.Tensor, cfg, *, causal: bool, window: Optional[int],
           dtype: torch.dtype) -> torch.Tensor:
    """:func:`attention` between its projections: ``q [B, S, Hq, dh]``
    against ``k``/``v`` ``[B, Skv, Hkv, dh]`` at positions ``q_pos [S]`` and
    ``kv_pos [Skv]`` (``< 0`` padding), swept in q chunks × kv chunks with an
    online softmax. Returns the heads ``[B, S, Hq·dh]`` in ``dtype``, before
    ``wo``. The backward is the reference's flash-style one in every mode:
    each q chunk keeps only its output (its sweep recomputed), and each kv
    chunk's scores are recomputed again in the sweep's backward."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qc = min(cfg.attn_q_chunk, s)
    kvc = min(cfg.attn_kv_chunk, k.shape[1])
    s_pad = (-s) % qc
    q = _pad_rows(q, s_pad, 1)
    q_pos = _pad_rows(q_pos, s_pad, 0, value=-1)
    kv_pad = (-k.shape[1]) % kvc
    k = _pad_rows(k, kv_pad, 1)
    v = _pad_rows(v, kv_pad, 1)
    kv_pos = _pad_rows(kv_pos, kv_pad, 0, value=-1)
    sq = s + s_pad
    q5 = q.reshape(b, sq, hkv, g, dh)

    def q_chunk(i, _, q, k, v):
        i0 = i * qc
        return (), _online_attn(q, k, v, q_pos[i0:i0 + qc], kv_pos, causal=causal,
                                window=window, kv_chunk=kvc, dtype=dtype)

    _, out = scan(sq // qc, q_chunk, (), (k, v), stack=1, xs=(_chunks(q5, 1, qc),), remat=True)
    return out.reshape(b, sq, hq * dh)[:, :s]


def decode_attention(p, x: torch.Tensor, cfg, *, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, window: Optional[int] = None,
                     rope: bool = True, cross: bool = False, kv_len: Optional[int] = None):
    """Single-step attention (``layers.py:312``): ``x [B, 1, D]`` against
    the dense cache ``[B, S, Hkv, dh]``. Self-attention writes the new k/v
    at ``pos`` (in place) before attending over positions ``≤ pos`` (and
    ``> pos − window``). Cross-attention (``cross=True``) reads the cache
    only, over positions ``≤ kv_len − 1`` (all ``S`` without ``kv_len``),
    with no window and no rotation of q. Returns ``(out [B, 1, D],
    (k_cache, v_cache))``; under tensor parallelism the caches hold this
    rank's KV heads."""
    tp = _tp_attention(p, cfg)
    if tp is not None:
        mesh, p, cfg = tp
        out, kv = decode_attention(p, enter(x, mesh, "model"), cfg, k_cache=k_cache,
                                   v_cache=v_cache, pos=pos, window=window, rope=rope,
                                   cross=cross, kv_len=kv_len)
        return all_reduce(out, mesh, "model"), kv
    b = x.shape[0]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = hq // hkv
    s = k_cache.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cross:
        q = _q_only(p, x, cfg, positions, rope=False)
        limit = (kv_len if kv_len is not None else s) - 1
    else:
        q, k_new, v_new = _qkv(p, x, cfg, positions, rope)
        k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
        limit = pos
    q32 = q.reshape(b, hkv, g, dh).float() * dh**-0.5
    scores = torch.einsum("bhgd,bshd->bhgs", q32, k_cache.float())
    kv_pos = torch.arange(s, device=x.device)
    valid = kv_pos <= limit
    if window is not None and not cross:
        valid &= kv_pos > pos - window
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w, v_cache.float())
    out = out.reshape(b, 1, hq * dh).to(x.dtype)
    return linear(p["wo"], out), (k_cache, v_cache)


def mlp(p, x: torch.Tensor, d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU feed-forward. Under a mesh, a rank holding its share of the
    layer's ``d_ff`` columns (:func:`~repro_torch.parallel.sharding.tp_share`)
    runs it and sums the partial products over ``model``."""
    mesh = tp_share(p, "mlp", d_ff) if d_ff is not None else None
    if mesh is not None:
        xe = enter(x, mesh, "model")
        h = F.silu(linear(p["w_gate"], xe)) * linear(p["w_up"], xe)
        return all_reduce(linear(p["w_down"], h), mesh, "model")
    return linear(p["w_down"], F.silu(linear(p["w_gate"], x)) * linear(p["w_up"], x))


def remat_block(cfg, fn, *args):
    """``fn(*args)``, one block of a layer loop, under ``cfg.remat``: with
    ``"block"`` (the full configs' default) its intermediates are recomputed
    in the backward (:func:`~repro_torch.launch.counting.checkpoint`, the
    reference's ``jax.checkpoint`` of its scanned layer body), so a training
    step keeps each block's inputs and outputs only; any other value keeps
    them all, as the reference's ``"none"`` does."""
    if cfg.remat == "block":
        return checkpoint(fn, *args)
    return fn(*args)


# ------------------------------------------------------------------- loss
def _divisor_chunk(s: int, chunk: int) -> int:
    """Largest divisor of ``s`` that is ≤ chunk (streaming chunk size)."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


#: vocabulary rows of a bf16 table cast to f32 at a time by the loss chunks'
#: logits where no product with an f32 result from bf16 operands runs
#: (the CPU), and by their backward everywhere
VOCAB_BLOCK = 8192


class _WideLogits(torch.autograd.Function):
    """``h @ wᵀ`` in f32 of ``h [N, D]`` and a table ``w [V, D]`` in one
    narrower dtype, with no f32 copy of the table: on the card (and on
    ``meta``, as the card runs it) one product of the narrow operands with
    an f32 result, elsewhere :data:`VOCAB_BLOCK` rows cast at a time. The
    backward — ``g @ w`` and ``gᵀ @ h`` in f32, each cast to its operand's
    dtype — casts the table by blocks as well."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.device.type in ("cuda", "meta"):
            return torch.ops.aten.mm.dtype(h, w.t(), torch.float32)
        out = h.new_empty((h.shape[0], w.shape[0]), dtype=torch.float32)
        hf = h.float()
        for v0 in range(0, w.shape[0], VOCAB_BLOCK):
            out[:, v0:v0 + VOCAB_BLOCK] = hf @ w[v0:v0 + VOCAB_BLOCK].float().t()
        return out

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        hf = h.float()
        gh = torch.zeros_like(hf)
        gw = torch.empty_like(w)
        for v0 in range(0, w.shape[0], VOCAB_BLOCK):
            gb = g[:, v0:v0 + VOCAB_BLOCK]
            gh.addmm_(gb, w[v0:v0 + VOCAB_BLOCK].float())
            gw[v0:v0 + VOCAB_BLOCK] = (gb.t() @ hf).to(w.dtype)
        return gh.to(h.dtype), gw


def _chunk_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ wᵀ`` in f32 from operands in ``w``'s dtype (the reference's
    einsum with an f32 result; bf16 products are exact in f32). A bf16
    table is never copied whole to f32 (the reference keeps it bf16, as a
    global f32 cast would gather it): :class:`_WideLogits`."""
    if w.dtype == torch.float32:
        return torch.matmul(h.float(), w.t())
    lead = h.shape[:-1]
    return _WideLogits.apply(h.to(w.dtype).reshape(-1, h.shape[-1]), w).reshape(*lead, w.shape[0])


def _xent_chunk(h, w, y):
    logits = _chunk_logits(h, w)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, torch.clamp_min(y, 0).long()[..., None])[..., 0]
    valid = (y >= 0).float()
    return ((lse - picked) * valid).sum(), valid.sum()


def _xent_shard_chunk(h, w, y):
    """This rank's vocabulary columns of a chunk: their log-sum-exp and the
    label's logit where this rank holds the label (``y`` counted from the
    rank's first row), else 0."""
    logits = _chunk_logits(h, w)
    mine = (y >= 0) & (y < w.shape[0])
    picked = torch.gather(logits, -1, torch.where(mine, y, 0).long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1), picked * mine.to(picked.dtype)


def _global_lse(lse: torch.Tensor, mesh, backward: str) -> torch.Tensor:
    """The log-sum-exp over the whole vocabulary from the ranks' shards'
    (``backward`` the gather's: ``"split"`` where what it feeds is the same
    on every rank, ``"reduce_scatter"`` where each rank's share of the
    vocabulary reads it)."""
    parts = all_gather(lse[..., None], mesh, "model", lse.dim(), backward=backward)
    return torch.logsumexp(parts, dim=-1)


def chunked_xent(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512, vocab: Optional[int] = None) -> torch.Tensor:
    """Streaming softmax cross-entropy over sequence chunks, never holding
    ``[B, S, V]``: ``hidden [B, S, D]``, ``emb [V, D]`` (output projection
    ``embᵀ``), ``labels [B, S]`` (−1 = ignore). Mean NLL over the valid
    positions; each chunk's logits are recomputed in the backward pass.
    Under a mesh, an ``emb`` holding this rank's rows of a ``vocab``-row
    table computes over its shard: the log-sum-exp from the ranks' shards'
    (gathered over ``model``), the label's logit from the rank that holds
    it (summed over ``model``)."""
    s = hidden.shape[1]
    chunk = _divisor_chunk(s, chunk)
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    vmesh = vocab_share(emb, vocab)
    if vmesh is not None:
        hidden = enter(hidden, vmesh, "model")
    for c0 in range(0, s, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if vmesh is None:
            t, c = checkpoint(_xent_chunk, h, emb, y)
        else:
            v0 = vmesh.index("model") * emb.shape[0]
            lse, picked = checkpoint(_xent_shard_chunk, h, emb, torch.where(y >= 0, y - v0, -1))
            nll = _global_lse(lse, vmesh, "split") - all_reduce(picked, vmesh, "model")
            valid = (y >= 0).float()
            t, c = (nll * valid).sum(), valid.sum()
        tot, cnt = tot + t, cnt + c
    mesh = current_mesh()
    if mesh is not None:
        tot, cnt = all_reduce(tot, mesh, batch_axes(mesh)), all_reduce(cnt, mesh, batch_axes(mesh))
    return tot / torch.clamp_min(cnt, 1.0)


def _kl_chunk(a, t, w):
    ls = torch.log_softmax(_chunk_logits(a, w), dim=-1)
    lt = torch.log_softmax(_chunk_logits(t, w), dim=-1)
    return torch.sum(torch.exp(lt) * (lt - ls))


def _lse_pair(a, t, w):
    return (torch.logsumexp(_chunk_logits(a, w), dim=-1),
            torch.logsumexp(_chunk_logits(t, w), dim=-1))


def _kl_shard_chunk(a, t, w, lse_s, lse_t):
    """This rank's vocabulary columns' terms of the chunk's KL, given the
    whole vocabulary's log-sum-exps."""
    ls = _chunk_logits(a, w) - lse_s[..., None]
    lt = _chunk_logits(t, w) - lse_t[..., None]
    return torch.sum(torch.exp(lt) * (lt - ls))


def chunked_kl(hidden_s: torch.Tensor, hidden_t: torch.Tensor, emb: torch.Tensor,
               chunk: int = 512, vocab: Optional[int] = None) -> torch.Tensor:
    """Streaming ``KL(teacher ‖ student)`` over the vocabulary, mean over
    positions, never holding ``[B, S, V]`` (the OTP distillation loss,
    Eq. 14's first term, from hidden states). Under a mesh, an ``emb``
    holding this rank's rows of a ``vocab``-row table takes the log-sum-exps
    from the ranks' shards' and sums its columns' terms over ``model``."""
    b, s, _ = hidden_s.shape
    chunk = _divisor_chunk(s, chunk)
    tot = torch.zeros((), device=hidden_s.device)
    vmesh = vocab_share(emb, vocab)
    if vmesh is not None:
        hidden_s, hidden_t = enter(hidden_s, vmesh, "model"), enter(hidden_t, vmesh, "model")
    for c0 in range(0, s, chunk):
        hs, ht = hidden_s[:, c0:c0 + chunk], hidden_t[:, c0:c0 + chunk]
        if vmesh is None:
            tot = tot + checkpoint(_kl_chunk, hs, ht, emb)
            continue
        lse_s, lse_t = (_global_lse(v, vmesh, "reduce_scatter")
                        for v in checkpoint(_lse_pair, hs, ht, emb))
        tot = tot + all_reduce(checkpoint(_kl_shard_chunk, hs, ht, emb, lse_s, lse_t), vmesh,
                               "model")
    mesh = current_mesh()
    if mesh is not None:
        tot = all_reduce(tot, mesh, batch_axes(mesh))
        b = b * mesh.extent(batch_axes(mesh))
    return tot / (b * s)
