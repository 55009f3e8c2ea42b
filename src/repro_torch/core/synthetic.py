"""Decoders built on the device from a seed: a PMQ + OTP compressed MoE
(:func:`build_synthetic`), and a dense, VLM-backbone or uncompressed MoE one
(:func:`build_uncompressed`).

No weights can be downloaded, so serving at a model's full width starts
from random weights. ``build_uncompressed`` draws ``init_lm``'s normal
weights (``repro/models/transformer.py:63``) in the config's dtype one
tensor at a time, each generated in f32 and rounded at once, so no f32 or
host copy of the whole tree is ever made (the uncompressed
``moonshot-v1-16b-a3b`` is 28.9 B parameters, 57.8 GB in bf16).
``build_synthetic`` composes the reference pieces and adds no new
behaviour:

* ``init_lm``-style normal weights (``repro/models/transformer.py:63``)
  from one ``torch.Generator``, generated and quantized **one layer at a
  time** so the float weights of two layers never coexist;
* attention and shared-expert projections through ``quantize_to_packed`` at
  ``cfg.quant.attn_bits`` (4) with HQQ refinement, as
  ``quantize_tree_uniform`` does (``repro/core/pipeline.py:267``);
* a layer-uniform expert bit plan over {1, 2, 3} from the bucket-count
  search of ``synthetic_stacked_compressed`` (``pipeline.py:314``) with
  ep = 1 and the ``compress_for_serving`` target of 2.05 bits, the experts
  assigned to widths by a seeded permutation, buckets built by
  :func:`build_compressed_experts`, each expert matrix drawn just before it
  is packed (one layer of ``kimi-k2-1t-a32b``'s experts is 33.8 GB in bf16:
  drawn at once, they do not leave room on an 80 GB card);
* a random OTP router per layer, shaped as ``init_otp_router``
  (``repro/core/otp.py:48``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .compressed_moe import BucketMeta, CompressedExperts, build_compressed_experts
from .quantizers import quantize_to_packed

__all__ = ["TARGET_AVG_BITS", "bucket_counts", "build_synthetic", "build_uncompressed",
           "synthetic_compressed_experts"]

#: average expert bits of the plan (``compress_for_serving``'s default)
TARGET_AVG_BITS = 2.05


def bucket_counts(num_experts: int) -> Tuple[int, int, int]:
    """``(n1, n2, n3)`` experts at 1/2/3 bits with ≥ 1 each, average bits
    closest to :data:`TARGET_AVG_BITS` (first best on ties, as the
    reference search)."""
    e = num_experts
    best, best_err = None, float("inf")
    for n1 in range(1, e):
        for n3 in range(1, e - n1):
            n2 = e - n1 - n3
            err = abs((n1 + 2 * n2 + 3 * n3) / e - TARGET_AVG_BITS)
            if err < best_err:
                best, best_err = (n1, n2, n3), err
    if best is None:
        raise ValueError(f"a 1/2/3-bit plan needs at least 3 experts, got {e}")
    return best


def _normal(gen, shape, scale, dtype, device):
    """``normal(shape) · scale`` generated in f32, rounded to ``dtype`` first
    (as ``jax.random.normal(key, shape, dtype) * scale``)."""
    return torch.randn(shape, generator=gen, device=device).to(dtype) * scale


def build_synthetic(cfg, *, seed: int = 0, device="cuda", ep: int = 1) -> Dict:
    """Params of ``cfg`` (all ``cfg.num_layers`` layers) in the layout of
    :mod:`repro_torch.models.transformer`, built on ``device``; buckets
    padded to multiples of ``ep`` (``build_compressed_experts``). The draws
    do not depend on ``ep`` or on the depth: a cut build is the first layers
    of a deeper one."""
    if cfg.family != "moe" or cfg.num_experts < 3:
        raise ValueError("build_synthetic makes PMQ MoE decoders (≥ 3 experts)")
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    d, e, f, k = cfg.d_model, cfg.num_experts, cfg.d_ff_expert, cfg.top_k
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = cfg.quant
    n1, n2, n3 = bucket_counts(e)
    perm = torch.randperm(e, generator=gen, device=device).cpu()
    bits = torch.empty(e, dtype=torch.int64)
    bits[perm] = torch.tensor([1] * n1 + [2] * n2 + [3] * n3)

    def packed(k_in, n_out, dtype=dt):
        w = _normal(gen, (k_in, n_out), k_in**-0.5, dtype, device)
        return {"w": quantize_to_packed(w, q.attn_bits, group=q.group, refine=True)}

    params = {
        "embed": _normal(gen, (cfg.vocab_size, d), 0.02, dt, device),
        "final_norm": torch.zeros(d, dtype=dt, device=device),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _normal(gen, (cfg.vocab_size, d), 0.02, dt, device)
    fs = f * cfg.num_shared_experts
    for _ in range(cfg.num_layers):
        layer = {
            "ln1": torch.zeros(d, dtype=dt, device=device),
            "attn": {"wq": packed(d, hq * dh), "wk": packed(d, hkv * dh),
                     "wv": packed(d, hkv * dh), "wo": packed(hq * dh, d)},
            "ln2": torch.zeros(d, dtype=dt, device=device),
            "moe": {"router": {"w": _normal(gen, (d, e), d**-0.5, torch.float32, device)}},
        }
        if cfg.num_shared_experts:
            layer["moe"]["shared"] = {
                "w_gate": packed(d, fs), "w_up": packed(d, fs), "w_down": packed(fs, d),
            }
        # each expert matrix drawn when its turn to be packed comes (the
        # stream's order), so one is alive at a time
        experts = {
            "w_gate": lambda: _normal(gen, (e, d, f), d**-0.5, dt, device),
            "w_up": lambda: _normal(gen, (e, d, f), d**-0.5, dt, device),
            "w_down": lambda: _normal(gen, (e, f, d), f**-0.5, dt, device),
        }
        layer["moe_ce"] = build_compressed_experts(experts, bits.tolist(), group=q.group, ep=ep)
        layer["otp"] = {
            "fc1": _normal(gen, (d, k), d**-0.5, torch.float32, device),
            "fc2": _normal(gen, (2 * k, k), (2 * k) ** -0.5, torch.float32, device),
        }
        params["layers"].append(layer)
    return params



def build_uncompressed(cfg, *, seed: int = 0, device="cuda") -> Dict:
    """Params of a dense or VLM-backbone (``mlp``) or uncompressed MoE
    (``moe``: router, ``[E, ·, ·]`` expert stacks, shared experts) decoder
    with all ``cfg.num_layers`` layers, in the layout of
    :mod:`repro_torch.models.transformer`, built on ``device``: the shapes
    and scales of ``init_lm`` (``1/√fan_in`` linears, an f32 router, 0.02
    embeddings, zero norms)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"build_uncompressed makes dense, MoE and VLM-backbone decoders, got "
                         f"{cfg.family!r}")
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads

    def linear(k_in, n_out):
        return {"w": _normal(gen, (k_in, n_out), k_in**-0.5, dt, device)}

    def mlp(f):
        return {"w_gate": linear(d, f), "w_up": linear(d, f), "w_down": linear(f, d)}

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=device)

    params = {"embed": _normal(gen, (cfg.vocab_size, d), 0.02, dt, device),
              "final_norm": zeros(d), "layers": []}
    if not cfg.tie_embeddings:
        params["unembed"] = _normal(gen, (cfg.vocab_size, d), 0.02, dt, device)
    for _ in range(cfg.num_layers):
        attn = {"wq": linear(d, hq * dh), "wk": linear(d, hkv * dh), "wv": linear(d, hkv * dh),
                "wo": linear(hq * dh, d)}
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = zeros(dh), zeros(dh)
        layer = {"ln1": zeros(d), "attn": attn, "ln2": zeros(d)}
        if cfg.is_moe:
            e, f = cfg.num_experts, cfg.d_ff_expert
            layer["moe"] = {
                "router": {"w": _normal(gen, (d, e), d**-0.5, torch.float32, device)},
                "experts": {
                    "w_gate": _normal(gen, (e, d, f), d**-0.5, dt, device),
                    "w_up": _normal(gen, (e, d, f), d**-0.5, dt, device),
                    "w_down": _normal(gen, (e, f, d), f**-0.5, dt, device),
                },
            }
            if cfg.num_shared_experts:
                layer["moe"]["shared"] = mlp(f * cfg.num_shared_experts)
        else:
            layer["mlp"] = mlp(cfg.d_ff)
        params["layers"].append(layer)
    return params


def synthetic_compressed_experts(cfg, target_avg_bits: float = 2.25, ep: int = 16,
                                 device="meta") -> List[CompressedExperts]:
    """One zero-filled :class:`CompressedExperts` per layer, the same bucket
    structure in each: the port's counterpart of the reference's stacked
    ``synthetic_stacked_compressed`` (``repro/core/pipeline.py:314``), on
    ``device`` (``meta``: shapes only). Bucket counts are multiples of
    ``ep`` (1 where it does not divide the experts), the sizes on that grid
    whose average bits come closest to ``target_avg_bits``; scales and
    zeros bf16, ``slot_of_expert`` the identity."""
    e = cfg.num_experts
    if e % ep:
        ep = 1
    best, best_err = None, float("inf")
    for n1 in range(ep, e - ep + 1, ep):
        for n3 in range(ep, e - n1 - ep + 1, ep):
            n2 = e - n1 - n3
            err = abs((n1 + 2 * n2 + 3 * n3) / e - target_avg_bits)
            if err < best_err:
                best, best_err = (n1, n2, n3), err
    d, f, group = cfg.d_model, cfg.d_ff_expert, cfg.quant.group

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def layer() -> CompressedExperts:
        meta, arrays, start = [], {}, 0
        for bits, cnt in zip((1, 2, 3), best):
            if cnt == 0:
                continue
            bucket = {}
            for name, (k, n) in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))):
                ng = -(-k // group)
                entry = {"scale": zeros((cnt, ng, n), torch.bfloat16),
                         "zero": zeros((cnt, ng, n), torch.bfloat16)}
                if bits == 3:
                    entry["hi"] = zeros((cnt, k // 4, n), torch.uint8)
                    entry["lo"] = zeros((cnt, k // 8, n), torch.uint8)
                else:
                    entry["data"] = zeros((cnt, k // (8 // bits), n), torch.uint8)
                bucket[name] = entry
            arrays[f"b{len(meta)}"] = bucket
            meta.append(BucketMeta(bits=bits, start=start, count=cnt))
            start += cnt
        return CompressedExperts(meta=tuple(meta),
                                 slot_of_expert=torch.arange(e, dtype=torch.int32, device=device),
                                 arrays=arrays, num_slots=start, group=group, d_model=d, d_ff=f)

    return [layer() for _ in range(cfg.num_layers)]
