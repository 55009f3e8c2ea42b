"""A PMQ + OTP compressed MoE decoder built on the device from a seed.

No weights can be downloaded, so serving at a model's full width starts
from random weights. This composes the reference pieces and adds no new
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
  :func:`build_compressed_experts`;
* a random OTP router per layer, shaped as ``init_otp_router``
  (``repro/core/otp.py:48``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .compressed_moe import build_compressed_experts
from .quantizers import quantize_to_packed

__all__ = ["TARGET_AVG_BITS", "bucket_counts", "build_synthetic"]

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


def build_synthetic(cfg, *, seed: int = 0, device="cuda") -> Dict:
    """Params of ``cfg`` (all ``cfg.num_layers`` layers) in the layout of
    :mod:`repro_torch.models.transformer`, built on ``device``."""
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
        experts = {
            "w_gate": _normal(gen, (e, d, f), d**-0.5, dt, device),
            "w_up": _normal(gen, (e, d, f), d**-0.5, dt, device),
            "w_down": _normal(gen, (e, f, d), f**-0.5, dt, device),
        }
        layer["moe_ce"] = build_compressed_experts(experts, bits.tolist(), group=q.group)
        del experts
        layer["otp"] = {
            "fc1": _normal(gen, (d, k), d**-0.5, torch.float32, device),
            "fc2": _normal(gen, (2 * k, k), (2 * k) ** -0.5, torch.float32, device),
        }
        params["layers"].append(layer)
    return params

