"""Spec-level builders of quantized and compressed parameter trees (port of
``repro/launch/specs.py``), in the port's per-layer layout.

The reference builds stacked pytrees of ``ShapeDtypeStruct`` leaves under
``jax.eval_shape``; here the same trees hold tensors on the ``meta``
device (``concrete=False``: shapes and dtypes, no allocation) or
zero-filled tensors (``concrete=True``, on ``device``):

* the PMQ-compressed MoE LM (:func:`make_compressed_moe_params`): 4-bit
  :class:`PackedTensor` attention and shared experts, an f32 router, one
  zero :class:`CompressedExperts` per layer
  (:func:`~repro_torch.core.synthetic.synthetic_compressed_experts`);
* the OTP routers (:func:`make_otp_stacked`), one ``{"fc1", "fc2"}`` per
  layer;
* a dense tree quantized uniformly at ``attn_bits``
  (:func:`quantize_dense_param_tree`, the paper's "Uni" baseline).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.packing import PackedTensor
from ..core.synthetic import synthetic_compressed_experts

__all__ = ["make_compressed_moe_params", "make_otp_stacked", "quantize_dense_param_tree"]

_PER = {1: 8, 2: 4, 3: 8, 4: 2, 8: 1}


def _packed(k: int, n: int, bits: int, group: int, device) -> PackedTensor:
    """A zero :class:`PackedTensor` of the logical ``[k, n]`` weight (bf16
    scales and zeros, as the reference's spec)."""
    if bits == 3:
        data = (torch.zeros((k // 4, n), dtype=torch.uint8, device=device),
                torch.zeros((k // 8, n), dtype=torch.uint8, device=device))
    else:
        data = torch.zeros((k // _PER[bits], n), dtype=torch.uint8, device=device)
    ng = -(-k // group)
    return PackedTensor(data=data, scale=torch.zeros((ng, n), dtype=torch.bfloat16, device=device),
                        zero=torch.zeros((ng, n), dtype=torch.bfloat16, device=device),
                        bits=bits, shape=(k, n), group=group)


def make_compressed_moe_params(cfg, avg_bits: float = 2.25, with_otp: bool = False,
                               concrete: bool = False, device="cuda") -> Dict:
    """The compressed LM's tree: on the meta device, or zero-filled on
    ``device`` with ``concrete``."""
    dev = device if concrete else "meta"
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ab, g = cfg.quant.attn_bits, cfg.quant.group
    ces = synthetic_compressed_experts(cfg, avg_bits, device=dev)
    otp = make_otp_stacked(cfg, concrete=True, device=dev) if with_otp else None
    layers = []
    for l in range(cfg.num_layers):
        attn = {"wq": {"w": _packed(d, hq * dh, ab, g, dev)},
                "wk": {"w": _packed(d, hkv * dh, ab, g, dev)},
                "wv": {"w": _packed(d, hkv * dh, ab, g, dev)},
                "wo": {"w": _packed(hq * dh, d, ab, g, dev)}}
        if cfg.qk_norm:
            attn["q_norm"] = torch.zeros(dh, dtype=dt, device=dev)
            attn["k_norm"] = torch.zeros(dh, dtype=dt, device=dev)
        moe = {"router": {"w": torch.zeros((d, cfg.num_experts), dtype=torch.float32,
                                           device=dev)}}
        if cfg.num_shared_experts:
            f = cfg.d_ff_expert * cfg.num_shared_experts
            moe["shared"] = {"w_gate": {"w": _packed(d, f, ab, g, dev)},
                             "w_up": {"w": _packed(d, f, ab, g, dev)},
                             "w_down": {"w": _packed(f, d, ab, g, dev)}}
        layer = {"ln1": torch.zeros(d, dtype=dt, device=dev), "attn": attn,
                 "ln2": torch.zeros(d, dtype=dt, device=dev), "moe": moe, "moe_ce": ces[l]}
        if otp is not None:
            layer["otp"] = otp[l]
        layers.append(layer)
    params = {"embed": torch.zeros((cfg.vocab_size, d), dtype=dt, device=dev), "layers": layers,
              "final_norm": torch.zeros(d, dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = torch.zeros((cfg.vocab_size, d), dtype=dt, device=dev)
    return params


def make_otp_stacked(cfg, concrete: bool = True, device="cuda") -> List[Dict]:
    """One zero OTP router ``{"fc1" [D, k], "fc2" [2k, k]}`` (f32) per
    layer, on ``device`` (or the meta device without ``concrete``)."""
    dev = device if concrete else "meta"
    d, k = cfg.d_model, cfg.top_k
    return [{"fc1": torch.zeros((d, k), dtype=torch.float32, device=dev),
             "fc2": torch.zeros((2 * k, k), dtype=torch.float32, device=dev)}
            for _ in range(cfg.num_layers)]


def quantize_dense_param_tree(param_spec, cfg):
    """``param_spec`` with every 2-D ``w`` leaf whose ``K`` is a multiple of
    the quant group and of 8 a zero :class:`PackedTensor` at
    ``cfg.quant.attn_bits`` on the leaf's device (embeddings stay 16-bit,
    as the paper counts them)."""
    ab, g = cfg.quant.attn_bits, cfg.quant.group

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name != "w" or not isinstance(node, torch.Tensor) or node.dim() != 2:
            return node
        k, n = node.shape
        if k % g or k % 8:
            return node
        return _packed(k, n, ab, g, node.device)

    return walk(param_spec)

