"""End-to-end MC# compression pipeline (paper Fig. 3), in torch.

Port of ``repro/core/pipeline.py`` for a materialized MoE model in the
port's per-layer layout (``{"embed", "final_norm", ["unembed"], "layers":
[...]}``, see :mod:`repro_torch.models.transformer`), on the model's device:

1. **Calibration capture** — forward over the layers recording router
   statistics (phi, w) and each MoE layer's input activations (f32, kept on
   the device).
2. **Significance** — ``eps[L, E, |bits|]`` per Eq. 6 (layer-output F-norm
   with one expert fake-quantized at a time).
3. **PMQ allocation** — Eq. 7 via :mod:`repro_torch.core.pmq`.
4. **GPTQ** — per-(expert, matrix) Hessians from the expert's routed
   tokens; error-compensated quantization at the allocated width (f64).
5. **Assembly** — bit-bucketed :class:`CompressedExperts` per layer + 4-bit
   HQQ-refined RTN for attention and the shared experts; the router stays
   as it is.

The compressed model evaluates through :func:`compressed_forward` (the
argmax OTP mask when routers are given, or Gumbel-sampled masks with
gradients for OTP training, :mod:`repro_torch.core.otp_train`), and
:func:`compress_for_serving` gives the layer-uniform
tree the serving engine takes. The reference's dry-run helper
(``synthetic_stacked_compressed``) has its counterpart in
:mod:`repro_torch.core.synthetic`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import layers as L
from ..models.moe import moe_layer, route_topk
from ..models.transformer import layer_windows_static
from . import otp as otp_mod, pmq, significance
from .compressed_moe import CompressedExperts, build_compressed_experts, compressed_moe_layer
from .gptq import gptq_quantize, hessian_from_inputs
from .packing import PackedTensor
from .quantizers import quantize_to_packed

__all__ = [
    "EPS_TOKENS",
    "TARGET_AVG_BITS",
    "CalibrationResult",
    "calibrate",
    "compress_for_serving",
    "compress_model",
    "compressed_forward",
    "compressed_logits",
    "compute_eps",
    "model_weight_bytes",
    "quantize_tree_uniform",
    "run_pmq",
]

_NAMES = ("w_gate", "w_up", "w_down")
#: the serving compression's settings (the reference's ``compress_for_serving``
#: defaults, which its serving CLI keeps)
TARGET_AVG_BITS, EPS_TOKENS = 2.05, 128


# ----------------------------------------------------------- calibration
@dataclasses.dataclass
class CalibrationResult:
    moe_inputs: List[torch.Tensor]  # per layer [B·S, D] f32 (inputs to MoE), on the device
    phi: np.ndarray  # [L, E]
    w: np.ndarray  # [L, E]
    hidden_final: torch.Tensor  # [T, D] f32 (for distillation targets)


def _attn_part(p_l, x, cfg, window: int):
    """Attention half of a block: ``x`` after it."""
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    h = L.rms_norm(x, p_l["ln1"], cfg.norm_eps)
    a, _ = L.attention(p_l["attn"], h, cfg, positions=pos, causal=True, window=window)
    return x + a


def _block_parts(p_l, x, cfg, window: int):
    """Attention half of a block; returns ``(x_after_attn, h_pre_ffn)``."""
    x = _attn_part(p_l, x, cfg, window)
    return x, L.rms_norm(x, p_l["ln2"], cfg.norm_eps)


def _moe_part(p_l, x, cfg, otp_params, otp_rng, otp_tau: float):
    """The compressed MoE half of a block: ``(x after it, its OTP mask or
    None)``."""
    h = L.rms_norm(x, p_l["ln2"], cfg.norm_eps)
    y, info = compressed_moe_layer(p_l["moe"], p_l["moe_ce"], h, cfg, otp_params=otp_params,
                                   otp_rng=otp_rng, otp_tau=otp_tau)
    return x + y, info["mask"]


@torch.no_grad()
def calibrate(params, tokens: torch.Tensor, cfg) -> CalibrationResult:
    """Run calibration batches ``tokens [B, S]`` through the fp model,
    capturing MoE inputs and router statistics (paper §3.2.2)."""
    assert cfg.is_moe, "calibration targets MoE archs"
    x = L.embed_tokens(params["embed"], tokens)
    windows = layer_windows_static(cfg, tokens.shape[1])
    stats = [significance.RouterStats(cfg.num_experts) for _ in params["layers"]]
    moe_inputs = []
    for l, p_l in enumerate(params["layers"]):
        x, h2 = _block_parts(p_l, x, cfg, int(windows[l]))
        moe_inputs.append(h2.reshape(-1, cfg.d_model).float())
        out = moe_layer(p_l["moe"], h2, cfg)
        stats[l].update(out.topk_idx.cpu().numpy(), out.topk_gates.cpu().numpy())
        x = x + out.y
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return CalibrationResult(
        moe_inputs=moe_inputs,
        phi=np.stack([s.phi for s in stats]),
        w=np.stack([s.w for s in stats]),
        hidden_final=x.reshape(-1, cfg.d_model).float(),
    )


# ----------------------------------------------------------- eps (Eq. 6)
def _fake_quant(w: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    return quantize_to_packed(w, bits, group=group, refine=False).dequantize(torch.float32)


@torch.no_grad()
def compute_eps(params, calib: CalibrationResult, cfg,
                eps_tokens: int = EPS_TOKENS) -> np.ndarray:
    """``eps[L, E, |bits|]`` via Eq. 6 on the first ``eps_tokens`` captured
    calibration inputs, at ``cfg.quant``'s bit choices and group.

    The inputs are f32, so (as in the reference, where jnp promotes the
    experts) the layer runs in f32: each layer's experts are upcast once,
    expert ``i``'s fake-quantized weights are written over its rows for one
    forward and the upcast originals written back, so only the perturbed
    expert differs and the stack is never rebuilt."""
    q = cfg.quant
    eps = np.zeros((cfg.num_layers, cfg.num_experts, len(q.bit_choices)))
    for l, p_l in enumerate(params["layers"]):
        h2 = calib.moe_inputs[l][:eps_tokens][None]  # [1, T, D]
        experts = p_l["moe"]["experts"]
        f32 = {k: experts[k].to(torch.float32, copy=True) for k in _NAMES}
        moe_p = dict(p_l["moe"], experts=f32)
        if "shared" in moe_p:  # cast once, not per call (the cast is exact)
            moe_p["shared"] = {k: {"w": v["w"].float()} for k, v in moe_p["shared"].items()}

        def layer_forward(sub):
            if sub is None:
                return moe_layer(moe_p, h2, cfg).y
            i, weights = sub
            for k in _NAMES:
                f32[k][i].copy_(weights[k])
            try:
                return moe_layer(moe_p, h2, cfg).y
            finally:
                for k in _NAMES:
                    f32[k][i].copy_(experts[k][i])

        eps[l] = significance.expert_eps(
            layer_forward, cfg.num_experts,
            lambda i, b: {k: _fake_quant(experts[k][i], b, q.group) for k in _NAMES},
            q.bit_choices,
        )
        del f32, moe_p
    return eps


# ------------------------------------------------------------------- PMQ
def run_pmq(calib: CalibrationResult, eps: np.ndarray, cfg, target_avg_bits: float,
            solver: str = "dp") -> pmq.PMQPlan:
    """The PMQ plan (Eq. 7) over the calibration's router statistics and the
    Eq. 6 table ``eps`` from :func:`compute_eps`."""
    q = cfg.quant
    return pmq.allocate_model(
        calib.phi, calib.w, eps, target_avg_bits,
        alpha=q.alpha, beta=q.beta, gamma=q.gamma,
        bit_choices=q.bit_choices, solver=solver,
    )


# ---------------------------------------------------------------- GPTQ
def _routed_inputs(h2: torch.Tensor, idx: torch.Tensor, expert: int) -> torch.Tensor:
    x = h2[(idx == expert).any(dim=1)]
    if x.shape[0] < 8:  # never-routed expert: fall back to all tokens
        x = h2
    return x


def _gptq_expert(ew: Dict, x: torch.Tensor, bits: int, group: int) -> Dict:
    """GPTQ all three matrices of one expert given its routed inputs (f64)."""
    hg = hessian_from_inputs(x)
    res = {name: gptq_quantize(ew[name], hg, bits, group) for name in ("w_gate", "w_up")}
    # down-proj sees silu(xWg)*(xWu)
    a = x @ ew["w_gate"].double()
    a = a / (1.0 + torch.exp(-a)) * (x @ ew["w_up"].double())
    res["w_down"] = gptq_quantize(ew["w_down"], hessian_from_inputs(a), bits, group)
    return res


@torch.no_grad()
def compress_model(params, calib: CalibrationResult, plan: pmq.PMQPlan, cfg,
                   use_gptq: bool = True, consume: bool = False, ep: int = 1):
    """The compressed blocks, layer by layer: ``(blocks_c, top)`` where
    ``blocks_c[l]`` holds ``{"ln1", "attn", "ln2", "moe" (router, 4-bit
    shared), "moe_ce"}`` and ``top`` the embeddings and final norm (16-bit,
    as in the paper's average-bit accounting). Layer ``l`` reads
    ``calib.moe_inputs[l]`` and ``plan.bits[l]``. ``consume=True`` drops each
    layer from ``params["layers"]`` once it is compressed, so a full-width
    model never holds a layer's float and packed weights past that layer.
    ``ep`` pads each bucket to a multiple of it (``build_compressed_experts``)."""
    q = cfg.quant
    blocks_c = []
    for l in range(len(params["layers"])):
        p_l = params["layers"][l]
        experts = p_l["moe"]["experts"]
        gptq_results = None
        if use_gptq:
            h2 = calib.moe_inputs[l].double()
            # routing of calibration tokens under the fp router
            _, idx, _ = route_topk(p_l["moe"]["router"], h2.float(), cfg.top_k)
            gptq_results = {}
            for i in range(cfg.num_experts):
                res = _gptq_expert({k: experts[k][i] for k in _NAMES},
                                   _routed_inputs(h2, idx, i), int(plan.bits[l][i]), q.group)
                for name, r in res.items():
                    gptq_results[(i, name)] = r
        moe_p = {"router": p_l["moe"]["router"]}
        if "shared" in p_l["moe"]:
            moe_p["shared"] = quantize_tree_uniform(p_l["moe"]["shared"], q.attn_bits, q.group)
        blocks_c.append({
            "ln1": p_l["ln1"],
            "attn": quantize_tree_uniform(p_l["attn"], q.attn_bits, q.group),
            "ln2": p_l["ln2"],
            "moe": moe_p,
            "moe_ce": build_compressed_experts({k: (lambda k=k: experts[k]) for k in _NAMES},
                                               plan.bits[l], group=q.group, ep=ep,
                                               gptq_results=gptq_results),
        })
        if consume:
            params["layers"][l] = None
        del p_l, experts, gptq_results
    top = {"embed": params["embed"], "final_norm": params["final_norm"]}
    if "unembed" in params:
        top["unembed"] = params["unembed"]
    return blocks_c, top


def compress_for_serving(params, calib: CalibrationResult, cfg, *,
                         eps: Optional[np.ndarray] = None,
                         consume: bool = False, ep: int = 1) -> Tuple[Dict, float]:
    """Layer-uniform PMQ compression in the serving layout, at
    :data:`TARGET_AVG_BITS` over an Eq. 6 table on :data:`EPS_TOKENS` tokens.

    The PMQ plan is made layer-uniform (every layer gets layer 0's bit
    vector), so all layers share one bucket structure, as the reference's
    stacked decode scan requires. Returns ``(params_compressed, avg_bits)``
    with ``params_compressed`` in the engine's layout (``{"embed",
    "final_norm", ["unembed"], "layers"}``, no OTP routers). ``eps`` reuses
    that table if the caller has it (else it is computed here); ``consume``
    and ``ep`` as in :func:`compress_model`."""
    if eps is None:
        eps = compute_eps(params, calib, cfg)
    plan = run_pmq(calib, eps, cfg, TARGET_AVG_BITS)
    plan.bits = [plan.bits[0]] * cfg.num_layers
    blocks_c, top = compress_model(params, calib, plan, cfg, use_gptq=False, consume=consume,
                                   ep=ep)
    return dict(top, layers=blocks_c), plan.avg_bits


def quantize_tree_uniform(tree, bits: int, group: int):
    """Replace every 2-D ``w`` leaf with a PackedTensor (HQQ-refined RTN)."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out[key] = quantize_tree_uniform(leaf, bits, group)
        elif key == "w" and isinstance(leaf, torch.Tensor) and leaf.dim() == 2:
            out[key] = quantize_to_packed(leaf, bits, group=group, refine=True)
        else:
            out[key] = leaf
    return out


# ----------------------------------------------------- compressed forward
def compressed_forward(blocks_c, top, tokens: torch.Tensor, cfg,
                       otp_params: Optional[List] = None, otp_rngs: Optional[List] = None,
                       otp_tau: float = 1.0, collect_masks: bool = False):
    """Layer-by-layer forward of the compressed model → ``(hidden, masks)``:
    the final hidden states and, with ``collect_masks``, each layer's OTP
    mask ``[T, k]``. ``otp_params[l]`` applies layer ``l``'s router: its
    argmax mask, or with ``otp_rngs[l]`` (uniforms ``[T, k]`` or a
    generator) a Gumbel sample at temperature ``otp_tau``.

    The argmax forward runs without autograd, as inference does; the Gumbel
    branch records the graph, so the routers (the only tensors that
    require grad) receive the Eq. 14 gradients. Under ``cfg.remat ==
    "block"`` each layer's attention half and MoE half are recomputed in the
    backward, each for its own (the transformer's ``_block``; a generator's
    uniforms are drawn before the MoE half, ``otp.fixed_uniforms``; the
    reference's loop here checkpoints nothing but its attention chunks)."""
    with torch.set_grad_enabled(otp_rngs is not None and torch.is_grad_enabled()):
        x = L.embed_tokens(top["embed"], tokens)
        windows = layer_windows_static(cfg, tokens.shape[1])
        masks = []
        for l, p_l in enumerate(blocks_c):
            x = L.remat_block(cfg, _attn_part, p_l, x, cfg, int(windows[l]))
            op = otp_params[l] if otp_params is not None else None
            rng = otp_rngs[l] if otp_rngs is not None else None
            if op is not None:
                rng = otp_mod.fixed_uniforms(rng, x.shape[0] * x.shape[1], cfg.top_k, x.device)
            x, mask = L.remat_block(cfg, _moe_part, p_l, x, cfg, op, rng, otp_tau)
            if collect_masks and mask is not None:
                masks.append(mask)
        return L.rms_norm(x, top["final_norm"], cfg.norm_eps), masks


def compressed_logits(blocks_c, top, tokens, cfg, **kw):
    """``(logits [B, S, V] f32, masks)`` of :func:`compressed_forward`."""
    hidden, masks = compressed_forward(blocks_c, top, tokens, cfg, **kw)
    emb = top.get("unembed", top["embed"])
    return torch.einsum("btd,vd->btv", hidden.float(), emb.float()), masks


def model_weight_bytes(blocks_c, top) -> int:
    """Total compressed weight bytes (packed sizes for quantized leaves; a
    bucket layer counts its arrays, as the reference's ``weight_bytes``)."""

    def walk(node) -> int:
        if isinstance(node, PackedTensor):
            return node.nbytes
        if isinstance(node, CompressedExperts):
            return node.weight_bytes
        if isinstance(node, torch.Tensor):
            return node.numel() * node.element_size()
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, list):
            return sum(walk(v) for v in node)
        return 0

    return walk(blocks_c) + walk(top)
