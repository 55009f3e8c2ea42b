"""Weight quantizers (paper §3.1 Eq. 3, §3.3 Eqs. 8/9), in torch.

Port of ``repro/core/quantizers.py``: group-wise asymmetric RTN with an
optional HQQ zero-point refinement for 2/3/4-bit weights, sign
binarization for 1 bit (stored in the shared affine form scale = 2α,
zero = 0.5), and packing into :class:`PackedTensor`. Weights are
``W ∈ R[..., K, N]`` with quantization groups along K (dim -2); leading
dims batch independent matrices (one bucket of experts at a time), each
quantized exactly as the reference quantizes a single ``[K, N]``.

Also the per-row int8 KV quantizer of the serving pools
(:func:`quantize_kv_rows` / :func:`dequantize_kv_rows`): Eq. 3 with one
group spanning a KV row's ``head_dim``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .packing import PackedTensor, dequantize_affine, pack_bits, pad_to_multiple

__all__ = [
    "affine_params",
    "dequantize_affine",
    "dequantize_binary",
    "dequantize_kv_rows",
    "hqq_refine",
    "kv_quant_codes",
    "kv_quant_params",
    "pack_codes",
    "quantize_affine",
    "quantize_binary",
    "quantize_kv_rows",
    "quantize_parts",
    "quantize_to_packed",
    "rtn_codes",
]

_PER = {1: 8, 2: 4, 3: 8, 4: 2}


def _group_reshape(w: torch.Tensor, group: int) -> torch.Tensor:
    """[..., K, N] -> [..., K/group, group, N] (zero-pads K if needed)."""
    k = w.shape[-2]
    ngroups = (k + group - 1) // group
    w = pad_to_multiple(w, group, -2)
    return w.reshape(*w.shape[:-2], ngroups, group, w.shape[-1])


#: XLA's CPU backend rewrites an f32 reduction longer than this into
#: windows of this size (``TreeReductionRewriter``)
_XLA_REDUCE_WINDOW = 32


def _xla_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``mean(x, dim)`` in the reference's summation order, so f32 means
    come out byte-identical to XLA's on the CPU.

    XLA sums a reduction of ``n > 32`` elements as a reduce-window of 32
    (zero padding split evenly, the odd element at the high end), each
    window added in order, and then reduces the ``ceil(n/32)`` window sums
    the same way; ``n ≤ 32`` elements add in order. The mean multiplies the
    sum by the f32 reciprocal of ``n`` (XLA folds the division by a
    constant into that product)."""
    n = x.shape[dim]
    x = x.movedim(dim, 0)
    while x.shape[0] > _XLA_REDUCE_WINDOW:
        nw = -(-x.shape[0] // _XLA_REDUCE_WINDOW)
        pad = nw * _XLA_REDUCE_WINDOW - x.shape[0]
        lo = x.new_zeros((pad // 2, *x.shape[1:]))
        hi = x.new_zeros((pad - pad // 2, *x.shape[1:]))
        x = torch.cat([lo, x, hi]).reshape(nw, _XLA_REDUCE_WINDOW, *x.shape[1:])
        acc = x[:, 0].clone()
        for i in range(1, _XLA_REDUCE_WINDOW):
            acc += x[:, i]
        x = acc
    acc = x[0].clone()
    for i in range(1, x.shape[0]):
        acc += x[i]
    return acc * float(np.float32(1.0 / n))


def _xla_lane_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``mean(x, dim)`` of ``n ≤ 32`` elements (``n`` a multiple of 8) in the
    order of the reference's fused HQQ step, whose reduction LLVM's loop
    vectorizer emits over the reduced axis (read from XLA's LLVM IR for
    ``quantizers.py:_hqq_iter``).

    Element ``k`` goes to lane ``k % 8`` of vector ``k // 8``; the vectors
    add lane-wise in order, then the 8 lanes reduce as a halving tree
    (``l + l+4``, ``l + l+2``, ``l + l+1``). For 2 to 8 columns the
    vectorizer keeps a scalar epilogue: the last 8 elements add in order
    after the tree. Any other ``n`` adds in order (:func:`_xla_mean`)."""
    n, cols = x.shape[dim], x.shape[-1]
    if n > _XLA_REDUCE_WINDOW or n % 8:
        return _xla_mean(x, dim)
    x = x.movedim(dim, 0)
    nvec = n // 8 - (1 if 2 <= cols <= 8 else 0)
    if nvec == 0:
        return _xla_mean(x, 0)
    v = x[: 8 * nvec].reshape(nvec, 8, *x.shape[1:])
    acc = v[0].clone()
    for i in range(1, nvec):
        acc += v[i]
    while acc.shape[0] > 1:
        acc = acc[: acc.shape[0] // 2] + acc[acc.shape[0] // 2:]
    acc = acc[0]
    for i in range(8 * nvec, n):
        acc = acc + x[i]
    return acc * float(np.float32(1.0 / n))


def _affine(wmax: torch.Tensor, wmin: torch.Tensor, bits: int):
    """``scale, zero`` from the range, in its dtype, then cast to f32 — the
    reference's Python floats are weak-typed, so a bf16 range rounds to
    bf16 at every step."""
    qmax = 2.0**bits - 1.0
    scale = torch.clamp_min((wmax - wmin) / qmax, 1e-8)
    zero = -wmin / scale
    return scale.float(), zero.float()


def affine_params(w: torch.Tensor, bits: int, group: int = 128):
    """Per-(group, column) ``scale, zero`` ``[..., K/group, N]`` f32 (Eq. 3),
    computed in ``w``'s dtype as the reference does."""
    wg = _group_reshape(w, group)
    return _affine(wg.amax(dim=-2), wg.amin(dim=-2), bits)


def rtn_codes(w, scale, zero, bits: int, group: int = 128) -> torch.Tensor:
    """Round-to-nearest codes ``clamp(round(w/s) + z, 0, 2^b-1)`` (uint8)."""
    wg = _group_reshape(w, group)
    q = torch.round(wg / scale.unsqueeze(-2) + zero.unsqueeze(-2))
    q = torch.clamp(q, 0.0, 2.0**bits - 1.0)
    q = q.reshape(*w.shape[:-2], -1, w.shape[-1])[..., : w.shape[-2], :]
    return q.to(torch.uint8)


def hqq_refine(w, scale, zero, bits: int, group: int = 128, iters: int = 20):
    """Half-quadratic refinement of ``zero`` (HQQ [50], |.|^0.7 shrinkage).

    ``beta`` follows the reference's f32 recurrence exactly (it is carried
    as an f32 scalar there); the zero mean adds in the reference's order
    (:func:`_xla_lane_mean`), so zeros are byte-identical to its own."""
    qmax = 2.0**bits - 1.0
    wg = _group_reshape(w, group)
    beta, kappa, p = np.float32(10.0), np.float32(1.01), 0.7
    s = scale.unsqueeze(-2)
    for _ in range(iters):
        z = zero.unsqueeze(-2)
        q = torch.clamp(torch.round(wg / s + z), 0.0, qmax)
        err = wg - (q - z) * s
        mag = err.abs()
        shrunk = torch.sign(err) * torch.clamp_min(
            mag - (mag ** (p - 1.0) + 1e-8) / float(beta), 0.0
        )
        zero = _xla_lane_mean(q - (wg - shrunk) / s, dim=-2)
        beta = np.float32(beta * kappa)
    return scale, zero


def quantize_affine(w, bits: int, group: int = 128, refine: bool = False):
    """Full RTN affine quantization. Returns ``(codes, scale, zero)``."""
    scale, zero = affine_params(w, bits, group)
    if refine:
        scale, zero = hqq_refine(w, scale, zero, bits, group)
    return rtn_codes(w, scale, zero, bits, group), scale, zero


def quantize_binary(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-bit sign quantization (Eqs. 4/8): ``B~ = (w >= 0)`` and the
    per-column L1 scale ``mean|W[:, j]|`` ``[..., 1, N]`` f32."""
    b01 = (w >= 0).to(torch.uint8)
    return b01, _xla_mean(w.abs(), dim=-2).unsqueeze(-2).float()


def dequantize_binary(b01: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    """``±α`` from the ``{0, 1}`` codes and the per-column scale ``α``."""
    return ((b01.float() * 2.0 - 1.0) * scale).to(dtype)


def pack_codes(codes: torch.Tensor, bits: int):
    """Zero-pad codes ``[..., K, N]`` along K to whole bytes and pack them
    (the ``(hi, lo)`` pair at 3 bits)."""
    return pack_bits(pad_to_multiple(codes, _PER[bits], axis=-2), bits, axis=-2)


def quantize_parts(w: torch.Tensor, bits: int, group: int = 128, refine: bool = True):
    """Quantize + pack ``W[..., K, N]`` → ``(data, scale, zero)`` exactly as
    :func:`quantize_to_packed` (``data`` is the ``(hi, lo)`` pair at 3 bits).

    ``bits == 1`` rides the affine form: scale = 2·α per group row, zero =
    0.5, so ``(q - z)·s = ±α`` (reference ``quantizers.py:239``)."""
    k, n = w.shape[-2:]
    if bits == 1:
        codes, s = quantize_binary(w)
        ngroups = (k + group - 1) // group
        scale = (2.0 * s).expand(*w.shape[:-2], ngroups, n).float().contiguous()
        zero = torch.full_like(scale, 0.5)
    else:
        codes, scale, zero = quantize_affine(w, bits, group, refine=refine)
    return pack_codes(codes, bits), scale.contiguous(), zero.contiguous()


def quantize_to_packed(w: torch.Tensor, bits: int, group: int = 128,
                       refine: bool = True) -> PackedTensor:
    """Quantize ``W[K, N]`` to a :class:`PackedTensor` ready for the kernels
    (GPTQ's pre-computed codes are packed per bucket through
    :func:`pack_codes`, in :func:`~.compressed_moe.build_compressed_experts`)."""
    data, scale, zero = quantize_parts(w, bits, group, refine)
    return PackedTensor(data=data, scale=scale, zero=zero, bits=bits, shape=tuple(w.shape),
                        group=group)


# ----------------------------------------------------- KV-row quantization
# The int8 KV pools store uint8 codes with one affine (scale, zero) pair per
# KV row — per (layer, page, page offset, kv head) — so a row written once
# never needs requantizing and a shared prefix page dequantizes identically
# for every reader. Eq. 3 with the group spanning head_dim.

def kv_quant_params(x: torch.Tensor, bits: int = 8):
    """Per-row ``scale, zero`` over the trailing ``head_dim`` axis: ``x [...,
    dh]`` → two f32 tensors shaped ``x.shape[:-1]``."""
    return _affine(x.amax(dim=-1), x.amin(dim=-1), bits)


def kv_quant_codes(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   bits: int = 8) -> torch.Tensor:
    """RTN codes of KV rows: uint8 shaped like ``x`` (``x / scale`` promotes
    to f32, as in the reference)."""
    q = torch.round(x / scale[..., None] + zero[..., None])
    return torch.clamp(q, 0.0, 2.0**bits - 1.0).to(torch.uint8)


def quantize_kv_rows(x: torch.Tensor, bits: int = 8):
    """``(codes, scale, zero)`` of KV rows ``x [..., dh]``. An all-zero row
    (an unwritten page) round-trips to exactly zero: scale floors at 1e-8,
    zero and codes are 0."""
    scale, zero = kv_quant_params(x, bits)
    return kv_quant_codes(x, scale, zero, bits), scale, zero


def dequantize_kv_rows(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """``(q − z) · s`` in f32 — the exact expression of the int8 paged-attention
    kernel's dequant epilogue, so prefill and decode read a page's rows as
    bit-identical floats."""
    x = codes.float() - zero[..., None].float()
    return (x * scale[..., None].float()).to(dtype)
