"""Weight quantizers (paper §3.1 Eq. 3, §3.3 Eqs. 8/9), in torch.

Port of ``repro/core/quantizers.py``: group-wise asymmetric RTN with an
optional HQQ zero-point refinement for 2/3/4-bit weights, sign
binarization for 1 bit (stored in the shared affine form scale = 2α,
zero = 0.5), and packing into :class:`PackedTensor`. Weights are
``W ∈ R[..., K, N]`` with quantization groups along K (dim -2); leading
dims batch independent matrices (one bucket of experts at a time), each
quantized exactly as the reference quantizes a single ``[K, N]``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .packing import PackedTensor, pack_bits, pad_to_multiple

__all__ = [
    "affine_params",
    "hqq_refine",
    "quantize_affine",
    "quantize_binary",
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


def affine_params(w: torch.Tensor, bits: int, group: int = 128):
    """Per-(group, column) ``scale, zero`` ``[..., K/group, N]`` f32 (Eq. 3),
    computed in ``w``'s dtype as the reference does."""
    wg = _group_reshape(w, group)
    wmax = wg.amax(dim=-2)
    wmin = wg.amin(dim=-2)
    qmax = 2.0**bits - 1.0
    scale = torch.clamp_min((wmax - wmin) / qmax, 1e-8)
    zero = -wmin / scale
    return scale.float(), zero.float()


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
    as an f32 scalar there)."""
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
        zero = torch.mean(q - (wg - shrunk) / s, dim=-2)
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
    return b01, w.abs().mean(dim=-2, keepdim=True).float()


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
    codes = pad_to_multiple(codes, _PER[bits], axis=-2)
    return pack_bits(codes, bits, axis=-2), scale.contiguous(), zero.contiguous()


def quantize_to_packed(w: torch.Tensor, bits: int, group: int = 128,
                       refine: bool = True) -> PackedTensor:
    """Quantize ``W[K, N]`` to a :class:`PackedTensor` ready for the kernels
    (GPTQ's pre-computed codes arrive with the compression-pipeline slice)."""
    data, scale, zero = quantize_parts(w, bits, group, refine)
    return PackedTensor(data=data, scale=scale, zero=zero, bits=bits, shape=tuple(w.shape),
                        group=group)
