"""GPTQ post-training quantization (Frantar et al. [11]) — paper §3.1, in torch.

Port of ``repro/core/gptq.py``: Hessian-based estimation ``H = 2·XᵀX`` plus
column-wise quantization-error compensation, step for step as the
reference's numpy, in f64 on the weight's device. This is an offline
(pre-loading) procedure: the Cholesky factorizations wait on the device,
which is fine here and never happens inside a serving step.

Layout convention: ``W ∈ R[K, N]`` with ``y = x @ W`` (K = input/reduction
dim). GPTQ walks the K axis in order, compensating not-yet-quantized rows.

Affine 2/3/4/8-bit group-wise quantization and 1-bit sign binarization
(per-channel L1 scale, Eq. 4), so every PMQ bit-width {1, 2, 3} flows
through the same error-compensated pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["GPTQResult", "hessian_from_inputs", "gptq_quantize"]

_F64 = torch.float64


@dataclasses.dataclass
class GPTQResult:
    codes: torch.Tensor  # uint8 [K, N] integer codes (binary: {0,1})
    scale: torch.Tensor  # float32 [ceil(K/group), N]
    zero: torch.Tensor  # float32 [ceil(K/group), N]
    bits: int
    group: int
    quant_error: float  # sum of per-row compensated MSE (diagnostic)


def hessian_from_inputs(x: torch.Tensor) -> torch.Tensor:
    """``H = 2·XᵀX`` over calibration activations ``x [nsamples, K]`` (f64)."""
    x = x.to(_F64)
    return 2.0 * (x.T @ x)


def _affine_group_params(wg: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min/max affine params for one K-group ``wg [g, N]`` (Eq. 3)."""
    wmax = wg.amax(dim=0)
    wmin = wg.amin(dim=0)
    qmax = 2.0**bits - 1.0
    scale = torch.clamp_min((wmax - wmin) / qmax, 1e-8)
    zero = -wmin / scale
    return scale, zero


def gptq_quantize(
    w: torch.Tensor,
    hessian: torch.Tensor,
    bits: int,
    group: int = 128,
    percdamp: float = 0.01,
    blocksize: int = 128,
) -> GPTQResult:
    """Quantize ``w [K, N]`` with GPTQ error compensation.

    ``hessian`` is ``H = 2XᵀX`` of shape ``[K, K]``. For ``bits == 1`` the
    quantizer is ``sign`` with per-column scale (L1 mean of the *original*
    weights); codes are the ``{0,1}`` transform of Eq. 8 and ``(scale,
    zero) = (2α, 0.5)`` so the shared affine dequant ``(q - z)·s``
    reproduces ``±α``.
    """
    dev = w.device
    w = w.to(_F64).clone()
    k, n = w.shape
    h = hessian.to(device=dev, dtype=_F64).clone()
    assert h.shape == (k, k)

    # dead rows: never-activated inputs contribute nothing — freeze them
    dead = torch.diagonal(h) == 0
    h[dead, dead] = 1.0
    w[dead, :] = 0.0

    # dampen + inverse via Cholesky, then upper Cholesky of the inverse
    damp = percdamp * float(torch.diagonal(h).mean())
    h.diagonal().add_(max(damp, 1e-10))
    l_inv0 = torch.linalg.inv(torch.linalg.cholesky(h))
    hinv = l_inv0.T @ l_inv0  # H^-1 = L^-T L^-1
    hinv_u = torch.linalg.cholesky(hinv).T  # upper-triangular U with UᵀU = H^-1

    qmax = 2.0**bits - 1.0
    codes = torch.zeros((k, n), dtype=torch.uint8, device=dev)
    ngroups = (k + group - 1) // group
    scales = torch.zeros((ngroups, n), dtype=torch.float32, device=dev)
    zeros = torch.zeros((ngroups, n), dtype=torch.float32, device=dev)

    if bits == 1:
        alpha = w.abs().mean(dim=0, keepdim=True)
        scales[:] = (2.0 * alpha).float()
        zeros[:] = 0.5

    total_err = torch.zeros((), dtype=_F64, device=dev)
    for b0 in range(0, k, blocksize):
        b1 = min(b0 + blocksize, k)
        wb = w[b0:b1, :].clone()
        errb = torch.zeros_like(wb)
        qb = torch.empty_like(wb)  # the block's codes, stored once per block
        diffb = torch.empty_like(wb)  # wb - wq per row, summed once per block
        hu = hinv_u[b0:b1, b0:b1]
        for i in range(b1 - b0):
            kk = b0 + i
            g = kk // group
            if bits != 1 and kk % group == 0:
                # params from the error-compensated weights of this group
                g1 = min(kk + group, k)
                wg = torch.cat([wb[i:min(i + group, b1 - b0), :], w[b1:g1, :]], dim=0)
                s_g, z_g = _affine_group_params(wg, bits)
                scales[g] = s_g.float()
                zeros[g] = z_g.float()
            if kk % group == 0:  # this group's parameters, in f64
                s = scales[g].to(_F64)
                z = zeros[g].to(_F64)
            if bits == 1:
                q = (wb[i, :] >= 0).to(_F64)
            else:
                q = torch.clamp(torch.round(wb[i, :] / s + z), 0.0, qmax)
            qb[i] = q
            diff = torch.sub(wb[i, :], (q - z) * s, out=diffb[i])
            err = torch.div(diff, hu[i, i], out=errb[i])
            # compensate the remaining rows of this block
            if i + 1 < b1 - b0:
                wb[i + 1:, :] -= torch.outer(hu[i, i + 1:], err)
        codes[b0:b1] = qb.to(torch.uint8)
        total_err += torch.sum(diffb ** 2)
        # lazy batch update of all rows after the block
        if b1 < k:
            w[b1:, :] -= hinv_u[b0:b1, b1:].T @ errb
    return GPTQResult(codes=codes, scale=scales, zero=zeros, bits=bits, group=group,
                      quant_error=float(total_err))
