"""``quant_matmul``: ``y[M, N] = x[M, K] @ dq(W_packed)`` — the wrapper of
the Hopper kernel in ``csrc/quant_matmul.cu`` (port of
``repro/kernels/quant_matmul.py:99 quant_matmul_pallas``).

A CPU tensor takes the plain version (:func:`ref.quant_matmul_ref`); a
CUDA tensor launches the kernel or raises. Also home of the operand checks
the grouped kernels share.
"""
from __future__ import annotations

import torch

from . import ref
from .build import DTYPE_CODES, LAUNCHES, check, load_library, stream_ptr

__all__ = ["quant_matmul"]

_PER = {1: 8, 2: 4, 4: 2}


def planes(w_packed, bits: int):
    """The packed operand as ``(p0, p1)``: the uint8 tensor and ``None``,
    or the 3-bit ``(hi, lo)`` plane pair."""
    if bits == 3:
        hi, lo = w_packed
        return hi, lo
    if bits not in _PER:
        raise ValueError(f"kernels take bits 1/2/3/4, got {bits}")
    return w_packed, None


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_operand(name, w_packed, scale, zero, *, bits, group, k, n, lead, device):
    """Validate one packed weight stack ``[*lead, K/per, N]`` (3-bit: hi
    ``[*lead, K/4, N]``, lo ``[*lead, K/8, N]``) and its ``[*lead, K/g, N]``
    f32 scale/zero before its pointers reach the kernel."""
    p0, p1 = planes(w_packed, bits)
    shapes = ((p0, k // 4), (p1, k // 8)) if bits == 3 else ((p0, k // _PER[bits]),)
    for t, rows in shapes:
        require(t.dtype == torch.uint8, f"{name}: packed weights must be uint8")
        require(tuple(t.shape) == (*lead, rows, n),
                f"{name}: packed plane {tuple(t.shape)} != {(*lead, rows, n)}")
    for t in (scale, zero):
        require(t.dtype == torch.float32, f"{name}: scale/zero must be float32")
        require(tuple(t.shape) == (*lead, k // group, n),
                f"{name}: scale/zero {tuple(t.shape)} != {(*lead, k // group, n)}")
    for t in (p0, p1, scale, zero):
        if t is None:
            continue
        require(t.device == device, f"{name}: operands on different devices")
        require(t.is_contiguous(), f"{name}: operands must be contiguous")
    return p0, p1


def check_activations(name, x, *, group):
    require(x.dim() == 2, f"{name}: x must be 2-D, got {tuple(x.shape)}")
    require(x.dtype in DTYPE_CODES, f"{name}: x must be float32 or bfloat16")
    require(x.is_contiguous(), f"{name}: x must be contiguous")
    require(group % 16 == 0 and 16 <= group <= 256,
            f"{name}: group must be a multiple of 16 in [16, 256], got {group}")
    require(x.shape[1] % group == 0,
            f"{name}: K={x.shape[1]} must be a multiple of group={group}")


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def quant_matmul(x: torch.Tensor, w_packed, scale, zero, *, bits: int,
                 group: int = 128) -> torch.Tensor:
    """``x [M, K]`` @ dequant of ``w_packed [K/per, N]`` → ``[M, N]`` in x's dtype."""
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, w_packed, scale, zero, bits=bits, group=group)
    require(x.device.type == "cuda", f"quant_matmul: unsupported device {x.device}")
    check_activations("quant_matmul", x, group=group)
    m, k = x.shape
    n = (w_packed[0] if bits == 3 else w_packed).shape[-1]
    p0, p1 = check_operand("quant_matmul", w_packed, scale, zero, bits=bits, group=group,
                           k=k, n=n, lead=(), device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    rc = load_library().repro_quant_matmul(
        ptr(x), ptr(p0), ptr(p1), ptr(scale), ptr(zero), ptr(y), m, k, n, bits, group,
        DTYPE_CODES[x.dtype], stream_ptr(x),
    )
    check(rc, "quant_matmul")
    LAUNCHES["quant_matmul"] += 1
    return y
