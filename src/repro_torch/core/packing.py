"""Bit-packing for ultra-low-bit weight storage (paper §3.3), in torch.

The layout is byte-for-byte the reference's (``repro/core/packing.py``):
codes ``q ∈ [0, 2^b)`` are packed along the reduction axis K — 8 codes per
byte at 1 bit, 4 at 2 bits, 2 at 4 bits — with code ``k`` in byte
``k // per`` at shift ``(k % per) · bits``. 3-bit codes are a 2-bit plane
plus a 1-bit plane, ``q = (hi << 1) | lo``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["PackedTensor", "pack_bits", "pad_to_multiple", "unpack_bits"]


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to a multiple of ``multiple``."""
    axis = axis % x.ndim
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _pack_pow2(q: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    per = 8 // bits
    q = q.to(torch.uint8)
    axis = axis % q.ndim
    if q.shape[axis] % per != 0:
        raise ValueError(
            f"axis {axis} size {q.shape[axis]} not a multiple of {per} "
            f"for {bits}-bit packing; call pad_to_multiple first"
        )
    q = q.reshape(q.shape[:axis] + (q.shape[axis] // per, per) + q.shape[axis + 1:])
    q = q & ((1 << bits) - 1)
    packed = q.select(axis + 1, 0).clone()
    for i in range(1, per):
        packed |= q.select(axis + 1, i) << (i * bits)
    return packed


def _unpack_pow2(packed: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    per = 8 // bits
    axis = axis % packed.ndim
    shifts = (torch.arange(per, dtype=torch.uint8, device=packed.device) * bits).reshape(
        (1,) * (axis + 1) + (per,) + (1,) * (packed.ndim - axis - 1)
    )
    vals = (packed.unsqueeze(axis + 1) >> shifts) & ((1 << bits) - 1)
    return vals.reshape(
        packed.shape[:axis] + (packed.shape[axis] * per,) + packed.shape[axis + 1:]
    )


def pack_bits(q: torch.Tensor, bits: int, axis: int = -1):
    """Pack integer codes: one uint8 tensor for bits in {1, 2, 4}, or the
    ``(hi_plane, lo_plane)`` pair for bits == 3."""
    if bits in (1, 2, 4):
        return _pack_pow2(q, bits, axis)
    if bits == 3:
        q = q.to(torch.uint8)
        return (_pack_pow2((q >> 1) & 0x3, 2, axis), _pack_pow2(q & 0x1, 1, axis))
    raise ValueError(f"unsupported bit-width {bits}")


def unpack_bits(packed, bits: int, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_bits` (uint8 codes)."""
    if bits in (1, 2, 4):
        return _unpack_pow2(packed, bits, axis)
    if bits == 3:
        hi_p, lo_p = packed
        return (_unpack_pow2(hi_p, 2, axis) << 1) | _unpack_pow2(lo_p, 1, axis)
    raise ValueError(f"unsupported bit-width {bits}")


def _tensors(data):
    return tuple(data) if isinstance(data, tuple) else (data,)


@dataclasses.dataclass
class PackedTensor:
    """A bit-packed quantized ``[K, N]`` weight + its dequantization params.

    ``data`` is the packed uint8 tensor ``[K/per, N]`` (or the ``(hi, lo)``
    planes for 3 bits); ``scale``/``zero`` are ``[K/group, N]`` f32, groups
    along the packed axis K (axis 0 of the logical shape — the only packing
    the port's kernels read).
    """

    data: object
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    shape: Tuple[int, ...]  # logical (unpacked) shape
    group: int

    def to(self, device) -> "PackedTensor":
        data = tuple(t.to(device) for t in self.data) if self.bits == 3 else self.data.to(device)
        return dataclasses.replace(
            self, data=data, scale=self.scale.to(device), zero=self.zero.to(device)
        )

    @property
    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in (*_tensors(self.data), self.scale, self.zero)
        )
