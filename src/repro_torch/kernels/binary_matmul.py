"""``binary_matmul``: ``y = (x @ (2·unpack(b_packed) − 1)) · alpha`` (paper
Eq. 9) — the wrapper of the Hopper kernel in ``csrc/binary_matmul.cu``
(port of ``repro/kernels/binary_matmul.py:48 binary_matmul_pallas``).

``x [M, K]`` f32 or bf16; ``b_packed [ceil(K/8), N]`` uint8 (bit ``i`` of
byte ``r`` is row ``8r + i``); ``alpha [1, N]`` f32. No model path calls
it, in the port as in the reference (1-bit experts ride ``moe_gmm`` in the
affine form scale = 2α, zero = 0.5). A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import ref
from .build import DTYPE_CODES, LAUNCHES, check, load_library, stream_ptr
from .quant_matmul import ptr, require

__all__ = ["binary_matmul"]


def binary_matmul(x: torch.Tensor, b_packed: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.binary_matmul_ref(x, b_packed, alpha)
    name = "binary_matmul"
    require(x.device.type == "cuda", f"{name}: unsupported device {x.device}")
    require(x.dim() == 2 and x.dtype in DTYPE_CODES, f"{name}: x must be 2-D f32 or bf16")
    m, k = x.shape
    n = b_packed.shape[-1]
    require(b_packed.dtype == torch.uint8 and tuple(b_packed.shape) == (-(-k // 8), n),
            f"{name}: b_packed {tuple(b_packed.shape)} != {(-(-k // 8), n)} uint8")
    require(alpha.dtype == torch.float32 and tuple(alpha.shape) == (1, n),
            f"{name}: alpha must be float32 [1, N]")
    for t in (x, b_packed, alpha):
        require(t.device == x.device and t.is_contiguous(),
                f"{name}: operands must be contiguous on one device")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    rc = load_library().repro_binary_matmul(ptr(x), ptr(b_packed), ptr(alpha), ptr(y), m, k, n,
                                            DTYPE_CODES[x.dtype], stream_ptr(x))
    check(rc, name)
    LAUNCHES[name] += 1
    return y
