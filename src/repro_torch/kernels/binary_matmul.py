"""``binary_matmul``: ``y = (x @ (2·unpack(b_packed) − 1)) · alpha`` (paper
Eq. 9) — the wrapper of the Hopper kernel in ``csrc/binary_matmul.cu``
(port of ``repro/kernels/binary_matmul.py:49 binary_matmul_pallas``).

``x [M, K]`` f32 or bf16; ``b_packed [ceil(K/8), N]`` uint8 (bit ``i`` of
byte ``r`` is row ``8r + i``); ``alpha [1, N]`` f32. No model path calls
it, in the port as in the reference (1-bit experts ride ``moe_gmm`` in the
affine form scale = 2α, zero = 0.5). A CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises; a ``meta`` tensor is counted
(:func:`binary_matmul_work`). bf16 x runs a tensor-core
kernel whose tiling is :func:`binary_plan`; f32 x keeps IEEE f32 products
on CUDA cores.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from ..launch.counting import Work, count_meta, nbytes
from .build import DTYPE_CODES, LAUNCHES, check, load_library, stream_ptr
from .quant_matmul import COL_TILE, SMEM_OPTIN, WARPS, ptr, require

__all__ = ["binary_matmul", "binary_matmul_work", "binary_plan"]

#: the bf16 kernel's row tile (the MMA's N)
ROWS = 8


@functools.lru_cache(maxsize=None)
def binary_plan(k: int, n: int) -> dict:
    """The tiling of the bf16 kernel in ``csrc/binary_matmul.cu`` for these
    static shapes (no M: a row's arithmetic never depends on how many rows
    there are). One block per (8-row block, 16-column tile) stages the
    tile's ``k_steps · 2`` packed rows and its x rows; ``k_slices`` are the
    warps' ranges of k16 steps, added in warp order before alpha;
    ``smem_bytes`` mirrors the kernel's ``Layout`` (the C function
    ``repro_binary_matmul_smem`` reports the kernel's own)."""
    kx = -(-k // 16) * 16
    steps = kx // 16
    spw = -(-steps // WARPS)
    x_stride = kx + 2 * ((8 - (kx // 2) % 32) % 32)
    smem = kx // 8 * COL_TILE + ROWS * x_stride * 2 + WARPS * ROWS * COL_TILE * 4
    return {"rows": ROWS, "col_tile": COL_TILE, "warps": WARPS, "n_tiles": -(-n // COL_TILE),
            "k_steps": steps,
            "k_slices": [(w * spw, min(steps, (w + 1) * spw)) for w in range(WARPS)],
            "smem_bytes": smem}


def binary_matmul_work(x: torch.Tensor, b_packed: torch.Tensor, alpha: torch.Tensor) -> Work:
    """One launch's work: ``2·M·K·N`` in x's dtype; x, the packed bits and
    alpha read once, ``y [M, N]`` written once."""
    m, k = x.shape
    n = b_packed.shape[-1]
    return Work(nbytes(x, b_packed, alpha) + m * n * x.element_size(), 2 * m * k * n, x.dtype)


def binary_matmul(x: torch.Tensor, b_packed: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    if x.device.type == "meta":
        count_meta("binary_matmul", binary_matmul_work(x, b_packed, alpha))
        return x.new_empty((x.shape[0], b_packed.shape[-1]))
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
    if x.dtype == torch.bfloat16:
        smem = binary_plan(k, n)["smem_bytes"]
        require(smem <= SMEM_OPTIN, f"{name}: K too long for the bf16 kernel's whole-K staging "
                                    f"({smem} bytes of shared memory > {SMEM_OPTIN})")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    rc = load_library().repro_binary_matmul(ptr(x), ptr(b_packed), ptr(alpha), ptr(y), m, k, n,
                                            DTYPE_CODES[x.dtype], stream_ptr(x))
    check(rc, name)
    LAUNCHES[name] += 1
    return y
