"""``moe_gmm`` and ``moe_gmm_swiglu``: grouped, ragged dequantize-GEMMs of one
PMQ bit bucket — wrappers of the Hopper kernels in ``csrc/moe_gmm.cu``
(ports of ``repro/kernels/moe_gmm.py:93 moe_gmm_pallas`` and
``:191 moe_gmm_swiglu_pallas``).

Row block ``i`` (``bm`` rows of ``x_sorted``) multiplies expert
``block_expert[i]``; blocks at index ≥ ``num_active[0]`` are zero and read
no weights. ``block_expert`` and ``num_active`` stay on the device. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import ref
from .build import DTYPE_CODES, LAUNCHES, check, load_library, stream_ptr
from .quant_matmul import require, check_activations, check_operand, ptr

__all__ = ["moe_gmm", "moe_gmm_swiglu"]


def _check_tables(name, x, block_expert, num_active, bm):
    m = x.shape[0]
    require(bm in (8, 16), f"{name}: bm must be 8 or 16, got {bm}")
    require(m % bm == 0, f"{name}: M={m} must be a multiple of bm={bm}")
    for t, shape in ((block_expert, (m // bm,)), (num_active, (1,))):
        require(t.dtype == torch.int32, f"{name}: block tables must be int32")
        require(tuple(t.shape) == shape, f"{name}: table shape {tuple(t.shape)} != {shape}")
        require(t.device == x.device and t.is_contiguous(),
                f"{name}: tables must be contiguous on x's device")


def _experts_n(w_packed, bits):
    p0 = w_packed[0] if bits == 3 else w_packed
    return p0.shape[0], p0.shape[-1]


def moe_gmm(x_sorted: torch.Tensor, w_packed, scale, zero, block_expert: torch.Tensor,
            num_active: torch.Tensor, *, bits: int, group: int = 128,
            bm: int = 16) -> torch.Tensor:
    """``x_sorted [Mp, K]``, weights ``[E, K/per, N]`` → ``[Mp, N]``."""
    if x_sorted.device.type == "cpu":
        return ref.moe_gmm_ref(x_sorted, w_packed, scale, zero, block_expert, num_active,
                               bits=bits, group=group, bm=bm)
    require(x_sorted.device.type == "cuda", f"moe_gmm: unsupported device {x_sorted.device}")
    check_activations("moe_gmm", x_sorted, group=group)
    _check_tables("moe_gmm", x_sorted, block_expert, num_active, bm)
    m, k = x_sorted.shape
    e, n = _experts_n(w_packed, bits)
    p0, p1 = check_operand("moe_gmm", w_packed, scale, zero, bits=bits, group=group, k=k,
                           n=n, lead=(e,), device=x_sorted.device)
    y = torch.empty((m, n), dtype=x_sorted.dtype, device=x_sorted.device)
    if m == 0:
        return y
    rc = load_library().repro_moe_gmm(
        ptr(x_sorted), ptr(p0), ptr(p1), ptr(scale), ptr(zero), ptr(block_expert),
        ptr(num_active), ptr(y), m, k, n, bits, group, bm, DTYPE_CODES[x_sorted.dtype],
        stream_ptr(x_sorted),
    )
    check(rc, "moe_gmm")
    LAUNCHES["moe_gmm"] += 1
    return y


def moe_gmm_swiglu(x_sorted: torch.Tensor, wg_packed, wu_packed, g_scale, g_zero, u_scale,
                   u_zero, block_expert: torch.Tensor,
                   num_active: torch.Tensor, *, bits: int,
                   group: int = 128, bm: int = 16) -> torch.Tensor:
    """``silu(x @ dq(Wg[e])) * (x @ dq(Wu[e]))`` per row block → ``[Mp, N]``."""
    if x_sorted.device.type == "cpu":
        return ref.moe_gmm_swiglu_ref(
            x_sorted, wg_packed, wu_packed, g_scale, g_zero, u_scale, u_zero, block_expert,
            num_active, bits=bits, group=group, bm=bm,
        )
    require(x_sorted.device.type == "cuda",
            f"moe_gmm_swiglu: unsupported device {x_sorted.device}")
    check_activations("moe_gmm_swiglu", x_sorted, group=group)
    _check_tables("moe_gmm_swiglu", x_sorted, block_expert, num_active, bm)
    m, k = x_sorted.shape
    e, n = _experts_n(wg_packed, bits)
    kw = dict(bits=bits, group=group, k=k, n=n, lead=(e,), device=x_sorted.device)
    g0, g1 = check_operand("moe_gmm_swiglu", wg_packed, g_scale, g_zero, **kw)
    u0, u1 = check_operand("moe_gmm_swiglu", wu_packed, u_scale, u_zero, **kw)
    y = torch.empty((m, n), dtype=x_sorted.dtype, device=x_sorted.device)
    if m == 0:
        return y
    rc = load_library().repro_moe_gmm_swiglu(
        ptr(x_sorted), ptr(g0), ptr(g1), ptr(g_scale), ptr(g_zero), ptr(u0), ptr(u1),
        ptr(u_scale), ptr(u_zero), ptr(block_expert), ptr(num_active), ptr(y), m, k, n, bits,
        group, bm, DTYPE_CODES[x_sorted.dtype], stream_ptr(x_sorted),
    )
    check(rc, "moe_gmm_swiglu")
    LAUNCHES["moe_gmm_swiglu"] += 1
    return y
