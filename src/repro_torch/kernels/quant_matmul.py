"""``quant_matmul``: ``y[M, N] = x[M, K] @ dq(W_packed)`` — the wrapper of
the Hopper kernel in ``csrc/quant_matmul.cu`` (port of
``repro/kernels/quant_matmul.py:99 quant_matmul_pallas``).

A CPU tensor takes the plain version (:func:`ref.quant_matmul_ref`); a
CUDA tensor launches the kernel or raises; a ``meta`` tensor is counted
(:func:`quant_matmul_work`, :func:`~repro_torch.launch.counting.count_meta`).
Also home of the operand checks the grouped kernels share, and of
:func:`tile_plan`, the static tiling of their bf16 body
(``csrc/dequant_gemm_sm90.cuh``).
"""
from __future__ import annotations

import functools

import torch

from . import ref
from ..launch.counting import Work, count_meta, nbytes
from .build import DTYPE_CODES, LAUNCHES, check, load_library, stream_ptr

__all__ = ["quant_matmul", "quant_matmul_work", "tile_plan"]

_PER = {1: 8, 2: 4, 4: 2}

#: the bf16 body's column tile (the MMA's M), warps per block (K slices),
#: the shared memory one block may opt in to on an H100, and an SM's whole
#: shared memory with what the runtime reserves per resident block
COL_TILE, WARPS, SMEM_OPTIN = 16, 8, 232448
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024


def _smem(kx: int, ng: int, bits: int, rows: int, operands: int, chunked: bool) -> int:
    """Shared-memory bytes of one block staging ``kx`` codes of ``ng``
    groups per item: the kernel's ``Layout``. One chunk stages x once per row
    block beside the tables; several carry each chunk's x slice in the two
    stage buffers, with its codes."""
    plane_rows = (kx // 8 * 2 + kx // 8) if bits == 3 else kx // _PER[bits]
    # value tables: a bf16 pair per code pair (1, 2 bits) or a bf16 per code,
    # each column's entries padded by one pair / two values
    pairs = bits <= 2
    entries = 1 << (2 * bits if pairs else bits)
    table = ng * COL_TILE * (entries + 1 if pairs else entries + 2) * (4 if pairs else 2)
    x_stride = kx + 2 * ((8 - (kx // 2) % 32) % 32)  # bf16; rows 8 words apart mod 32 banks
    x_bytes = rows * x_stride * 2
    stage = operands * (plane_rows * COL_TILE + ng * 2 * COL_TILE * 4)  # codes + scale/zero
    if chunked:
        stage += x_bytes
    # two stage buffers, tables, x (one chunk), one reduction buffer
    return (2 * stage + operands * (-(-table // 16) * 16) + (0 if chunked else x_bytes)
            + WARPS * rows * COL_TILE * 4)


@functools.lru_cache(maxsize=None)  # every launch asks; a model has a few shapes
def tile_plan(k: int, n: int, bits: int, group: int, dtype, rows: int = 8,
              operands: int = 1) -> dict:
    """The tiling that ``csrc/dequant_gemm_sm90.cuh`` runs for these static
    shapes (``rows`` is the work item's row tile: 8 for ``quant_matmul``,
    the row block ``bm`` for ``moe_gmm``; ``operands`` is 2 for
    ``moe_gmm_swiglu``'s gate and up). It takes no M: the number of rows
    changes how many items run, never a row's arithmetic.

    ``k_chunks`` are the ranges of k16 steps an item stages one after the
    other: all of K where that fits ``SMEM_OPTIN``, else the fewest even
    chunks of whole quantization groups that do. ``k_slices`` are the
    warps' ranges within each chunk, chunk by chunk (``WARPS`` per chunk);
    warp ``w`` adds slice ``w`` of every chunk into one accumulator and the
    warps are added in warp order. ``smem_bytes`` mirrors the kernel's
    ``Layout`` (the C function ``repro_dequant_gemm_sm90_smem`` reports the
    kernel's own) and ``smem_blocks_per_sm`` is how many such blocks an
    SM's shared memory holds (registers may allow fewer).
    f32 activations run the older CUDA-core body, which has no plan here."""
    if operands not in (1, 2):
        raise ValueError(f"the bf16 body takes 1 or 2 weight operands, got {operands}")
    if dtype != torch.bfloat16:
        return {"body": "dequant_gemm.cuh", "rows": rows, "operands": operands}
    kx = -(-k // 16) * 16
    ng = -(-k // group)
    steps = kx // 16
    gpc, smem = ng, _smem(kx, ng, bits, rows, operands, chunked=False)
    if smem > SMEM_OPTIN and ng > 1:  # the fewest even chunks that fit
        for parts in range(2, ng + 1):
            gpc = -(-ng // parts)
            smem = _smem(gpc * group, gpc, bits, rows, operands, chunked=True)
            if smem <= SMEM_OPTIN:
                break
    chunk_steps = gpc * group // 16
    chunks = [(lo, min(steps, lo + chunk_steps)) for lo in range(0, steps, chunk_steps)]
    slices = []
    for lo, hi in chunks:
        spw = -(-(hi - lo) // WARPS)
        slices += [(lo + w * spw, min(hi, lo + (w + 1) * spw)) for w in range(WARPS)]
    return {
        "body": "dequant_gemm_sm90.cuh", "rows": rows, "operands": operands,
        "col_tile": COL_TILE, "warps": WARPS,
        "n_tiles": -(-n // COL_TILE), "k_steps": steps, "k_chunks": chunks,
        "k_slices": slices,
        "tables": "code pairs" if bits <= 2 else "codes", "smem_bytes": smem,
        "smem_blocks_per_sm": SMEM_PER_SM // (smem + SMEM_RESERVED),
    }


def check_plan(name: str, plan: dict) -> None:
    require(plan.get("smem_bytes", 0) <= SMEM_OPTIN,
            f"{name}: one quantization group's staging overflows the bf16 body's shared "
            f"memory ({plan.get('smem_bytes')} bytes > {SMEM_OPTIN})")


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
    # codes are padded to a whole byte (3 bits: to a multiple of 8), groups
    # to a whole group — a ragged K keeps the reference's padded layout
    k8 = -(-k // 8)
    shapes = ((p0, 2 * k8), (p1, k8)) if bits == 3 else ((p0, -(-k // _PER[bits])),)
    ng = -(-k // group)
    for t, rows in shapes:
        require(t.dtype == torch.uint8, f"{name}: packed weights must be uint8")
        require(tuple(t.shape) == (*lead, rows, n),
                f"{name}: packed plane {tuple(t.shape)} != {(*lead, rows, n)}")
    for t in (scale, zero):
        require(t.dtype == torch.float32, f"{name}: scale/zero must be float32")
        require(tuple(t.shape) == (*lead, ng, n),
                f"{name}: scale/zero {tuple(t.shape)} != {(*lead, ng, n)}")
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


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def quant_matmul_work(x: torch.Tensor, w_packed, scale, zero, *, bits: int) -> Work:
    """One launch's work: ``2·M·K·N`` in x's dtype; x, the packed planes,
    scale and zero read once, ``y [M, N]`` written once."""
    m, k = x.shape
    n = planes(w_packed, bits)[0].shape[-1]
    return Work(nbytes(x, w_packed, scale, zero) + m * n * x.element_size(), 2 * m * k * n,
                x.dtype)


def quant_matmul(x: torch.Tensor, w_packed, scale, zero, *, bits: int,
                 group: int = 128) -> torch.Tensor:
    """``x [M, K]`` @ dequant of ``w_packed [K/per, N]`` → ``[M, N]`` in x's dtype."""
    if x.device.type == "meta":
        count_meta("quant_matmul", quant_matmul_work(x, w_packed, scale, zero, bits=bits))
        return x.new_empty((x.shape[0], planes(w_packed, bits)[0].shape[-1]))
    if x.device.type == "cpu":
        return ref.quant_matmul_ref(x, w_packed, scale, zero, bits=bits, group=group)
    require(x.device.type == "cuda", f"quant_matmul: unsupported device {x.device}")
    check_activations("quant_matmul", x, group=group)
    m, k = x.shape
    n = (w_packed[0] if bits == 3 else w_packed).shape[-1]
    p0, p1 = check_operand("quant_matmul", w_packed, scale, zero, bits=bits, group=group,
                           k=k, n=n, lead=(), device=x.device)
    check_plan("quant_matmul", tile_plan(k, n, bits, group, x.dtype))
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
