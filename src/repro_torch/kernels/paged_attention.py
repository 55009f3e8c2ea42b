"""``paged_attention`` and ``paged_attention_quant``: decode attention over a
paged KV pool — wrappers of the Hopper kernels in ``csrc/paged_attention.cu``
(ports of ``repro/kernels/paged_attention.py:225 paged_attention_pallas``
and ``:158 paged_attention_quant_pallas``).

``q [B, Hkv, G, dh]``; pools ``[NB, BS, Hkv, dh]`` (one layer) of q's dtype,
or uint8 codes with per-row f32 ``k_scale, k_zero, v_scale, v_zero``
``[NB, BS, Hkv]``; ``block_tables [B, MB]`` int32; ``lengths [B]`` int32
(newest token at ``lengths - 1``); ``window`` an int (None = full
attention). A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises; a ``meta`` tensor is counted
(:func:`paged_attention_work`) over every page of the block tables (the
window's rows where one is given): the static shapes' work.

The kernel's work split is :func:`attention_plan`: a grid of (sequence,
KV head, chunk) blocks, each chunk a fixed run of ``CHUNK_PAGES`` pages
that the block's warps share out, and a second small kernel that merges
the chunks' partial softmax states in chunk order when there is more than
one chunk.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import ref
from ..launch.counting import Work, count_meta
from .build import DTYPE_CODES, LAUNCHES, check, load_library, stream_ptr
from .quant_matmul import SMEM_OPTIN, ptr, require

__all__ = ["POOL_CODES", "attention_plan", "paged_attention", "paged_attention_quant",
           "paged_attention_work"]

MAX_G = 8
MAX_HEAD_DIM = 256
#: warps per block, and pages each warp owns in its block's chunk
#: (``csrc/paged_attention.cu``: kWarps, kPagesPerWarp)
WARPS, PAGES_PER_WARP = 4, 4
CHUNK_PAGES = WARPS * PAGES_PER_WARP
#: shared memory of a block's page ring (half for uint8 pools, whose pages
#: cost more work per byte): each warp keeps as many of its pages in flight
#: as its share holds (at least one)
RING_BYTES = 64 * 1024
#: pool dtype codes of ``repro_paged_attention_smem`` (the card checks the
#: plan's shared memory against the kernel's own)
POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


@functools.lru_cache(maxsize=None)  # every launch asks; a model has a few shapes
def attention_plan(mb: int, bs: int, dh: int, g: int, pool_dtype) -> dict:
    """The work split ``csrc/paged_attention.cu`` runs for these static
    shapes. It takes no batch size and no lengths: chunk ``c`` covers
    positions ``[c·chunk, (c+1)·chunk)`` whatever ``mb`` is, and ``mb`` only
    sets how many chunks there are, so a sequence's pages meet the same
    warps and the same merges, in the same order, in any batch and any
    table width.

    - ``warps`` per block; warp ``w`` owns the chunk's pages ``w``,
      ``w + warps``, ... (``pages_per_warp`` of them);
    - ``elems_per_lane`` elements of a K or V row (4 or 8) per lane;
      ``lanes_per_row`` (a power of two) lanes share a row, so a warp takes
      ``rows_per_step`` rows a step, and ``batch_steps`` steps at once (one
      max and one rescale of its softmax state per batch);
    - ``stages``: a warp's pages in flight at once (as many as the ring
      holds, at least one, at most ``pages_per_warp``);
    - ``smem_bytes``: the ring, or the warps' merge area if that is larger;
      ``merge_smem_bytes``: the chunk merge's factors (0 for one chunk).
    """
    elem = torch.empty((), dtype=pool_dtype).element_size()
    epl = 4 if pool_dtype == torch.float32 and dh <= 128 else 8
    lanes = 1
    while lanes * epl < dh:
        lanes *= 2
    stage = 2 * bs * dh * elem + (16 * bs if pool_dtype == torch.uint8 else 0)
    ring = RING_BYTES // 2 if pool_dtype == torch.uint8 else RING_BYTES
    stages = 1
    while stages < PAGES_PER_WARP and WARPS * (stages + 1) * stage <= ring:
        stages += 1
    chunks = -(-mb // CHUNK_PAGES)
    return dict(
        warps=WARPS, pages_per_warp=PAGES_PER_WARP, chunk_pages=CHUNK_PAGES,
        chunk=CHUNK_PAGES * bs, chunks=chunks, stages=stages, stage_bytes=stage,
        elems_per_lane=epl, lanes_per_row=lanes, rows_per_step=32 // lanes,
        batch_steps=8 if g == 1 else 2,
        smem_bytes=max(WARPS * stages * stage, WARPS * g * (dh + 2) * 4),
        merge_smem_bytes=2 * g * chunks * 4 if chunks > 1 else 0,
    )


def _check(name, q, k_pool, v_pool, block_tables, lengths, pool_dtype):
    b, hkv, g, dh = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    mb = block_tables.shape[1]
    require(q.dtype in DTYPE_CODES, f"{name}: q must be float32 or bfloat16")
    require(g <= MAX_G and dh <= MAX_HEAD_DIM,
            f"{name}: needs G <= {MAX_G} and head_dim <= {MAX_HEAD_DIM}")
    for t in (k_pool, v_pool):
        require(tuple(t.shape) == (nb, bs, hkv, dh) and t.dtype == pool_dtype,
                f"{name}: pool {tuple(t.shape)} {t.dtype} does not match q")
    require(block_tables.dtype == torch.int32 and tuple(block_tables.shape) == (b, mb),
            f"{name}: block_tables must be int32 [B, MB]")
    require(mb >= 1, f"{name}: block_tables must hold at least one page per sequence")
    require(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,),
            f"{name}: lengths must be int32 [B]")
    for t in (q, k_pool, v_pool, block_tables, lengths):
        require(t.device == q.device and t.is_contiguous(),
                f"{name}: operands must be contiguous on one device")
    # the kernel copies K and V rows in 16-byte pieces
    row_bytes = dh * k_pool.element_size()
    require(row_bytes % 16 == 0,
            f"{name}: a pool row (head_dim {dh}) is {row_bytes} bytes, not a multiple of 16")
    for t in (k_pool, v_pool):
        require(t.data_ptr() % 16 == 0, f"{name}: pools must start on a 16-byte boundary")
    plan = attention_plan(mb, bs, dh, g, pool_dtype)
    require(plan["smem_bytes"] <= SMEM_OPTIN,
            f"{name}: pages of {bs} rows of head_dim {dh} need {plan['smem_bytes']} bytes "
            f"of shared memory > {SMEM_OPTIN}")
    require(plan["merge_smem_bytes"] <= SMEM_OPTIN,
            f"{name}: {plan['chunks']} chunks of G={g} need {plan['merge_smem_bytes']} bytes "
            f"of shared memory in the merge > {SMEM_OPTIN}")
    return b, hkv, g, dh, bs, mb, plan


def _partials(q, plan):
    """Per-chunk softmax states ``[B, Hkv, chunks, G, dh + 2]`` f32 (acc,
    then m and l) for the merge kernel; none when one chunk writes the
    output itself."""
    if plan["chunks"] == 1:
        return None
    b, hkv, g, dh = q.shape
    return torch.empty((b, hkv, plan["chunks"], g, dh + 2), dtype=torch.float32,
                       device=q.device)


def paged_attention_work(q: torch.Tensor, k_pool: torch.Tensor, block_tables: torch.Tensor, *,
                         window: Optional[int] = None, quant: bool = False,
                         kv_rows: Optional[int] = None) -> Work:
    """One launch's work over ``kv_rows`` attended rows of all sequences
    (default: every page of the block tables, or ``window`` rows a sequence
    where that is fewer): per row and KV head its K and V (an int8 pool: the
    codes and the four f32 scale / zero entries) read once, q read and the
    output written once, the tables and lengths read once; ``4 · Hkv · G ·
    rows · dh`` operations (QKᵀ and PV) in q's dtype."""
    b, hkv, g, dh = q.shape
    mb, bs = block_tables.shape[1], k_pool.shape[1]
    if kv_rows is None:
        kv_rows = b * (min(mb * bs, window) if window else mb * bs)
    per_row = 2 * dh + 16 if quant else 2 * dh * k_pool.element_size()
    io = kv_rows * hkv * per_row + 2 * q.numel() * q.element_size() + (block_tables.numel() + b) * 4
    return Work(io, 4 * hkv * g * kv_rows * dh, q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    if q.device.type == "meta":
        count_meta("paged_attention", paged_attention_work(q, k_pool, block_tables,
                                                           window=window))
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, window=window)
    name = "paged_attention"
    require(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    b, hkv, g, dh, bs, mb, plan = _check(name, q, k_pool, v_pool, block_tables, lengths,
                                         q.dtype)
    win = mb * bs + 1 if window is None else int(window)
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = load_library().repro_paged_attention(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(block_tables), ptr(lengths), ptr(out),
        ptr(_partials(q, plan)), b, hkv, g, dh, bs, mb, win, float(dh ** -0.5),
        plan["chunks"], plan["stages"], DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(rc, name)
    LAUNCHES[name] += 1
    return out


def paged_attention_quant(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                          k_scale: torch.Tensor, k_zero: torch.Tensor, v_scale: torch.Tensor,
                          v_zero: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """The same attention over uint8 pools, each staged row dequantized as
    ``(code − zero) · scale`` in f32 before the fp math."""
    quant = (k_scale, k_zero, v_scale, v_zero)
    if q.device.type == "meta":
        count_meta("paged_attention_quant", paged_attention_work(
            q, k_pool, block_tables, window=window, quant=True))
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables, lengths, window=window,
                                       quant=quant)
    name = "paged_attention_quant"
    require(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    b, hkv, g, dh, bs, mb, plan = _check(name, q, k_pool, v_pool, block_tables, lengths,
                                         torch.uint8)
    for t in quant:
        require(tuple(t.shape) == tuple(k_pool.shape[:3]) and t.dtype == torch.float32,
                f"{name}: scale/zero tables must be float32 [NB, BS, Hkv]")
        require(t.device == q.device and t.is_contiguous(),
                f"{name}: operands must be contiguous on one device")
    win = mb * bs + 1 if window is None else int(window)
    out = torch.empty_like(q)
    if b == 0:
        return out
    rc = load_library().repro_paged_attention_quant(
        ptr(q), ptr(k_pool), ptr(v_pool), *(ptr(t) for t in quant), ptr(block_tables),
        ptr(lengths), ptr(out), ptr(_partials(q, plan)), b, hkv, g, dh, bs, mb, win,
        float(dh ** -0.5), plan["chunks"], plan["stages"], DTYPE_CODES[q.dtype],
        stream_ptr(q),
    )
    check(rc, name)
    LAUNCHES[name] += 1
    return out
