"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each failure exits non-zero):

1. device line (``nvidia-smi`` name and power limit); TF32 off;
2. build the Hopper kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
3. kernel parity: each kernel against its plain PyTorch version on the
   card at the main path's shapes (bits 1/2/3/4, dead row blocks, K ending
   mid-group and K < group, G = 1 and 2, windows, ragged lengths, length 0,
   permuted block tables, all-zero int8 rows; attention lengths at chunk
   edges and at 4096 positions, head_dim 32/128/256, G up to 8 (5 for
   qwen3-14b), windows starting mid-chunk; f32 and bf16); bitwise batch
   invariance of the dequant GEMMs (``quant_matmul`` rows of ``x[:m]`` for m in 1/4/8/16/24
   equal the full call's; a live ``moe_gmm`` or ``moe_gmm_swiglu`` block's
   rows do not move when ``num_active`` or the other blocks' experts
   change), of ``binary_matmul`` (rows of ``x[:m]`` for m in 1/5/16/24/64)
   and of attention (a sequence's output alone, in a batch, with a wider
   table and on other physical pages); the bf16 GEMM body's (one operand
   and SwiGLU's two), ``binary_matmul``'s and the attention kernels' shared
   memory against their host-side plans; then each kernel's time (median,
   min and max of 50 L2-flushed launches, the SM clock read before and
   after on a ``timing`` line) beside the plain version, one library call
   and its bound — ``quant_matmul`` at the decode and the prefill shape,
   the attention kernels at the decode shape, at 4096 positions (``long``)
   and at G = 5 (``decode_g5``); then the bf16 dequant GEMMs where K outgrows one item's
   shared memory and is walked in chunks — ``quant_matmul``, ``moe_gmm``
   and ``moe_gmm_swiglu`` at K = 7168 (kimi-k2's d_model; bits 1-4, bm 8
   and 16) and ``quant_matmul`` at K = 17408 (qwen3-14b's d_ff, 4 bits):
   parity, batch invariance and one timing each (``k7168``, ``k17408``);
4. tiny end-to-end parity: reduced configs (f32, one seed) served on the
   card and on the CPU — ``moonshot-v1-16b-a3b`` PMQ + OTP with fp KV and
   with int8 KV plus the prefix cache, ``qwen3-14b`` (dense) and
   ``moonshot-v1-16b-a3b`` without compression with fp KV — identical
   greedy tokens, per-step logits within 1e-3·max|logit|, and for the
   dense and uncompressed models the dense-cache oracle's tokens; then a
   decode megastep of each on the card under
   ``set_sync_debug_mode("error")``, which fails if anything inside the
   horizon waits on the host;
5. full-width serving of the two workloads of ``repro_torch.launch.workload``
   (``moonshot-v1-16b-a3b`` at full width and all 48 layers in bf16, one
   set of weights) through ``PagedServingEngine``, each path with the
   launch counts set to 0 just before it and read just after:
   the fp path (4 requests of 64 prompt and 32 new tokens; its kernels must
   launch, a second engine must emit byte-identical tokens), then the int8
   KV + shared-prefix path (``SHARED_PREFIX``: ``paged_attention_quant``
   must launch, the fp attention kernel must not; tokens byte-identical to
   an int8 engine without the prefix cache and to a second prefix engine;
   prefill chunks and copy-on-write copies as the reference's rules give);
   then the tenant mix (``TENANT_MIX``: batch, chat and interactive tenants
   on a 14-page pool through the control plane, ``fair`` policy, a TTFT
   budget, a ``pool`` and a ``logits`` fault, ``spans`` tracing) served four
   times — (a) as set, (b) a fresh engine replaying the fault plan, (c)
   ``fcfs`` and (d) ``priority`` without faults: (a) and (b) identical in
   tokens, typed errors, ``counters()`` and deterministic trace; the trace
   valid; the poisoned request empty with ``PoisonedRequest``; (a)'s schedule
   counters the reference engine's (``workload.TENANT_MIX_COUNTERS``); every
   rid completed in two runs with the same tokens in both; the fp path's
   kernels launched and no other;
   then, the compressed model freed, ``qwen3-14b`` (dense, 40 layers) and
   ``moonshot-v1-16b-a3b`` without compression (48 layers, ~57.8 GB), each
   built on the card, served on the fp geometry (``paged_attention`` must
   launch and no other kernel; a second engine must emit the same tokens)
   and freed; a last line sets the uncompressed model's expert bytes
   against the compressed one's, on the device and per decode step;
6. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
   ``binary_matmul`` has no serving caller (as in the reference), so its
   launches are those of phase 3.

It imports nothing of JAX or of the JAX package, and refuses to run
without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.compressed_moe import gmm_block_rows  # noqa: E402
from repro_torch.core.quantizers import quantize_parts  # noqa: E402
from repro_torch.core.synthetic import (  # noqa: E402
    bucket_counts,
    build_synthetic,
    build_uncompressed,
)
from repro_torch.core.tree import to_device, weight_bytes  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.core.quantizers import quantize_kv_rows  # noqa: E402
from repro_torch.core.packing import pack_bits, pad_to_multiple, unpack_bits  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul, binary_plan  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_swiglu  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    POOL_CODES,
    attention_plan,
    paged_attention,
    paged_attention_quant,
)
from repro_torch.kernels.quant_matmul import quant_matmul, tile_plan  # noqa: E402
from repro_torch.launch import probe_attention, profile_decode, workload  # noqa: E402
from repro_torch.models.moe import dispatch_capacity  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _paged_decode_core,
    paged_decode_horizon,
    paged_prefill_chunk,
)
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    PagedKVCache,
    PagedServingEngine,
    PoisonedRequest,
    Request,
    validate_chrome_trace,
    validate_events,
)
from repro_torch.serving.engine import dense_greedy_reference  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 TC / f32 CUDA cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # × max|plain|, see module docstring
RAGGED_K, SHORT_K = 3 * 128 + 64, 64  # K ending mid-group, K < group (group 128)
KERNELS = {
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:99"),
    "moe_gmm_swiglu": ("src/repro_torch/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:191"),
    "moe_gmm": ("src/repro_torch/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:93"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:225"),
    "paged_attention_quant": ("src/repro_torch/csrc/paged_attention.cu",
                              "src/repro/kernels/paged_attention.py:158"),
    "binary_matmul": ("src/repro_torch/csrc/binary_matmul.cu",
                      "src/repro/kernels/binary_matmul.py:49"),
}
DEV = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- helpers
def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """max|kernel − plain|, failing above TOL[dtype]·max|plain| (f32: only
    the summation order differs; bf16: both round the weights to bf16 and
    accumulate in f32, the outputs round to bf16)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    limit = TOL[dtype] * max(want.abs().max().item(), 1e-30)
    if err > limit:
        raise AssertionError(f"{name}: max|kernel-plain| {err:.3e} > {limit:.3e}")
    return err


def time_ms(fn, iters: int = 50):
    """Device time of ``fn`` over ``iters`` launches (CUDA events): the
    median, min and max in ms.

    Before each timed launch the 50 MB L2 is flushed (weights then come
    from memory, as on the main path) and the stream is held by a ~1 ms
    device sleep while the host enqueues flush, events and ``fn`` — so the
    events bracket device work only, never the host's launch overhead."""
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    ts = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        scrub.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts), min(ts), max(ts)


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def time_kernel(name: str, fn) -> dict:
    """:func:`time_ms` of a kernel with the SM clock read just before and
    just after, on a ``timing`` line of its own."""
    before = sm_clock()
    med, lo, hi = time_ms(fn)
    after = sm_clock()
    log(f"timing {name}: median {med:.4f} ms, min {lo:.4f}, max {hi:.4f} over 50 launches; "
        f"SM clock {before} before, {after} after")
    return dict(ms=med, ms_min=lo, ms_max=hi, sm_clock=[before, after])


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.shape == b.shape and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def bound(nbytes: float, ops: float, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    out = 0
    for t in ts:
        for x in (t if isinstance(t, tuple) else (t,)):
            out += x.numel() * x.element_size()
    return out


def rand_weights(gen, e, k, n, bits, group=128):
    """Quantized random expert stack ``[e, K, N]`` (packed, scale, zero)."""
    w = torch.randn((e, k, n), generator=gen, device=DEV) * k**-0.5
    return quantize_parts(w, bits, group, refine=False)


def ragged_tables(experts: int, cap: int, live_rows):
    """Compacted layout of ``live_rows[i]`` rows for expert ``i``: the
    ``block_expert`` table (trailing dead blocks repeat the last id) and
    ``num_active``, as ``grouped_bucket_ffn`` builds them."""
    bm = gmm_block_rows(cap)
    nblk = [(r + bm - 1) // bm for r in live_rows]
    ids = [e for e, n in enumerate(nblk) for _ in range(n)]
    total = experts * cap // bm
    ids += [experts - 1] * (total - len(ids))
    be = torch.tensor(ids, dtype=torch.int32, device=DEV)
    return be, torch.tensor([sum(nblk)], dtype=torch.int32, device=DEV), bm, sum(nblk)


# ------------------------------------------------------- phase 3: kernels
def parity_quant_matmul(gen, results):
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for bits, (m, k, n) in [(4, (4, 2048, 2048)), (4, (16, 2048, 2816)),
                                (4, (5, 2816, 2048)), (1, (4, 2048, 1408)),
                                (2, (16, 1408, 2048)), (3, (8, 2048, 1408))]:
            (data, s, z) = rand_weights(gen, 1, k, n, bits)
            data = tuple(t[0] for t in data) if bits == 3 else data[0]
            x = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
            got = quant_matmul(x, data, s[0], z[0], bits=bits)
            want = ref.quant_matmul_ref(x, data, s[0], z[0], bits=bits)
            errs.append(compare(f"quant_matmul b{bits} {m}x{k}x{n} {dtype}", got, want, dtype))
        # K ending mid-group (3 groups + 64) and K < group: the last group is bounded
        for bits in (1, 2, 3, 4):
            for m, k, n in ((5, RAGGED_K, 96), (4, SHORT_K, 96)):
                (data, s, z) = rand_weights(gen, 1, k, n, bits)
                data = tuple(t[0] for t in data) if bits == 3 else data[0]
                x = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
                got = quant_matmul(x, data, s[0], z[0], bits=bits)
                want = ref.quant_matmul_ref(x, data, s[0], z[0], bits=bits)
                errs.append(compare(f"quant_matmul ragged b{bits} K={k} {dtype}", got, want,
                                    dtype))
    # main-path shapes, 4-bit bf16: wq at decode (4 slots), the shared
    # experts' gate/up at prefill (a 16-token chunk)
    r = _time_quant_matmul("quant_matmul decode", 4, 2048, 2048, 4, gen)
    results["quant_matmul"] = dict(max_abs_err=max(errs), **r)
    r = _time_quant_matmul("quant_matmul prefill", 16, 2048, 2816, 4, gen)
    results["quant_matmul"]["prefill"] = r
    log_extra("quant_matmul", "prefill", r)


def invariance_quant_matmul(gen):
    """A row's output bit for bit whatever M: rows of ``x[:m]`` against the
    same rows of one call over all 24, every bit width, f32 and bf16, N a
    multiple of the column tile and not."""
    for dtype in (torch.bfloat16, torch.float32):
        for bits, (k, n) in ((4, (2048, 2048)), (4, (2048, 2816)), (1, (2048, 1400)),
                             (2, (1408, 2048)), (3, (RAGGED_K, 1400)), (4, (7168, 2048)),
                             (2, (7168 + 64, 1400)), (4, (17408, 512))):
            (data, s, z) = rand_weights(gen, 1, k, n, bits)
            data = tuple(t[0] for t in data) if bits == 3 else data[0]
            x = torch.randn((24, k), generator=gen, device=DEV).to(dtype)
            full = quant_matmul(x, data, s[0], z[0], bits=bits)
            for m in (1, 4, 8, 16, 24):
                part = quant_matmul(x[:m].contiguous(), data, s[0], z[0], bits=bits)
                if not bitwise_equal(part, full[:m]):
                    raise AssertionError(f"quant_matmul b{bits} K={k} N={n} {dtype}: rows of "
                                         f"M={m} differ from the same rows at M=24")
    log("batch invariance: quant_matmul rows bit-identical for M in 1/4/8/16/24 "
        "(bits 1-4, f32 and bf16; K = 7168, 7232 and 17408 in chunks)")


def invariance_moe_gmm(gen, cfg):
    """A live block's rows bit for bit whatever the other blocks hold: more
    and fewer live blocks, other experts in the other blocks (2-bit bucket
    at the decode shape, bm 8, and a 4-bit one at bm 16; ``moe_gmm`` and
    ``moe_gmm_swiglu``; f32 and bf16)."""
    d, f = cfg.d_model, cfg.d_ff_expert
    for kind, (k, n) in (("moe_gmm", (f, d)), ("moe_gmm_swiglu", (d, f)),
                         ("moe_gmm", (7168, f)), ("moe_gmm_swiglu", (7168, f))):
        for dtype in (torch.bfloat16, torch.float32):
            for bits, experts, cap in ((2, 59, 24), (4, 5, 96)):
                bm = gmm_block_rows(cap)
                nblocks = experts * cap // bm
                if kind == "moe_gmm":
                    w = rand_weights(gen, experts, k, n, bits)
                    call = lambda be_, na_t: moe_gmm(x, *w, be_, na_t, bits=bits, bm=bm)
                else:
                    (g, gs, gz), (u, us, uz) = (rand_weights(gen, experts, k, n, bits)
                                                for _ in range(2))
                    call = lambda be_, na_t: moe_gmm_swiglu(x, g, u, gs, gz, us, uz, be_, na_t,
                                                            bits=bits, bm=bm)
                x = torch.randn((experts * cap, k), generator=gen, device=DEV).to(dtype)
                ids = torch.randint(0, experts, (nblocks,), generator=gen, device=DEV)
                be = torch.sort(ids).values.to(torch.int32)
                live = nblocks // 3

                def run(be_, na_):
                    return call(be_, torch.tensor([na_], dtype=torch.int32, device=DEV))

                base = run(be, live)
                other = be.clone()
                other[0] = (other[0] + 1) % experts           # another expert in block 0
                other[live:] = experts - 1 - other[live:]     # and in the dead blocks
                checks = ((run(be, live + 4), live), (run(be, live - 2), live - 2),
                          (run(other, live + 2), live))
                for y, upto in checks:
                    if not bitwise_equal(y[bm:upto * bm], base[bm:upto * bm]):
                        raise AssertionError(f"{kind} b{bits} bm{bm} {dtype}: a live block's "
                                             f"rows moved with the other blocks")
                if (run(be, 0) != 0).any():
                    raise AssertionError(f"{kind}: num_active 0 left non-zero rows")
    log("batch invariance: moe_gmm and moe_gmm_swiglu live blocks bit-identical as "
        "num_active and the other blocks' experts change (bm 8 and 16, f32 and bf16; K = "
        "d_model, d_ff_expert and 7168 in chunks); num_active 0 all zero")


def invariance_binary_matmul(gen, cfg):
    """A row's output bit for bit whatever M: rows of ``x[:m]`` against the
    same rows of one call over all 64 (the expert gate/up shape, a ragged K
    and N off the column tile; f32 and bf16)."""
    for dtype in (torch.bfloat16, torch.float32):
        for k, n in ((cfg.d_model, cfg.d_ff_expert), (RAGGED_K + 3, 1400)):
            _, (x, b_packed, alpha) = _binary_case(gen, dtype, 64, k, n)
            full = binary_matmul(x, b_packed, alpha)
            for m in (1, 5, 16, 24, 64):
                if not bitwise_equal(binary_matmul(x[:m].contiguous(), b_packed, alpha),
                                     full[:m]):
                    raise AssertionError(f"binary_matmul K={k} N={n} {dtype}: rows of M={m} "
                                         f"differ from the same rows at M=64")
    log("batch invariance: binary_matmul rows bit-identical for M in 1/5/16/24/64 "
        "(K = d_model and a ragged K, N on and off the column tile; f32 and bf16)")


def check_tile_plans(cfg):
    """The kernel's own shared memory per block equals the host-side plan's
    at every bf16 shape of the main path (SwiGLU's gate/up with two
    operands), and ``binary_matmul``'s at its shapes."""
    lib = build.load_library()
    d, f = cfg.d_model, cfg.d_ff_expert
    fs = f * cfg.num_shared_experts
    shapes = [(d, d, 4, 8, 1), (d, fs, 4, 8, 1), (fs, d, 4, 8, 1)]
    shapes += [(kk, nn, b, r, nop) for b in (1, 2, 3) for r in (8, 16)
               for kk, nn, nop in ((d, f, 2), (f, d, 1))]
    # K chunked: kimi-k2's d_model, command-r's, qwen3-14b's d_ff
    shapes += [(kk, 2048, b, r, nop) for kk in (7168, 8192, 17408) for b in (1, 2, 3, 4)
               for r in (8, 16) for nop in (1, 2)]
    for k, n, bits, rows, nop in shapes:
        want = tile_plan(k, n, bits, cfg.quant.group, torch.bfloat16, rows=rows,
                         operands=nop)["smem_bytes"]
        got = lib.repro_dequant_gemm_sm90_smem(k, bits, cfg.quant.group, rows, nop)
        if got != want:
            raise AssertionError(f"tile plan K={k} N={n} b{bits} rows {rows} operands {nop}: "
                                 f"shared memory {want} in the plan, {got} in the kernel")
    for k in (d, RAGGED_K + 3, SHORT_K):
        want, got = binary_plan(k, f)["smem_bytes"], lib.repro_binary_matmul_smem(k)
        if got != want:
            raise AssertionError(f"binary plan K={k}: shared memory {want} in the plan, {got} "
                                 f"in the kernel")
    log(f"tile plans: {len(shapes)} shapes (the main path's, SwiGLU with two operands, and "
        f"K = 7168/8192/17408 in chunks) and 3 binary_matmul shapes, kernel shared memory == "
        f"host plan")


def _gmm_case(gen, kind, bits, dtype, cap, experts, live_rows, k, n):
    be, na, bm, nlive = ragged_tables(experts, cap, live_rows)
    m = experts * cap
    x = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
    if kind == "moe_gmm":
        w = rand_weights(gen, experts, k, n, bits)
        got = moe_gmm(x, *w, be, na, bits=bits, bm=bm)
        want = ref.moe_gmm_ref(x, *w, be, na, bits=bits, bm=bm)
        ws = [w]
    else:
        wg = rand_weights(gen, experts, k, n, bits)
        wu = rand_weights(gen, experts, k, n, bits)
        args = (wg[0], wu[0], wg[1], wg[2], wu[1], wu[2], be, na)
        got = moe_gmm_swiglu(x, *args, bits=bits, bm=bm)
        want = ref.moe_gmm_swiglu_ref(x, *args, bits=bits, bm=bm)
        ws = [wg, wu]
    err = compare(f"{kind} b{bits} bm{bm} K={k} {dtype}", got, want, dtype)
    if not (got[nlive * bm:] == 0).all():
        raise AssertionError(f"{kind}: dead row blocks are not zero")
    return err, dict(x=x, ws=ws, be=be, na=na, bm=bm, nlive=nlive, m=m)


def parity_moe(gen, results, cfg):
    decode_cap = dispatch_capacity(dataclasses.replace(
        cfg, moe_capacity_factor=float(cfg.num_experts)), 4)        # 24 -> bm 8
    prefill_cap = dispatch_capacity(dataclasses.replace(
        cfg, moe_capacity_factor=float(cfg.num_experts)), 16)       # 96 -> bm 16
    d, f = cfg.d_model, cfg.d_ff_expert
    rng = np.random.default_rng(0)
    for kind, (k, n) in (("moe_gmm_swiglu", (d, f)), ("moe_gmm", (f, d))):
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            for bits, cap, experts in [(1, decode_cap, 4), (2, decode_cap, 12),
                                       (3, prefill_cap, 6), (4, prefill_cap, 5)]:
                live = rng.integers(0, 3, size=experts).tolist()
                live[0] = max(live[0], 1)
                errs.append(_gmm_case(gen, kind, bits, dtype, cap, experts, live, k, n)[0])
                for k_r in (RAGGED_K, SHORT_K):  # the last group is bounded
                    errs.append(_gmm_case(gen, kind, bits, dtype, decode_cap, 3, [1, 2, 0],
                                          k_r, 96)[0])
        # main-path decode shape: the 2-bit bucket at 4 slots, bf16; 20 live experts
        _, n2, _ = bucket_counts(cfg.num_experts)
        live = [1] * 16 + [2] * 4 + [0] * (n2 - 20)
        err, c = _gmm_case(gen, kind, 2, torch.bfloat16, decode_cap, n2, live, k, n)
        errs.append(err)
        results[kind] = dict(max_abs_err=max(errs), **_time_gmm(kind, kind, c, 2, k, n, live))


def _time_gmm(label, kind, c, bits, k, n, live):
    """Time one grouped case of :func:`_gmm_case` (``c``: its context) beside
    its plain version, one ``torch.bmm`` of the live blocks and its bound:
    the packed rows and group params of the experts the routing touches,
    its routed rows of x and all of y."""
    x, ws, be, na, bm, nlive, m = (c[key] for key in ("x", "ws", "be", "na", "bm",
                                                       "nlive", "m"))
    experts = (ws[0][0][0] if bits == 3 else ws[0][0]).shape[0]
    used = sorted(set(be[:nlive].tolist()))
    w_bytes = sum(nbytes(t) // experts * len(used) for w in ws for t in w)
    rows = sum(live)
    io_bytes = rows * k * 2 + m * n * 2
    x_live = x[: nlive * bm].view(nlive, bm, k)
    if kind == "moe_gmm":
        call = lambda: moe_gmm(x, *ws[0], be, na, bits=bits, bm=bm)
        plain = lambda: ref.moe_gmm_ref(x, *ws[0], be, na, bits=bits, bm=bm)
        w_live = ref.dequant_ref(*ws[0], bits, k, dtype=torch.bfloat16)[be[:nlive].long()]
    else:
        (wg, gs, gz), (wu, us, uz) = ws
        args = (wg, wu, gs, gz, us, uz, be, na)
        call = lambda: moe_gmm_swiglu(x, *args, bits=bits, bm=bm)
        plain = lambda: ref.moe_gmm_swiglu_ref(x, *args, bits=bits, bm=bm)
        # products only, no SwiGLU: the live blocks' x against the
        # pre-dequantized [Wg | Wu] in one torch.bmm ([nlive, K, 2N])
        w_gu = torch.cat([ref.dequant_ref(wg, gs, gz, bits, k, dtype=torch.bfloat16),
                          ref.dequant_ref(wu, us, uz, bits, k, dtype=torch.bfloat16)], dim=-1)
        w_live = w_gu[be[:nlive].long()]
    library = time_ms(lambda: torch.bmm(x_live, w_live))[0]
    return dict(
        **time_kernel(label, call), plain_ms=time_ms(plain)[0], library_ms=library,
        shape=f"{bits}-bit bucket of {experts} experts, bm {bm}, {nlive} live blocks of "
              f"{m // bm}, K={k} N={n} bf16"
              + ("; library: torch.bmm of the gate and up products only, no SwiGLU"
                 if kind == "moe_gmm_swiglu" else ""),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(w_bytes + io_bytes, 2 * len(ws) * rows * k * n, torch.bfloat16))),
    )


def _time_quant_matmul(label, m, k, n, bits, gen):
    """Time ``quant_matmul`` at one shape beside its plain version,
    ``torch.matmul`` on the pre-dequantized weight and its bound."""
    (data, s, z) = rand_weights(gen, 1, k, n, bits)
    data = tuple(t[0] for t in data) if bits == 3 else data[0]
    s, z = s[0], z[0]
    x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
    w_deq = ref.dequant_ref(data, s, z, bits, k, dtype=torch.bfloat16)
    return dict(
        **time_kernel(label, lambda: quant_matmul(x, data, s, z, bits=bits)),
        plain_ms=time_ms(lambda: ref.quant_matmul_ref(x, data, s, z, bits=bits))[0],
        library_ms=time_ms(lambda: torch.matmul(x, w_deq))[0],
        shape=f"M={m} K={k} N={n} {bits}-bit bf16",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes(x, data, s, z) + m * n * 2, 2 * m * k * n, torch.bfloat16))),
    )


def log_extra(name: str, key: str, r: dict) -> None:
    log(f"kernel {name} {key} [{r['shape']}]: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")


def parity_split_k(gen, results, cfg):
    """The bf16 dequant GEMMs where an item's K range outgrows shared memory
    and the body walks K in chunks: kimi-k2's d_model (K = 7168; bits 1-4;
    ``quant_matmul``, ``moe_gmm`` and ``moe_gmm_swiglu`` at bm 8 and 16)
    and qwen3-14b's d_ff (K = 17408; 4-bit ``quant_matmul``), each against
    its plain version; then one timing per kernel at K = 7168 (``k7168``)
    and one of ``quant_matmul`` at K = 17408 (``k17408``)."""
    k, n = 7168, 2048
    decode_cap = dispatch_capacity(dataclasses.replace(
        cfg, moe_capacity_factor=float(cfg.num_experts)), 4)        # 24 -> bm 8
    prefill_cap = dispatch_capacity(dataclasses.replace(
        cfg, moe_capacity_factor=float(cfg.num_experts)), 16)       # 96 -> bm 16
    errs = []
    for bits in (1, 2, 3, 4):
        for m, kk, nn in ((4, k, n), (16, 17408, 512)):
            if kk == 17408 and bits != 4:
                continue
            (data, sc, z) = rand_weights(gen, 1, kk, nn, bits)
            data = tuple(t[0] for t in data) if bits == 3 else data[0]
            x = torch.randn((m, kk), generator=gen, device=DEV).to(torch.bfloat16)
            errs.append(compare(f"quant_matmul b{bits} K={kk}",
                                quant_matmul(x, data, sc[0], z[0], bits=bits),
                                ref.quant_matmul_ref(x, data, sc[0], z[0], bits=bits),
                                torch.bfloat16))
        for kind in ("moe_gmm_swiglu", "moe_gmm"):
            for cap in (decode_cap, prefill_cap):
                errs.append(_gmm_case(gen, kind, bits, torch.bfloat16, cap, 3, [1, 2, 0], k,
                                      n)[0])
    for name in ("quant_matmul", "moe_gmm_swiglu", "moe_gmm"):
        results[name]["split_k_max_abs_err"] = max(errs)
    r = _time_quant_matmul("quant_matmul K=7168", 4, k, 8192, 4, gen)
    results["quant_matmul"]["k7168"] = r
    log_extra("quant_matmul", "k7168", r)
    r = _time_quant_matmul("quant_matmul K=17408", 4, 17408, 5120, 4, gen)
    results["quant_matmul"]["k17408"] = r
    log_extra("quant_matmul", "k17408", r)
    live = [1] * 12 + [2] * 4
    for kind in ("moe_gmm_swiglu", "moe_gmm"):
        _, c = _gmm_case(gen, kind, 2, torch.bfloat16, decode_cap, 16, live, k, n)
        r = _time_gmm(f"{kind} K={k}", kind, c, 2, k, n, live)
        results[kind]["k7168"] = r
        log_extra(kind, "k7168", r)
    log(f"split K: quant_matmul, moe_gmm and moe_gmm_swiglu at K = 7168 (bits 1-4, bm 8 and "
        f"16) and quant_matmul at K = 17408 (4 bits) match their plain versions, max|err| "
        f"{max(errs):.3e}")


def _attn_case(gen, dtype, b, hkv, g, dh, bs, nb, mb, lengths, window):
    q = torch.randn((b, hkv, g, dh), generator=gen, device=DEV).to(dtype)
    kp = torch.randn((nb, bs, hkv, dh), generator=gen, device=DEV).to(dtype)
    vp = torch.randn((nb, bs, hkv, dh), generator=gen, device=DEV).to(dtype)
    perm = torch.randperm(nb, generator=gen, device=DEV)[: b * mb]
    tables = perm.reshape(b, mb).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    got = paged_attention(q, kp, vp, tables, lens, window=window)
    want = ref.paged_attention_ref(q, kp, vp, tables, lens, window=window)
    return compare(f"paged_attention G{g} dh{dh} win{window} len{lengths} {dtype}", got, want,
                   dtype)


def _attn_quant_case(gen, dtype, b, hkv, g, dh, bs, nb, mb, lengths, window):
    """int8 pools quantized on the card from random rows (page 0 all zero,
    as unwritten pages are), permuted tables; the kernel against its plain
    version."""
    q = torch.randn((b, hkv, g, dh), generator=gen, device=DEV).to(dtype)
    pools = []
    for _ in range(2):
        rows = torch.randn((nb, bs, hkv, dh), generator=gen, device=DEV) * 2
        rows[0] = 0.0
        pools.append(quantize_kv_rows(rows))
    (kc, ks, kz), (vc, vs, vz) = pools
    quant = (ks, kz, vs, vz)
    perm = torch.randperm(nb, generator=gen, device=DEV)[: b * mb]
    tables = perm.reshape(b, mb).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    got = paged_attention_quant(q, kc, vc, *quant, tables, lens, window=window)
    want = ref.paged_attention_ref(q, kc, vc, tables, lens, window=window, quant=quant)
    return compare(f"paged_attention_quant G{g} dh{dh} win{window} len{lengths} {dtype}", got,
                   want, dtype)


def parity_attention(gen, results, kind):
    """``paged_attention`` (kind fp) or ``paged_attention_quant`` (int8)
    against the plain version: G 1/2/4/5, windows, ragged lengths and length
    0 at the decode geometry; lengths at the edges of the 256-position
    chunks for head_dim 32/128/256 and G 1/2/5/8 with windows whose first
    valid position falls mid-chunk; 4096 positions (16 chunks) with and
    without a window; f32 and bf16. Then the kernel's time at the decode
    shape, at 4096 positions and at qwen3-14b's G = 5 (``probe_attention``),
    beside its plain version, SDPA over the gathered pages and its byte
    bound."""
    case = _attn_case if kind == "fp" else _attn_quant_case
    name = "paged_attention" if kind == "fp" else "paged_attention_quant"
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for g, hkv, window in [(1, 16, None), (2, 8, None), (2, 8, 20), (1, 16, 7),
                               (5, 8, None), (5, 8, 20), (4, 8, None)]:
            for lengths in ([1, 17, 80, 96], [0, 17, 80, 0]):
                errs.append(case(gen, dtype, 4, hkv, g, 128, 16, 40, 6, lengths, window))
        for dh in (32, 128, 256):
            for g in (1, 2, 5, 8):
                for window in (None, 50, 100):
                    errs.append(case(gen, dtype, 5, 2, g, dh, 16, 110, 20,
                                     [0, 255, 256, 257, 320], window))
        for window in (None, 1000):
            errs.append(case(gen, dtype, 2, 2, 2, 128, 16, 520, 256, [4096, 2500], window))
    mods = probe_attention.load(Path(__file__).resolve().parent)
    r = {}
    for shape in probe_attention.SHAPES:
        r[shape] = probe_attention.measure(mods, name, shape, gen)
        t = r[shape]
        log(f"timing {name} {shape}: median {t['ms']:.4f} ms, min {t['ms_min']:.4f}, max "
            f"{t['ms_max']:.4f} over 50 launches; SM clock {t['sm_clock'][0]} before, "
            f"{t['sm_clock'][1]} after")
    results[name] = dict(max_abs_err=max(errs), **r["decode"],
                         **{shape: r[shape] for shape in r if shape != "decode"})
    for shape in r:
        if shape != "decode":
            log_extra(name, shape, r[shape])


def invariance_attention(gen):
    """One sequence's output bit for bit alone, in a batch of 4 with other
    lengths, with a wider block table (more chunks: one chunk at length 100
    against the merge kernel) and on other physical pages; fp (bf16) and
    int8 pools, with and without windows."""
    hkv, g, dh, bs, nb = 2, 2, 128, 16, 200
    for kind in ("fp", "int8"):
        rows = [torch.randn((nb, bs, hkv, dh), generator=gen, device=DEV) for _ in range(2)]
        if kind == "fp":
            pools, quant = tuple(t.to(torch.bfloat16) for t in rows), ()
        else:
            (kc, ks, kz), (vc, vs, vz) = (quantize_kv_rows(t * 2) for t in rows)
            pools, quant = (kc, vc), (ks, kz, vs, vz)
        q = torch.randn((4, hkv, g, dh), generator=gen, device=DEV).to(torch.bfloat16)

        def run(qq, tables, lengths, window):
            t = torch.tensor(tables, dtype=torch.int32, device=DEV)
            n = torch.tensor(lengths, dtype=torch.int32, device=DEV)
            if kind == "fp":
                return paged_attention(qq, *pools, t, n, window=window)
            return paged_attention_quant(qq, *pools, *quant, t, n, window=window)

        for length, window in ((100, None), (300, None), (300, 150), (1000, 37)):
            mb = -(-length // bs) + 1
            own = torch.randperm(nb, generator=gen, device=DEV)[:mb]
            alone = run(q[:1], [own.tolist()], [length], window)[0]
            others = [torch.randperm(nb, generator=gen, device=DEV)[:mb].tolist()
                      for _ in range(3)]
            qb = torch.stack([q[1], q[0], q[2], q[3]])
            tabs = [others[0], own.tolist(), others[1], others[2]]
            got = {"in a batch of 4": run(qb, tabs, [5, length, 700, 0], window)[1],
                   "with MB + 20": run(q[:1], [own.tolist() + list(range(20))], [length],
                                       window)[0]}
            dest = torch.randperm(nb, generator=gen, device=DEV)[:mb]
            for pool in pools + quant:  # the same contents on other physical pages
                pool[dest] = pool[own].clone()
            got["on other pages"] = run(q[:1].clone(), [dest.tolist()], [length], window)[0]
            for how, y in got.items():
                if not bitwise_equal(y, alone):
                    raise AssertionError(f"paged_attention ({kind}) length {length} window "
                                         f"{window}: output {how} differs from alone")
    log("batch invariance: paged_attention and paged_attention_quant outputs bit-identical "
        "alone, in a batch of 4, with MB + 20 (merge kernel) and on other physical pages "
        "(lengths 100/300/1000, windows)")


def check_attention_plans():
    """The kernel's own shared memory per block equals the host-side
    attention plan's (pool types, head_dim 32-256, G 1/2/8, pages 8-32)."""
    lib = build.load_library()
    n = 0
    for pool, code in POOL_CODES.items():
        for dh in (32, 96, 128, 256):
            for g in (1, 2, 8):
                for bs in (8, 16, 32):
                    want = attention_plan(4, bs, dh, g, pool)["smem_bytes"]
                    got = lib.repro_paged_attention_smem(bs, dh, g, code)
                    if got != want:
                        raise AssertionError(f"attention plan {pool} dh {dh} G {g} BS {bs}: "
                                             f"shared memory {want} in the plan, {got} in "
                                             f"the kernel")
                    n += 1
    log(f"attention plans: {n} shapes, kernel shared memory == host plan")


def _binary_case(gen, dtype, m, k, n):
    w = torch.randn((k, n), generator=gen, device=DEV)
    b_packed = pack_bits(pad_to_multiple((w >= 0).to(torch.uint8), 8, axis=0), 1, axis=0)
    alpha = w.abs().mean(dim=0, keepdim=True)
    x = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
    got = binary_matmul(x, b_packed, alpha)
    want = ref.binary_matmul_ref(x, b_packed, alpha)
    return compare(f"binary_matmul {m}x{k}x{n} {dtype}", got, want, dtype), (x, b_packed, alpha)


def parity_binary_matmul(gen, results, cfg):
    """Eq. 9 at an expert's gate/up shape (K = d_model, N = d_ff_expert),
    ragged M, a ragged K (neither a multiple of 8 nor of 16) and N off the
    16-column tile; no serving caller, as in the reference."""
    k, n = cfg.d_model, cfg.d_ff_expert
    errs = [_binary_case(gen, dtype, m, kk, nn)[0]
            for dtype in (torch.float32, torch.bfloat16)
            for m, kk, nn in ((16, k, n), (5, k, n), (1, k, n), (24, RAGGED_K + 3, 1400),
                              (64, SHORT_K, 40))]
    m = 16
    err, (x, b_packed, alpha) = _binary_case(gen, torch.bfloat16, m, k, n)
    errs.append(err)
    w_pm = ((unpack_bits(b_packed, 1, axis=0)[:k].float() * 2 - 1) * alpha).to(torch.bfloat16)
    results["binary_matmul"] = dict(
        max_abs_err=max(errs),
        **time_kernel("binary_matmul", lambda: binary_matmul(x, b_packed, alpha)),
        plain_ms=time_ms(lambda: ref.binary_matmul_ref(x, b_packed, alpha))[0],
        library_ms=time_ms(lambda: torch.matmul(x, w_pm))[0],
        shape=f"M={m} K={k} N={n} 1-bit bf16",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes(x, b_packed, alpha) + m * n * 2, 2 * m * k * n,
                         torch.bfloat16))),
    )


# ------------------------------------------------ phase 4: tiny parity
def greedy_logits(cfg, params, prompt, max_new, device, kv_bits=None):
    """Greedy decode of one request through the paged model functions,
    returning the tokens and the logits that chose each of them."""
    ecfg = EngineConfig()
    mcfg = (dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
            if cfg.is_moe else cfg)
    cache = PagedKVCache(cfg, num_blocks=8, block_size=16, max_slots=1,
                         max_blocks_per_slot=8, device=device, kv_bits=kv_bits)
    qs = cache.quant_tables
    slot = cache.acquire_slot(len(prompt) + max_new)
    table = cache.tables_device()
    steps, toks = [], []
    for off in range(0, len(prompt), ecfg.prefill_chunk):
        n = min(ecfg.prefill_chunk, len(prompt) - off)
        chunk = torch.zeros((1, ecfg.prefill_chunk), dtype=torch.long, device=device)
        chunk[0, :n] = torch.as_tensor(prompt[off:off + n], device=device)
        logits, _ = paged_prefill_chunk(params, cache.k, cache.v, table[slot:slot + 1], chunk,
                                        off, n, mcfg, block_size=16, qs=qs)
    for i in range(max_new):
        steps.append(logits[0, -1].float().cpu())
        toks.append(int(torch.argmax(steps[-1])))
        if i == max_new - 1:
            break
        logits, _, _ = _paged_decode_core(
            params, cache.k, cache.v, table, torch.tensor([[toks[-1]]], device=device),
            torch.tensor([len(prompt) + i], device=device, dtype=torch.int32),
            torch.ones(1, dtype=torch.bool, device=device), mcfg, 8, 16, use_otp=True, qs=qs,
        )
    return toks, steps


def sync_free_megastep(cfg, params, kv_bits=None):
    """One decode megastep on the card under ``set_sync_debug_mode("error")``:
    anything inside the horizon that waits on the device (an ``.item()``, a
    ``bincount``, a blocking copy) raises."""
    mcfg = (dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
            if cfg.is_moe else cfg)
    cache = PagedKVCache(cfg, num_blocks=8, block_size=16, max_slots=2,
                         max_blocks_per_slot=4, device=DEV, kv_bits=kv_bits)
    cache.acquire_slot(40)
    cache.acquire_slot(30)
    i32 = dict(dtype=torch.int32, device=DEV)
    args = (params, cache.k, cache.v, cache.tables_device(),
            torch.tensor([[3], [5]], device=DEV), torch.tensor([20, 7], **i32),
            torch.ones(2, dtype=torch.bool, device=DEV), mcfg)
    kw = dict(block_size=16, horizon=4, budgets=torch.tensor([4, 2], **i32),
              eos_ids=torch.full((2,), -1, **i32), qs=cache.quant_tables)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, emits, _, _ = paged_decode_horizon(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if emits.sum(dim=0).tolist() != [4, 2]:
        raise AssertionError(f"sync-free megastep emitted {emits.sum(dim=0).tolist()}")
    log(f"{cfg.name} {'int8' if kv_bits else 'fp'} decode megastep under sync debug mode "
        f"'error': no host sync inside the horizon")


#: the reduced models of phase 4: the compressed MoE (PMQ + OTP), the dense
#: model and the MoE without compression, each from seed 0, f32
TINY = {
    "compressed": ("moonshot-v1-16b-a3b", build_synthetic),
    "dense": (workload.DENSE_ARCH, build_uncompressed),
    "uncompressed MoE": ("moonshot-v1-16b-a3b", build_uncompressed),
}


def tiny_parity(model="compressed", kv_bits=None):
    """A reduced model on the card against the CPU: fp KV, or int8 KV with
    the prefix cache over prompts that share a 32-token prefix (one of them
    repeated: a full hit ending mid-page). The dense and uncompressed-MoE
    models' engines must also give the tokens of the dense-cache oracle
    (paged == dense) on the card."""
    arch, make = TINY[model]
    cfg = get_config(arch).reduced()
    params_cpu = make(cfg, seed=0, device="cpu")
    params_gpu = to_device(params_cpu, DEV)
    rng = np.random.default_rng(1)
    if kv_bits is None:
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (20, 33, 7)]
    else:
        system = rng.integers(0, cfg.vocab_size, size=32)
        prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, size=n)])
                   .astype(np.int32) for n in (10, 5)]
        prompts.append(prompts[1].copy())
    ecfg = EngineConfig(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
                        prefill_chunk=16, decode_horizon=4, kv_bits=kv_bits,
                        prefix_cache=kv_bits is not None)
    outs = {}
    for name, dev, params in (("card", DEV, params_gpu), ("cpu", "cpu", params_cpu)):
        eng = PagedServingEngine(cfg, params, ecfg, device=dev)
        outs[name] = eng.serve(Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(prompts))
    worst = 0.0
    for i, p in enumerate(prompts):
        tg, lg = greedy_logits(cfg, params_gpu, p, 12, DEV, kv_bits)
        tc, lc = greedy_logits(cfg, params_cpu, p, 12, "cpu", kv_bits)
        for s, (a, b) in enumerate(zip(lg, lc)):
            rel = (a - b).abs().max().item() / b.abs().max().item()
            worst = max(worst, rel)
            if rel > 1e-3:
                raise AssertionError(f"{model} request {i} step {s}: logits differ by "
                                     f"{rel:.2e}·max")
            if tg[s] != tc[s]:
                top2 = torch.topk(b, 2).values
                gap = (top2[0] - top2[1]).item() / b.abs().max().item()
                if gap >= 1e-4:
                    raise AssertionError(f"{model} request {i} step {s}: tokens {tg[s]} != "
                                         f"{tc[s]} with a top-2 gap of {gap:.2e}·max")
                log(f"  request {i} diverges at step {s} on a genuine tie (gap {gap:.1e})")
                break
        if outs["card"][i] != outs["cpu"][i] and tg == tc:
            raise AssertionError(f"{model} request {i}: engine tokens differ between card "
                                 f"and cpu")
        if model != "compressed":
            mcfg = eng.model_cfg
            dense, _ = dense_greedy_reference(mcfg, params_gpu, p, 12, device=DEV)
            if dense != outs["card"][i]:
                raise AssertionError(f"{model} request {i}: the paged engine's tokens differ "
                                     f"from the dense-cache oracle's on the card")
    kind = "fp KV" if kv_bits is None else "int8 KV + prefix cache"
    log(f"tiny parity ({model}, {kind}): {len(prompts)} requests, engine tokens card == cpu: "
        f"{outs['card'] == outs['cpu']}, worst per-step logit diff {worst:.2e}·max"
        + ("; paged == dense-cache oracle on the card" if model != "compressed" else ""))
    sync_free_megastep(cfg, params_gpu, kv_bits)


# ------------------------------------------------ phase 5: full width
#: kernels each serving path must launch (binary_matmul has no serving caller)
FP_PATH = ("quant_matmul", "moe_gmm_swiglu", "moe_gmm", "paged_attention")
INT8_PATH = ("quant_matmul", "moe_gmm_swiglu", "moe_gmm", "paged_attention_quant")
DENSE_PATH = UNCOMPRESSED_MOE_PATH = ("paged_attention",)  # every linear is a bf16 matmul


def _serve(cfg, params, ecfg, reqs):
    eng = PagedServingEngine(cfg, params, ecfg, device=DEV)
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    return eng, out


def _drive(name, cfg, params, ecfg, reqs, needed):
    """One serving path with the launch counts set to 0 just before it and
    read just after; fails on a bad output or a kernel of the path that
    never launched (or the other attention kernel launching)."""
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    eng, out = _serve(cfg, params, ecfg, reqs)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for rid, toks in out.items():
        if len(toks) != workload.MAX_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{name} request {rid}: bad output {toks}")
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched while serving: {missing}")
    stray = [k for k, v in launches.items() if v and k not in needed]
    if stray:
        raise AssertionError(f"{name}: kernels off this path launched: {stray}")
    return eng, out, launches, peak


def compressed_paths():
    """The PMQ + OTP model's fp, int8 KV + shared-prefix and tenant-mix
    paths: their launches, and the fp path's expert bytes per decode step and
    in all."""
    t0 = time.perf_counter()
    cfg, params = workload.build(DEV)
    torch.cuda.synchronize()
    log(f"full width: {cfg.name} d_model={cfg.d_model} layers={cfg.num_layers} "
        f"experts={cfg.num_experts} top-{cfg.top_k} vocab={cfg.vocab_size} bf16; "
        f"built in {time.perf_counter() - t0:.1f} s; "
        f"weights on device {weight_bytes(params) / 1e9:.3f} GB")

    # the fp path
    eng, out, fp_launches, peak = _drive("fp path", cfg, params, workload.ENGINE,
                                         workload.requests(cfg), FP_PATH)
    _, out2 = _serve(cfg, params, workload.ENGINE, workload.requests(cfg))
    if out2 != out:
        raise AssertionError("fp path: a second engine served different tokens")
    s = eng.summary()
    log(f"full width serving (fp KV): {len(out)} requests x {workload.MAX_NEW} tokens; "
        f"peak device memory {peak / 1e9:.3f} GB; TTFT mean {s['ttft_mean_s']:.3f} s "
        f"max {s['ttft_max_s']:.3f} s; decode {s['decode_tokens']} tokens in "
        f"{s['decode_s']:.3f} s = {s['decode_tokens_per_s']:.1f} tokens/s; "
        f"OTP expert activation {s['expert_activation']:.4f}; launches {fp_launches}; "
        f"second engine (full depth) tokens identical")
    log("full width serving summary (fp KV): " + json.dumps(s))
    experts = (float(np.mean(profile_decode.expert_step_bytes(eng))),
               sum(weight_bytes(p["moe_ce"]) for p in params["layers"]))

    # the int8 KV + shared-prefix path
    reqs = workload.shared_prefix_requests
    eng, out, q_launches, peak = _drive("int8 prefix path", cfg, params, workload.SHARED_PREFIX,
                                        reqs(cfg), INT8_PATH)
    s = eng.summary()
    if (s["prefill_chunks"], s["cow_copies"]) != (workload.SHARED_PREFIX_CHUNKS,
                                                  workload.SHARED_PREFIX_COW_COPIES):
        raise AssertionError(f"int8 prefix path: {s['prefill_chunks']} prefill chunks and "
                             f"{s['cow_copies']} COW copies, expected "
                             f"{workload.SHARED_PREFIX_CHUNKS} and "
                             f"{workload.SHARED_PREFIX_COW_COPIES}")
    if out[2] != out[3]:
        raise AssertionError("int8 prefix path: the retried prompt served other tokens")
    off = dataclasses.replace(workload.SHARED_PREFIX, prefix_cache=False)
    eng_off, out_off = _serve(cfg, params, off, reqs(cfg))
    if out_off != out:
        raise AssertionError("int8 prefix path: tokens differ without the prefix cache")
    _, out2 = _serve(cfg, params, workload.SHARED_PREFIX, reqs(cfg))
    if out2 != out:
        raise AssertionError("int8 prefix path: a second engine served different tokens")
    c = eng.cache
    bf16_pool = 2 * cfg.num_layers * c.k.shape[1] * cfg.num_kv_heads * cfg.head_dim * 2
    log(f"full width serving (int8 KV + prefix cache): {len(out)} requests x "
        f"{workload.MAX_NEW} tokens; prefill chunks {s['prefill_chunks']} (without the cache "
        f"{eng_off.summary()['prefill_chunks']}), COW copies {s['cow_copies']}, prefix hits "
        f"{s['prefix_hits']} reusing {s['cached_tokens']} prompt tokens; peak device memory "
        f"{peak / 1e9:.3f} GB; KV pool {c.pool_bytes} bytes int8 codes + tables against "
        f"{bf16_pool} bytes bf16 ({c.pool_bytes / bf16_pool:.4f}); TTFT mean "
        f"{s['ttft_mean_s']:.3f} s max {s['ttft_max_s']:.3f} s; decode {s['decode_tokens']} "
        f"tokens in {s['decode_s']:.3f} s = {s['decode_tokens_per_s']:.1f} tokens/s; launches "
        f"{q_launches}; tokens identical without the cache and in a second engine")
    log("full width serving summary (int8 KV + prefix cache): " + json.dumps(s))
    mix_launches = tenant_mix_path(cfg, params)
    return fp_launches, q_launches, mix_launches, experts


def _tenant_mix_run(cfg, params, ecfg, faults):
    t0 = time.perf_counter()
    eng = PagedServingEngine(cfg, params, ecfg, faults, device=DEV)
    out = workload.serve_tenant_mix(eng, workload.tenant_mix_requests(cfg))
    torch.cuda.synchronize()
    return eng, out, time.perf_counter() - t0


def tenant_mix_path(cfg, params):
    """The tenant mix through the control plane, four times (see the module
    docstring): its launches; fails on any check."""
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    plan = workload.tenant_mix_faults()
    a, out_a, wall_a = _tenant_mix_run(cfg, params, workload.TENANT_MIX, plan)
    b, out_b, wall_b = _tenant_mix_run(cfg, params, workload.TENANT_MIX, plan.replay())
    c, out_c, wall_c = _tenant_mix_run(
        cfg, params, dataclasses.replace(workload.TENANT_MIX, policy="fcfs"), None)
    d, out_d, wall_d = _tenant_mix_run(
        cfg, params, dataclasses.replace(workload.TENANT_MIX, policy="priority"), None)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    errors = {eng: {rid: type(e).__name__ for rid, e in eng.errors.items()}
              for eng in (a, b, c, d)}
    if (out_b, errors[b], b.metrics.counters(), b.tracer.deterministic_jsonl()) != (
            out_a, errors[a], a.metrics.counters(), a.tracer.deterministic_jsonl()):
        raise AssertionError("tenant mix: the fault-plan replay differs from the first run")
    events = validate_events(a.tracer.events)
    validate_chrome_trace(a.tracer.chrome_trace())
    poisoned = workload.TENANT_MIX_POISONED
    if out_a[poisoned] or not isinstance(a.errors.get(poisoned), PoisonedRequest):
        raise AssertionError(f"tenant mix: request {poisoned} was not poisoned cleanly")
    counters = a.metrics.counters()
    schedule = {k: counters[k] for k in workload.TENANT_MIX_COUNTERS}
    if schedule != workload.TENANT_MIX_COUNTERS:
        bad = [k for k in schedule if schedule[k] != workload.TENANT_MIX_COUNTERS[k]]
        raise AssertionError(f"tenant mix: schedule counters {bad} differ from the "
                             f"reference's: {json.dumps({k: schedule[k] for k in bad})}")
    if not counters["sheds"]:
        raise AssertionError("tenant mix: nothing was shed")
    max_new = {req.rid: req.max_new for _, req in workload.tenant_mix_requests(cfg)}
    runs = ((a, out_a), (c, out_c), (d, out_d))
    for eng, out in runs:
        for rid, toks in out.items():
            if toks and (len(toks) != max_new[rid]
                         or not all(0 <= t < cfg.vocab_size for t in toks)):
                raise AssertionError(f"tenant mix request {rid}: bad output {toks}")
    compared = 0
    for i, (e1, o1) in enumerate(runs):
        for e2, o2 in runs[i + 1:]:
            for rid, toks in o1.items():
                if toks and o2[rid] and rid not in e1.errors and rid not in e2.errors:
                    compared += 1
                    if o2[rid] != toks:
                        raise AssertionError(f"tenant mix request {rid}: tokens depend on "
                                             f"the policy")
    missing = [k for k in FP_PATH if launches[k] == 0]
    stray = [k for k, v in launches.items() if v and k not in FP_PATH]
    if missing or stray:
        raise AssertionError(f"tenant mix: kernels never launched {missing}, "
                             f"off the path {stray}")
    s = a.summary()
    tokens = {t: sum(len(out_a[r.rid]) for _, r in workload.tenant_mix_requests(cfg)
                     if r.tenant == t) for t, *_ in workload.TENANTS}
    ttft = {t: float(np.mean(xs)) for t, xs in sorted(a.metrics.ttft_by_tenant.items())}
    log(f"full width serving (tenant mix): policy fair, {workload.TENANT_MIX.num_blocks} "
        f"pages; tokens per tenant {tokens}; sheds "
        f"{[(x['rid'], x['tenant']) for x in counters['sheds']]}; poisoned {poisoned}; TTFT "
        f"mean per tenant (s) { {t: round(v, 3) for t, v in ttft.items()} }; decode "
        f"{s['decode_tokens']} tokens in {s['decode_s']:.3f} s = "
        f"{s['decode_tokens_per_s']:.1f} tokens/s; peak device memory {peak / 1e9:.3f} GB; "
        f"trace events {events}; wall (a) {wall_a:.1f} s (b) {wall_b:.1f} s (c) "
        f"{wall_c:.1f} s (d) {wall_d:.1f} s; replay identical (tokens, errors, counters, "
        f"trace); schedule counters = reference's; {compared} cross-policy token "
        f"comparisons equal; launches {launches}")
    log("full width serving summary (tenant mix, fair + faults): " + json.dumps(s))
    log("full width serving summary (tenant mix, fcfs): " + json.dumps(c.summary()))
    return launches


def plain_path(name, make, ecfg, needed):
    """A dense or uncompressed-MoE model built on the card at full width
    (``make``), served twice with ``ecfg`` on the fp workload's requests:
    its launches, and its expert bytes per decode step and in all."""
    t0 = time.perf_counter()
    cfg, params = make(DEV)
    torch.cuda.synchronize()
    weights = weight_bytes(params)
    log(f"full width: {cfg.name} ({cfg.family}) d_model={cfg.d_model} layers={cfg.num_layers} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff_expert or cfg.d_ff} "
        f"experts={cfg.num_experts} vocab={cfg.vocab_size} {cfg.dtype}; built in "
        f"{time.perf_counter() - t0:.1f} s; weights on device {weights / 1e9:.3f} GB")
    eng, out, launches, peak = _drive(name, cfg, params, ecfg, workload.requests(cfg), needed)
    _, out2 = _serve(cfg, params, ecfg, workload.requests(cfg))
    if out2 != out:
        raise AssertionError(f"{name}: a second engine served different tokens")
    s = eng.summary()
    experts = (float(np.mean(profile_decode.expert_step_bytes(eng))),
               sum(weight_bytes(p["moe"]["experts"]) for p in params["layers"] if "moe" in p))
    log(f"full width serving ({name}, {cfg.name}): {len(out)} requests x {workload.MAX_NEW} "
        f"tokens; weights on device {weights / 1e9:.3f} GB; peak device memory "
        f"{peak / 1e9:.3f} GB; TTFT mean {s['ttft_mean_s']:.3f} s max {s['ttft_max_s']:.3f} s; "
        f"decode {s['decode_tokens']} tokens in {s['decode_s']:.3f} s = "
        f"{s['decode_tokens_per_s']:.1f} tokens/s; launches {launches}; second engine "
        f"(full depth) tokens identical")
    log(f"full width serving summary ({name}): " + json.dumps(s))
    return launches, experts


def free_model() -> None:
    """Release the last path's model (its references died with the path's
    function) and the allocator's cached blocks before the next is built."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated after freeing the model: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")


def full_width():
    """Phase 5: the compressed model's three paths, then — the compressed
    model freed — the dense and the uncompressed-MoE models', each freed
    before the next is built. Returns each path's launches."""
    fp_launches, q_launches, mix_launches, (fp_step, fp_all) = compressed_paths()
    free_model()
    dense_launches, _ = plain_path("dense path", workload.build_dense, workload.DENSE,
                                   DENSE_PATH)
    free_model()
    moe_launches, (moe_step, moe_all) = plain_path(
        "uncompressed MoE path", workload.build_uncompressed_moe, workload.UNCOMPRESSED_MOE,
        UNCOMPRESSED_MOE_PATH)
    free_model()
    log(f"expert bytes of {workload.ARCH} on the device: uncompressed {moe_all / 1e9:.3f} GB, "
        f"PMQ {fp_all / 1e9:.3f} GB ({moe_all / fp_all:.2f}x); read per decode step: "
        f"uncompressed {moe_step / 1e9:.3f} GB (every expert of every layer), PMQ + OTP fp "
        f"path {fp_step / 1e9:.3f} GB (the routed experts' packed rows; {moe_step / fp_step:.2f}x)")
    return {"fp serving": fp_launches, "int8 KV + prefix serving": q_launches,
            "tenant mix serving": mix_launches, "dense serving": dense_launches,
            "uncompressed MoE serving": moe_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    device_line = smi.stdout.strip().splitlines()[0]
    log(device_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    log(f"build: {build.timed_build():.1f} s ({build.BUILD_DIR})")

    gen = torch.Generator(device=DEV).manual_seed(0)
    results = {}
    cfg = get_config("moonshot-v1-16b-a3b")
    check_tile_plans(cfg)
    parity_quant_matmul(gen, results)
    parity_moe(gen, results, cfg)
    parity_split_k(gen, results, cfg)
    invariance_quant_matmul(gen)
    invariance_moe_gmm(gen, cfg)
    check_attention_plans()
    parity_attention(gen, results, "fp")
    parity_attention(gen, results, "int8")
    invariance_attention(gen)
    invariance_binary_matmul(gen, cfg)
    build.reset_launches()
    parity_binary_matmul(gen, results, cfg)
    binary_launches = build.LAUNCHES["binary_matmul"]
    for name, r in results.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {name} [{r['shape']}]: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
            f"max|err| {r['max_abs_err']:.3e}")

    for model in TINY:
        tiny_parity(model)
    tiny_parity(kv_bits=8)
    paths = full_width()

    # launches of each kernel on the path that runs it; binary_matmul has no
    # serving caller (none in the reference either), so its count is phase 3's
    counted = {name: (paths["fp serving"][name], "fp serving") for name in FP_PATH}
    counted["paged_attention_quant"] = (paths["int8 KV + prefix serving"]["paged_attention_quant"],
                                        "int8 KV + prefix serving")
    counted["binary_matmul"] = (binary_launches, "phase 3 (no serving caller)")
    kernels = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": counted[name][0], "path": counted[name][1],
         "launches_by_path": {path: n[name] for path, n in paths.items() if n[name]},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         **{key: r[key] for key in ("ms_min", "ms_max", "sm_clock", "prefill", "long", "decode_g5",
                                     "k7168", "k17408", "split_k_max_abs_err") if key in r}}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
