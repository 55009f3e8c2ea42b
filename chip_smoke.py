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
   qwen3-14b), windows starting mid-chunk, gemma3-27b's G = 2 and kimi-k2's
   G = 8 at lengths 1088-1120 with a 1024 window; f32 and bf16); bitwise batch
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
   the attention kernels at the decode shape, at 4096 positions (``long``),
   at G = 5 (``decode_g5``), at G = 2 over a 1024 window at length 1104
   (``window_g2``) and at G = 8 (``decode_g8``); then the bf16 dequant
   GEMMs where K outgrows one item's shared memory and is walked in chunks — ``quant_matmul``, ``moe_gmm``
   and ``moe_gmm_swiglu`` at K = 7168 (kimi-k2's d_model; bits 1-4, bm 8
   and 16) and ``quant_matmul`` at K = 17408 (qwen3-14b's d_ff, 4 bits):
   parity, batch invariance and one timing each (``k7168``, ``k17408``;
   ``quant_matmul`` also at kimi-k2's ``wo``, K = 8192 → N = 7168: ``k8192``,
   each timed shape also checked); every GEMM shape of kimi-k2's served
   path against its plain version: ``quant_matmul`` at its five (K, N) at
   M = 4 and 16 (bits 1-4), ``moe_gmm_swiglu`` and ``moe_gmm`` on its
   363-expert 2-bit bucket at drop-free decode capacity; then the three
   dequant GEMMs under autograd (``kernels/grad.py``: the kernel forward, a
   plain backward) against autograd through their plain versions at the
   full-width OTP training's shapes (``grad_parity``: ``x``'s gradient
   within ``TOL``, dead row blocks' exactly zero, each side's time and
   peak memory printed); then ``quant_matmul`` at the ``scan`` expert
   FFN's shapes (``SCAN_QMM``: bits 1/2/3, M = 8 and 32, K = 2048 → N =
   1408 and K = 1408 → N = 2048) against its plain version, with one
   timing (``scan``);
4. tiny end-to-end parity: reduced configs (f32, one seed) served on the
   card and on the CPU — ``moonshot-v1-16b-a3b`` PMQ + OTP with fp KV and
   with int8 KV plus the prefix cache, ``qwen3-14b`` (dense) and
   ``moonshot-v1-16b-a3b`` without compression with fp KV — identical
   greedy tokens, per-step logits within 1e-3·max|logit|, and for the
   dense and uncompressed models the dense-cache oracle's tokens; then a
   decode megastep of each on the card under
   ``set_sync_debug_mode("error")``, which fails if anything inside the
   horizon waits on the host (after a page grow); then each reduced model
   with page growth on a 4-page pool, where one of three requests is
   preempted, served on the card and on the CPU in swap and in recompute
   mode with fp KV and in swap mode with int8 KV: tokens card == CPU ==
   the same model's unpressured run, ``counters()`` card == CPU; then the
   reduced compressed model with its experts host-offloaded (3 of 8 slots:
   synchronous at H = 1, tiered at H = 4; with 16 experts, 8 slots, async at
   H = 1 with a committed batch), tokens card == CPU == the all-resident run
   and ``counters()`` card == CPU, and
   ``issue_async`` on the card under ``set_sync_debug_mode("error")``; then
   the reduced ``moonshot-v1-16b-a3b`` (f32, seed 0) compressed by the
   port's pipeline on the card and on the CPU: the same PMQ plan, packed
   codes equal on ≥ 99.9 % of their bytes (the count printed), greedy tokens
   card == CPU, each on its own tree; and a sampled (T = 0.8) megastep of
   the card's tree under ``set_sync_debug_mode("error")``; then 3 steps of
   ``train_otp`` on the reduced PMQ + OTP model on the card and on the CPU
   with the same draws (routers within 2e-3, history within 1e-3
   relative); 3 AdamW steps with 8-bit moments on the reduced
   ``tinyllama-1.1b``, the card applying the CPU's gradients (codes,
   scales and params apart in at most 1e-4 of their elements); and the
   reduced PMQ + OTP model served with ``ffn_backend="ref"``, ``"grouped"``
   and ``"scan"`` on the card and ``"scan"`` on the CPU (the same greedy
   tokens; the grouped kernels launch only under ``grouped``, ``scan``
   launches ``quant_matmul`` alone) and a ``scan`` decode megastep under
   ``set_sync_debug_mode("error")``; then the reduced whisper, recurrentgemma
   (also at 5 layers, so its trailing recurrent blocks run) and xlstm
   (also on 72-token prompts, so the mLSTM's chunked scan runs), f32, seed
   0, prefilled and decoded 8 greedy steps on the card and on the CPU:
   identical tokens, per-step logits within 1e-3·max|logit|, no kernel
   launched;
5. first ``DRYRUN`` (:func:`dryrun_path`): the dry run of three production
   cells on ``meta`` on the host (``tinyllama-1.1b`` ``train_4k``,
   ``moonshot-v1-16b-a3b`` ``decode_32k`` with its kernels counted,
   ``xlstm-350m`` ``train_4k``; rank 0 of the single-pod 16 × 16 mesh, no
   process), each printed with its roofline terms, dominant term and bytes
   a card and gated on FLOPs above 0; then ``build_step``'s quantized
   ``prefill_step`` of the PMQ + OTP model's first 12 layers, 4 × 64
   tokens, counted on ``meta`` and run on the card: each kernel's counted
   launches equal its ``LAUNCHES`` on the card, the counted peak over the
   card's within ``DRYRUN_PEAK_BAND``, the roofline time printed beside the
   step's ((c) and (d), the first steps of ``TRAIN`` and of the xlstm
   training, counted on ``meta`` and run on the card, come with those
   paths below: the counted peak over the card's within
   ``DRYRUN_TRAIN_BAND``); then full-width serving of the two workloads of ``repro_torch.launch.workload``
   (``moonshot-v1-16b-a3b`` at full width and all 48 layers in bf16, one
   set of weights) through ``PagedServingEngine``, each path with the
   launch counts set to 0 just before it and read just after:
   the fp path (4 requests of 64 prompt and 32 new tokens; its kernels must
   launch, a second engine must emit byte-identical tokens), then the int8
   KV + shared-prefix path (``SHARED_PREFIX``: ``paged_attention_quant``
   must launch, the fp attention kernel must not; tokens byte-identical to
   an int8 engine without the prefix cache and to a second prefix engine;
   prefill chunks and copy-on-write copies as the reference's rules give);
   then the tenant mix (``TENANT_MIX``, on the first 12 of the 48 layers:
   batch, chat and interactive tenants on a 14-page pool through the
   control plane, ``fair`` policy, a TTFT
   budget, a ``pool`` and a ``logits`` fault, ``spans`` tracing) served four
   times — (a) as set, (b) a fresh engine replaying the fault plan, (c)
   ``fcfs`` and (d) ``priority`` without faults: (a) and (b) identical in
   tokens, typed errors, ``counters()`` and deterministic trace; the trace
   valid; the poisoned request empty with ``PoisonedRequest``; (a)'s schedule
   counters the reference engine's (``workload.TENANT_MIX_COUNTERS``); every
   rid completed in two runs with the same tokens in both; the fp path's
   kernels launched and no other; then the preemption path (``PREEMPT``, on
   the first 12 of the 48 layers: the fp workload on an 11-page pool with
   page growth) served twice after an unpressured run on the fp geometry,
   the token oracle — (a) in swap mode: one preemption (rid 1, its 5 pages
   swapped out and back in, 7,864,320 bytes each way at 12 layers), 3 page
   grows, the schedule counters the reference engine's
   (``workload.PREEMPT_COUNTERS``), every rid's tokens byte-identical to
   the unpressured run's; (b) with ``PREEMPT_FAULTS`` corrupting rid 1's
   payload at swap-in, at trace level ``full``: one swap fallback, no
   swap-in bytes, 21 prefill chunks, a valid trace with the reference's
   event count on this schedule, every rid's tokens byte-identical to the
   unpressured run's, rid 1's after its re-prefill too (the resume rewrites
   the decode-era rows through the decode kernel, none of them dropped by
   the chunk's capacity, so bit for bit); the fp path's kernels
   launched and no other; then the expert-offload path (``OFFLOAD``, on
   the first 12 of the 48 layers: one request of 16 + 4 tokens at H = 1
   under ``resident_experts=32`` of 64 slots) served three times — (c)
   all-resident, the token oracle; (a)
   synchronous at trace level ``spans``; (b) ``async_offload`` with the
   tier store in a temporary directory, a 256 MiB host row cache and two
   corrupted upload payloads: tokens of (a) and (b) those of (c); (a) misses,
   replays its prefill chunk, grows a budget and keeps fewer expert bytes
   than all-resident, its trace valid; (b) fetches from disk, retries the
   corrupted uploads, degrades nothing, and stages uploads where its plans
   held any; in each of (a) and (b), counted apart from (c) and from each
   other, the fp path's kernels launched and no other; then ``SCAN`` (on
   the first 12 of the 48 layers: the fp workload with
   ``ffn_backend="scan"``: ``quant_matmul`` and ``paged_attention``
   launch and no grouped GEMM, a second engine's tokens identical, the
   first drift from a ``grouped`` engine's tokens on the same layers at a
   near-tie of ``ORACLE_GAP_ULPS`` (the teacher-forced dense-cache
   oracle's gap between the two tokens, or a routing margin up to there);
   tokens/s, TTFT and launches printed); each path's (and each offload
   run's) engines are collected before the next starts, so each peak is its
   own; then, the model freed, ``EP``: the first 12 layers built with
   ``ep=4`` (buckets 4 / 60 / 4) and driven by 4 ranks on this card over
   gloo (``repro_torch.launch.ep_ranks``; the kernels built by phase 2,
   the weights shared with the ranks): layer 0's compressed MoE at decode
   (4 × 1) and prefill (4 × 64) on ``data=1 × model=4`` and ``data=2 ×
   model=2`` with ``grouped`` and ``scan``, each rank within ``TOL`` of the
   single-process layer on its data shard's tokens, ``mask_l1`` equal, its
   kernels launched on every rank, each rank's expert bytes its bucket rows
   and summing to the layer's; then the dense-cache prefill of the fp
   prompts and 16 greedy tokens on ``data=1 × model=4``, held to the
   single-process run (a first drift only at a near-tie), with each rank's
   tokens/s, peak memory and wall and the route each collective took;
   then, that model freed, ``qwen3-14b`` (dense, 40 layers) and
   ``moonshot-v1-16b-a3b`` without compression (48 layers, ~57.8 GB), each
   built on the card, served on the fp geometry (``paged_attention`` must
   launch and no other kernel; a second engine must emit the same tokens;
   each request's agreement with the dense-cache oracle printed, and at its
   first differing step the oracle's gap to the engine's token in bf16
   ulps, beside the least routing margins up to there in an MoE model: a
   divergence that no near-tie of ``ORACLE_GAP_ULPS`` explains fails the
   phase once every path has printed) and freed; a line sets the uncompressed model's expert bytes
   against the compressed one's, on the device and per decode step; then
   ``COMPRESS``: the same uncompressed weights compressed on the card by the
   port's pipeline — (a) ``calibrate`` on 4 × 64 tokens, (b) ``compute_eps``
   (9264 MoE-layer forwards over 128 tokens; eps finite, eps[1 bit] ≥
   eps[3 bit] for > 90 % of the experts), (c) ``run_pmq`` (the DP plan's
   objective equal to the MILP's within 1e-9 relative), (d) GPTQ on layer 0
   (192 matrices; its MoE output error on the calibration inputs below 1.05×
   RTN's on the same plan), (e) ``compress_for_serving`` freeing each
   layer's float weights as it goes (2.0625 average bits, expert buckets of
   48 · (64 · 540,672 + 132 · 1,081,344) B, the peak printed), (f) the fp
   workload twice (``FP_PATH``'s kernels and no other, tokens identical,
   greedy agreement with the uncompressed model's printed, not gated), (g)
   sampled at T = 0.8 on the first 12 layers with seeds 0, 0 (identical)
   and 1 (the positions that differ printed); then ``OTP``, on the first
   12 layers of that tree: (h) routers trained at full width by
   ``train_otp`` (``workload.OTP_TRAIN``: 20 steps of 4 × 64
   synthetic calibration tokens, λ = 2, τ = 1, lr 5e-3; ``quant_matmul``,
   ``moe_gmm_swiglu`` and ``moe_gmm`` launched and no other; the peak
   beside its prediction, the time a step, mask ratio and KL of the first
   and last five steps), (i) the fp workload served twice with the trained
   routers (``FP_PATH``'s kernels, tokens identical, OTP activation below
   1.0, the oracle gate); then four more of the reference's configs at full
   width, each built after the previous model is freed and served twice on
   its workload (``paged_attention`` alone, or ``FP_PATH``'s kernels for the
   compressed one, and no other; tokens identical; each request's agreement
   with the dense-cache oracle held to ``ORACLE_GAP_ULPS`` as above): ``VLM``
   (``llava-next-mistral-7b``, 32 layers, on tokens; then the dense-cache
   prefill of 2880 patch embeddings ahead of a 64-token prompt, ``pos`` =
   2944, 16 greedy tokens identical on a second run, no kernel launched),
   ``WINDOWED`` (``gemma3-27b``, 62 layers, 2 requests of 1088 + 32 tokens
   past its 1024-token window), ``COMMAND_R`` (``command-r-35b``, all 40
   layers, 60.6 GB; the dry run's count of a prefill step of the same 4 ×
   64 tokens printed beside its peak) and ``WIDE_MOE`` (``kimi-k2-1t-a32b`` at 2
   of its 61 layers, PMQ + OTP, 384 experts: expert bytes, OTP activation
   and the drop-free dispatch buffer printed); then the three
   non-transformer families at full width in bf16, each built after the
   previous model is freed and decoded greedily twice through the
   dense-cache ``prefill`` and ``decode_step`` (the paged engine refuses
   them, as the reference's does): ``WHISPER`` (``whisper-small``, 4
   requests of 64 tokens over 1500 frames), ``RECURRENT``
   (``recurrentgemma-2b``, 2 requests of 2080 tokens, decoding past its
   2048 window) and ``XLSTM`` (``xlstm-350m``, 4 × 64), 32 tokens each:
   the two runs' tokens identical, each held to a teacher-forced forward
   over prompt and tokens (a first drift must start at a near-tie within
   ``ORACLE_GAP_ULPS``), no kernel launched, weight bytes, peak, prefill
   wall and tokens/s printed; then ``xlstm-350m`` in f32 (its first 12
   layers) trained 3 steps of 4 × 256 tokens through
   ``launch.train.train_step`` (finite losses, the peak beside its
   prediction; ``DRYRUN`` (d) on its first step); and last ``TRAIN``
   (``DRYRUN`` (c) on its first step): ``tinyllama-1.1b`` at full width in
   f32 (its first 11 layers) trained for 20 steps of 8 × 128
   tokens through ``launch.train.train_step`` (AdamW, 32-bit moments)
   under ``torch.use_deterministic_algorithms``: the loss falls; the state
   is checkpointed and restored into a fresh trainer whose next step's loss
   and params equal the uninterrupted run's bit for bit (no kernel of the
   port runs on the dense training path); then the same 20 steps with 8-bit
   moments, their losses reported beside the 32-bit ones, not gated; and
   ``DRYRUN`` (e): one step of the same model in bf16, counted and run as
   (c). Every training path runs under the full configs' ``remat="block"``
   and prints its peak and s a step beside those before it. The host wall of the
   build, of phases 1-4 and of each path of phase 5 is printed;
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
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

# cuBLAS's deterministic workspace, for the training path's bit-exact resume
# (read when cuBLAS first runs, so set before any device work)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.otp_train import OTPTrainConfig, train_otp  # noqa: E402
from repro_torch.data.pipeline import HostDataLoader, make_calibration_tokens  # noqa: E402
from repro_torch.kernels import grad as grad_mod, ops as kernel_ops  # noqa: E402
from repro_torch.launch.train import batch_to, train_step  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.core import compressed_moe as cm_mod, otp as otp_mod, pipeline  # noqa: E402
from repro_torch.core.compressed_moe import compressed_moe_layer, gmm_block_rows  # noqa: E402
from repro_torch.core.quantizers import quantize_parts  # noqa: E402
from repro_torch.core.synthetic import (  # noqa: E402
    bucket_counts,
    build_synthetic,
    build_uncompressed,
)
from repro_torch.core.tree import (  # noqa: E402
    to_device,
    tree_leaves,
    tree_map,
    tree_paths,
    tree_unflatten,
    weight_bytes,
)
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.launch.counting import nbytes  # noqa: E402
from repro_torch.core.quantizers import quantize_kv_rows  # noqa: E402
from repro_torch.core.packing import pack_bits, pad_to_multiple, unpack_bits  # noqa: E402
from repro_torch.kernels.binary_matmul import (  # noqa: E402
    binary_matmul,
    binary_matmul_work,
    binary_plan,
)
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_swiglu, moe_gmm_work  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    POOL_CODES,
    attention_plan,
    paged_attention,
    paged_attention_quant,
)
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_work, tile_plan  # noqa: E402
from repro_torch.launch import ep_ranks, probe_attention, profile_decode, workload  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import linear  # noqa: E402
from repro_torch.models.moe import dispatch_capacity, moe_layer  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.xlstm import MLSTM_CHUNK  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _paged_decode_core,
    layer_windows_static,
    paged_decode_horizon,
    paged_prefill_chunk,
)
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    ExpertOffloadManager,
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
    """The least time of a launch in ms: its bytes over HBM's rate or its
    operations over their dtype's peak, the larger (the kernels' count
    functions give the three: ``quant_matmul_work`` and the others)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_weights(gen, e, k, n, bits, group=128):
    """Quantized random expert stack ``[e, K, N]`` (packed, scale, zero),
    drawn and quantized in slices of at most 2^28 f32 elements of the expert
    axis (kimi-k2's 2-bit bucket is 21.3 GB in f32), the leaves
    concatenated."""
    step = max(1, (1 << 28) // (k * n))
    parts = [quantize_parts(torch.randn((min(step, e - e0), k, n), generator=gen, device=DEV)
                            * k**-0.5, bits, group, refine=False) for e0 in range(0, e, step)]
    return _cat_experts(parts)


def _cat_experts(parts):
    """Concatenate along the expert axis packed stacks ``(data, scale,
    zero)``, ``data`` a tuple of planes at 3 bits."""
    if len(parts) == 1:
        return parts[0]
    cat = lambda ts: (tuple(torch.cat(p) for p in zip(*ts)) if isinstance(ts[0], tuple)
                      else torch.cat(ts))
    return tuple(cat([p[i] for p in parts]) for i in range(3))


def _pick_experts(w, ids):
    """Experts ``ids`` of a packed stack ``(data, scale, zero)``."""
    pick = lambda t: (tuple(x.index_select(0, ids) for x in t) if isinstance(t, tuple)
                      else t.index_select(0, ids))
    return tuple(pick(t) for t in w)


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
    results["quant_matmul"] = {**r, "max_abs_err": max(errs + [r["max_abs_err"]])}
    r = _time_quant_matmul("quant_matmul prefill", 16, 2048, 2816, 4, gen)
    results["quant_matmul"]["prefill"] = r
    log_extra("quant_matmul", "prefill", r)
    # STEPS' tensor-parallel shapes at model = 4: wq/wk/wv's four heads
    # (K 2048 -> N 512) and wo's rows (K 512 -> N 2048), at a decode batch and
    # the OTP step's 4 x 64 tokens
    results["quant_matmul"]["tp"] = {}
    for m, k, n in TP_QMM:
        r = _time_quant_matmul(f"quant_matmul tp M={m} K={k} N={n}", m, k, n, 4, gen)
        results["quant_matmul"]["tp"][f"M={m} K={k} N={n}"] = r
        results["quant_matmul"]["max_abs_err"] = max(results["quant_matmul"]["max_abs_err"],
                                                     r["max_abs_err"])
        log_extra("quant_matmul", f"tp M={m} K={k} N={n}", r)


#: ``quant_matmul``'s (M, K, N) under STEPS' tensor parallelism (moonshot's
#: 16 heads of 128 over model = 4): the column-parallel q/k/v and the
#: row-parallel o, 4-bit group 128
TP_QMM = [(m, k, n) for m in (4, 256) for k, n in ((2048, 512), (512, 2048))]
#: the ``scan`` expert FFN's GEMMs on moonshot-v1-16b-a3b: one expert's
#: capacity rows (M = 8 at decode, 32 at a 4 × 64 prefill) through gate and
#: up (K = 2048 → N = 1408) and down (K = 1408 → N = 2048), at the buckets'
#: bits 1/2/3
SCAN_QMM = [(bits, m, k, n) for bits in (1, 2, 3) for m in (8, 32)
            for k, n in ((2048, 1408), (1408, 2048))]


def parity_scan_shapes(gen, results):
    """``quant_matmul`` at every :data:`SCAN_QMM` shape against its plain
    version (bf16), and one timing at the decode shape (2-bit, M = 8, K =
    2048 → N = 1408) beside the plain version, the library call and its
    bound."""
    errs = []
    for bits, m, k, n in SCAN_QMM:
        (data, s, z) = rand_weights(gen, 1, k, n, bits)
        data = tuple(t[0] for t in data) if bits == 3 else data[0]
        x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
        errs.append(compare(f"quant_matmul scan b{bits} {m}x{k}x{n}",
                            quant_matmul(x, data, s[0], z[0], bits=bits),
                            ref.quant_matmul_ref(x, data, s[0], z[0], bits=bits), torch.bfloat16))
    r = _time_quant_matmul("quant_matmul scan", 8, 2048, 1408, 2, gen)
    r["max_abs_err"] = max(errs + [r["max_abs_err"]])
    results["quant_matmul"]["scan"] = r
    results["quant_matmul"]["max_abs_err"] = max(results["quant_matmul"]["max_abs_err"],
                                                 r["max_abs_err"])
    log_extra("quant_matmul", "scan", r)
    log(f"quant_matmul at the scan path's {len(SCAN_QMM)} shapes (bits 1/2/3, M = 8 / 32, "
        f"K = 2048 -> N = 1408 and K = 1408 -> N = 2048, bf16): max|err| {max(errs):.3e}")


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
    """The kernel on the whole ``[experts, K, N]`` stack and all ``experts
    · cap`` rows; its live row blocks against the plain version on those
    blocks and the experts they name (``block_expert`` renumbered: the
    plain version dequantizes every expert it is given and gathers one
    weight per block, 85 GB in f32 for kimi-k2's bucket), its dead blocks
    against zero."""
    be, na, bm, nlive = ragged_tables(experts, cap, live_rows)
    m = experts * cap
    x = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
    x_live = x[: nlive * bm]
    used, be_used = torch.unique(be[:nlive].long(), return_inverse=True)
    be_used = be_used.to(torch.int32)
    if kind == "moe_gmm":
        w = rand_weights(gen, experts, k, n, bits)
        got = moe_gmm(x, *w, be, na, bits=bits, bm=bm)
        want = ref.moe_gmm_ref(x_live, *_pick_experts(w, used), be_used, na, bits=bits, bm=bm)
        ws = [w]
    else:
        wg = rand_weights(gen, experts, k, n, bits)
        wu = rand_weights(gen, experts, k, n, bits)
        args = (wg[0], wu[0], wg[1], wg[2], wu[1], wu[2], be, na)
        (g0, g1, g2), (u0, u1, u2) = _pick_experts(wg, used), _pick_experts(wu, used)
        got = moe_gmm_swiglu(x, *args, bits=bits, bm=bm)
        want = ref.moe_gmm_swiglu_ref(x_live, g0, u0, g1, g2, u1, u2, be_used, na, bits=bits,
                                      bm=bm)
        ws = [wg, wu]
    err = compare(f"{kind} b{bits} bm{bm} K={k} {dtype}", got[: nlive * bm], want, dtype)
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
    rows = sum(live)
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
                   bound(*moe_gmm_work(x, ws, bits=bits, rows=rows, experts=len(used))))),
    )


def _time_quant_matmul(label, m, k, n, bits, gen):
    """Check ``quant_matmul`` at one shape against its plain version, then
    time it beside the plain version, ``torch.matmul`` on the
    pre-dequantized weight and its bound."""
    (data, s, z) = rand_weights(gen, 1, k, n, bits)
    data = tuple(t[0] for t in data) if bits == 3 else data[0]
    s, z = s[0], z[0]
    x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
    err = compare(f"{label} {bits}-bit M={m} N={n}", quant_matmul(x, data, s, z, bits=bits),
                  ref.quant_matmul_ref(x, data, s, z, bits=bits), torch.bfloat16)
    w_deq = ref.dequant_ref(data, s, z, bits, k, dtype=torch.bfloat16)
    return dict(
        max_abs_err=err,
        **time_kernel(label, lambda: quant_matmul(x, data, s, z, bits=bits)),
        plain_ms=time_ms(lambda: ref.quant_matmul_ref(x, data, s, z, bits=bits))[0],
        library_ms=time_ms(lambda: torch.matmul(x, w_deq))[0],
        shape=f"M={m} K={k} N={n} {bits}-bit bf16",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(*quant_matmul_work(x, data, s, z, bits=bits)))),
    )


def log_extra(name: str, key: str, r: dict) -> None:
    log(f"kernel {name} {key} [{r['shape']}]: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")


#: kimi-k2-1t-a32b's dense GEMMs (M, K, N) as its served path gives them to
#: ``quant_matmul``: ``wq`` and ``wk``/``wv`` (K = d_model), ``wo`` (K = 64 ·
#: 128), the shared expert's gate/up and down, at the decode batch (4 slots)
#: and a 16-token prefill chunk
KIMI_QMM = [(m, k, n) for m in (4, 16)
            for k, n in ((7168, 8192), (7168, 1024), (8192, 7168), (7168, 2048), (2048, 7168))]


def parity_split_k(gen, results, cfg):
    """The bf16 dequant GEMMs where an item's K range outgrows shared memory
    and the body walks K in chunks: kimi-k2's d_model (K = 7168; bits 1-4;
    ``quant_matmul``, ``moe_gmm`` and ``moe_gmm_swiglu`` at bm 8 and 16)
    and qwen3-14b's d_ff (K = 17408; 4-bit ``quant_matmul``), each against
    its plain version; ``quant_matmul`` at every shape of kimi-k2's served
    path (:data:`KIMI_QMM`, bits 1-4), and ``moe_gmm_swiglu`` (K = 7168 → N
    = 2048) and ``moe_gmm`` (K = 2048 → N = 7168) on its 363-expert 2-bit
    bucket at drop-free decode capacity, live blocks spread to its last
    expert; then one timing per kernel at K = 7168 (``k7168``), and
    ``quant_matmul``'s at kimi-k2's ``wo`` (K = 8192, N = 7168: ``k8192``)
    and at K = 17408 (``k17408``), each also checked."""
    k, n = 7168, 2048
    decode_cap = dispatch_capacity(dataclasses.replace(
        cfg, moe_capacity_factor=float(cfg.num_experts)), 4)        # 24 -> bm 8
    prefill_cap = dispatch_capacity(dataclasses.replace(
        cfg, moe_capacity_factor=float(cfg.num_experts)), 16)       # 96 -> bm 16
    errs = []
    for bits in (1, 2, 3, 4):
        for m, kk, nn in [(4, k, n), (16, 17408, 512)] + KIMI_QMM:
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
    kimi = get_config("kimi-k2-1t-a32b")
    _, n2, _ = bucket_counts(kimi.num_experts)                      # 363
    kimi_cap = dispatch_capacity(dataclasses.replace(
        kimi, moe_capacity_factor=float(kimi.num_experts)), 4)      # 32 -> bm 8
    # a decode step's 4 x 8 routed pairs: 30 experts spread over the bucket
    # (its first and last with two rows each)
    spread = np.linspace(0, n2 - 1, 30).round().astype(int)
    live = [0] * n2
    for i in spread:
        live[i] = 1
    live[spread[0]] = live[spread[-1]] = 2
    for kind, (kk, nn) in (("moe_gmm_swiglu", (kimi.d_model, kimi.d_ff_expert)),
                           ("moe_gmm", (kimi.d_ff_expert, kimi.d_model))):
        err, _ = _gmm_case(gen, kind, 2, torch.bfloat16, kimi_cap, n2, live, kk, nn)
        errs.append(err)
        torch.cuda.empty_cache()
        log(f"{kind} on kimi-k2's 2-bit bucket ({n2} experts, capacity {kimi_cap}, 30 live "
            f"experts up to the last) K={kk} N={nn} bf16: max|err| {err:.3e}")
    for key, (kk, nn) in (("k7168", (k, 8192)), ("k8192", (8192, k)),   # kimi-k2's wq, wo
                          ("k17408", (17408, 5120))):
        r = _time_quant_matmul(f"quant_matmul K={kk}", 4, kk, nn, 4, gen)
        results["quant_matmul"][key] = r
        log_extra("quant_matmul", key, r)
        errs.append(r["max_abs_err"])
    for name in ("quant_matmul", "moe_gmm_swiglu", "moe_gmm"):
        results[name]["split_k_max_abs_err"] = max(errs)
    live = [1] * 12 + [2] * 4
    for kind in ("moe_gmm_swiglu", "moe_gmm"):
        _, c = _gmm_case(gen, kind, 2, torch.bfloat16, decode_cap, 16, live, k, n)
        r = _time_gmm(f"{kind} K={k}", kind, c, 2, k, n, live)
        results[kind]["k7168"] = r
        log_extra(kind, "k7168", r)
    log(f"split K: quant_matmul, moe_gmm and moe_gmm_swiglu at K = 7168 (bits 1-4, bm 8 and "
        f"16), quant_matmul at K = 17408 (4 bits) and at kimi-k2's {len(KIMI_QMM)} served "
        f"shapes (bits 1-4), and the grouped GEMMs on its {n2}-expert bucket match their plain "
        f"versions, max|err| {max(errs):.3e}")


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
    without a window; gemma3-27b's G = 2 over 16 KV heads and kimi-k2's G =
    8 at lengths 1088-1120 with a window of 1024, a global layer's window
    and none; f32 and bf16. Then the kernel's time at the decode shape, at
    4096 positions, at qwen3-14b's G = 5, at gemma3-27b's G = 2 with its
    window and at kimi-k2's G = 8 (``probe_attention``), beside its plain
    version, SDPA over the gathered pages and its byte bound."""
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
        # the served shapes of gemma3-27b (G = 2, 16 KV heads; its local window
        # and a global layer's, past the window) and kimi-k2-1t-a32b (G = 8)
        for g, hkv in ((2, 16), (8, 8)):
            for window in (1024, 70 * 16 + 1, None):
                errs.append(case(gen, dtype, 4, hkv, g, 128, 16, 290, 70,
                                 [1088, 1097, 1104, 1120], window))
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


def grad_parity(gen):
    """The three dequant GEMMs under autograd (``ops``: the kernel forward,
    the plain backward of ``kernels/grad.py``) against autograd through
    their plain versions, at the shapes of the full-width OTP training
    (``workload.OTP_TRAIN``: 4 × 64 = 256 tokens): ``quant_matmul`` 4-bit
    at K = N = d_model, and ``moe_gmm_swiglu`` / ``moe_gmm`` on 16 experts of
    the 2-bit bucket at the training capacity (32, ``bm`` 16) with dead
    row blocks; f32 and bf16, ``x``'s gradient within ``TOL`` · max|plain|,
    the dead blocks' exactly zero. Prints each side's forward + backward
    time and peak memory (the plain side keeps every gathered f32 weight
    for its backward)."""
    cfg = get_config(workload.ARCH)
    d, f = cfg.d_model, cfg.d_ff_expert
    t = workload.OTP_TRAIN.batch * workload.OTP_SEQ
    cap = dispatch_capacity(cfg, t)
    experts = 16
    live = np.random.default_rng(4).integers(0, cap + 1, size=experts).tolist()
    live[-3:] = [0, 0, 0]
    be, na, bm, nlive = ragged_tables(experts, cap, live)
    wg, wu = rand_weights(gen, experts, d, f, 2), rand_weights(gen, experts, d, f, 2)
    wd = rand_weights(gen, experts, f, d, 2)
    wq = tuple(a[0] for a in rand_weights(gen, 1, d, d, 4))
    m = experts * cap
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        cases = {
            "quant_matmul": (t, d, d, lambda x, grad_fn: grad_fn.quant_matmul_parts(
                x, wq[0], wq[1], wq[2], bits=4)),
            "moe_gmm_swiglu": (m, d, f, lambda x, grad_fn: grad_fn.moe_gmm_swiglu(
                x, wg[0], wu[0], wg[1], wg[2], wu[1], wu[2], be, na, bits=2, bm=bm)),
            "moe_gmm": (m, f, d, lambda x, grad_fn: grad_fn.moe_gmm(
                x, wd[0], wd[1], wd[2], be, na, bits=2, bm=bm)),
        }
        for name, (rows, k, n, call) in cases.items():
            x = torch.randn((rows, k), generator=gen, device=DEV).to(dtype)
            gy = torch.randn((rows, n), generator=gen, device=DEV).to(dtype)
            out = {}
            for side, grad_fn in (("ops", kernel_ops), ("plain", PlainOps)):
                xs = x.clone().requires_grad_()
                torch.autograd.grad(call(xs, grad_fn), xs, gy)  # warm up (cuBLAS, allocator)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                build.reset_launches()
                t0 = time.perf_counter()
                (g,) = torch.autograd.grad(call(xs, grad_fn), xs, gy)
                torch.cuda.synchronize()
                out[side] = (g, (time.perf_counter() - t0) * 1e3,
                             torch.cuda.max_memory_allocated() - base, dict(build.LAUNCHES))
            g, ms, peak, launches = out["ops"]
            if launches[name] != 1 or sum(launches.values()) != 1:
                raise AssertionError(f"grad {name}: launches {launches} (want one forward)")
            err = compare(f"grad {name} {dtype}", g, out["plain"][0], dtype)
            if name != "quant_matmul" and (g[nlive * bm:] != 0).any():
                raise AssertionError(f"grad {name}: dead row blocks got a gradient")
            lines.append(f"{name} {str(dtype)[6:]} [{rows}x{k}->{n}] max|err| {err:.3e}, "
                         f"fwd+bwd {ms:.2f} ms / plain {out['plain'][1]:.2f} ms, peak "
                         f"{peak / 1e6:.1f} MB / plain {out['plain'][2] / 1e6:.1f} MB")
    log(f"autograd wrappers (x gradient against autograd through the plain versions; "
        f"{nlive} of {m // bm} row blocks live): " + "; ".join(lines))


class PlainOps:
    """The three GEMMs as their plain versions, for autograd to differentiate."""

    @staticmethod
    def quant_matmul_parts(x, w, scale, zero, *, bits):
        return ref.quant_matmul_ref(x, w, scale, zero, bits=bits)

    @staticmethod
    def moe_gmm_swiglu(x, *args, bits, bm):
        return ref.moe_gmm_swiglu_ref(x, *args, bits=bits, bm=bm)

    @staticmethod
    def moe_gmm(x, *args, bits, bm):
        return ref.moe_gmm_ref(x, *args, bits=bits, bm=bm)


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
        **dict(zip(("bound_ms", "bound_by"), bound(*binary_matmul_work(x, b_packed, alpha)))),
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


def sync_free_megastep(cfg, params, kv_bits=None, temperature=0.0, ffn_backend=None):
    """One decode megastep on the card under ``set_sync_debug_mode("error")``:
    anything inside the horizon that waits on the device (an ``.item()``, a
    ``bincount``, a blocking copy) raises. Sampled (``temperature > 0``), its
    generator is made and seeded inside the checked region, as the engine
    makes one per run. ``ffn_backend`` picks the PMQ expert FFN's path."""
    mcfg = (dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
            if cfg.is_moe else cfg)
    cache = PagedKVCache(cfg, num_blocks=8, block_size=16, max_slots=2,
                         max_blocks_per_slot=4, device=DEV, kv_bits=kv_bits)
    cache.acquire_slot(40)
    cache.acquire_slot(16)
    cache.grow(1, 1)  # slot 1's second write lands on the grown page
    i32 = dict(dtype=torch.int32, device=DEV)
    args = (params, cache.k, cache.v, cache.tables_device(),
            torch.tensor([[3], [5]], device=DEV), torch.tensor([20, 15], **i32),
            torch.ones(2, dtype=torch.bool, device=DEV), mcfg)
    kw = dict(block_size=16, horizon=4, budgets=torch.tensor([4, 2], **i32),
              eos_ids=torch.full((2,), -1, **i32), qs=cache.quant_tables,
              temperature=temperature, ffn_backend=ffn_backend)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen = torch.Generator(device=DEV).manual_seed(7) if temperature > 0 else None
        _, emits, _, _ = paged_decode_horizon(*args, **kw, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if emits.sum(dim=0).tolist() != [4, 2]:
        raise AssertionError(f"sync-free megastep emitted {emits.sum(dim=0).tolist()}")
    kind = f"sampled (T = {temperature})" if temperature > 0 else "greedy"
    if ffn_backend:
        kind += f" ffn_backend={ffn_backend!r}"
    log(f"{cfg.name} {'int8' if kv_bits else 'fp'} {kind} decode megastep (after a page grow) "
        f"under sync debug mode 'error': no host sync inside the horizon")


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
                        prefill_chunk=16, decode_horizon=4, reserve_full=True, kv_bits=kv_bits,
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


#: (preempt_mode, kv_bits) of phase 4's runs under pool pressure
PRESSURE_RUNS = (("swap", None), ("recompute", None), ("swap", 8))


def tiny_preemption(model):
    """A reduced model (f32) with page growth on a 4-page pool, where one of
    three requests is preempted: once per ``preempt_mode`` with fp KV and
    once in swap mode with int8 KV, each on the card and on the CPU. The
    card's tokens must equal the CPU's and the same model's unpressured run
    (full reservation on 16 pages) on the card, and ``counters()`` must be
    equal card vs CPU."""
    arch, make = TINY[model]
    cfg = get_config(arch).reduced()
    params_cpu = make(cfg, seed=0, device="cpu")
    params_gpu = to_device(params_cpu, DEV)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (20, 33, 7)]
    base = EngineConfig(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
                        prefill_chunk=16, decode_horizon=4, reserve_full=True)

    def serve(ecfg, dev, params):
        eng = PagedServingEngine(cfg, params, ecfg, device=dev)
        out = eng.serve(Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(prompts))
        return out, eng.metrics.counters()

    alone = {kv: serve(dataclasses.replace(base, kv_bits=kv), DEV, params_gpu)[0]
             for kv in (None, 8)}
    done = []
    for mode, kv in PRESSURE_RUNS:
        ecfg = dataclasses.replace(base, num_blocks=4, reserve_full=False, preempt_mode=mode,
                                   kv_bits=kv)
        label = f"{model}, {mode}, {'int8' if kv else 'fp'} KV"
        (card, c_card), (cpu, c_cpu) = serve(ecfg, DEV, params_gpu), serve(ecfg, "cpu", params_cpu)
        if card != cpu:
            raise AssertionError(f"tiny preemption ({label}): tokens differ card vs cpu")
        if card != alone[kv]:
            raise AssertionError(f"tiny preemption ({label}): tokens differ from the "
                                 f"unpressured run")
        if c_card != c_cpu:
            bad = [k for k in c_card if c_card[k] != c_cpu[k]]
            raise AssertionError(f"tiny preemption ({label}): counters {bad} differ card vs cpu")
        if not c_card["preemptions"] or (mode == "swap") != (c_card["swap_in_bytes"] > 0) or \
                c_card["swap_in_bytes"] != c_card["swap_out_bytes"]:
            raise AssertionError(f"tiny preemption ({label}): {len(c_card['preemptions'])} "
                                 f"preemptions, swap bytes out {c_card['swap_out_bytes']} in "
                                 f"{c_card['swap_in_bytes']}")
        done.append(f"{mode}/{'int8' if kv else 'fp'} {len(c_card['preemptions'])} preemption(s) "
                    f"{c_card['swap_in_bytes']} swap bytes {c_card['prefill_dispatches']} chunks")
    log(f"tiny preemption ({model}, 4 pages, growth): {'; '.join(done)}; each: tokens card == "
        f"cpu == unpressured run, counters card == cpu")


def tiny_offload():
    """The reduced compressed model (f32) with its experts host-offloaded at 3
    of 8 slots per layer (one row per bucket), synchronous at H = 1 and
    tiered (disk spill, a 64 KiB host row cache) at H = 4, and the same
    widths with 16 experts at 8 of 16 slots, async at H = 1 (the reduced
    model's prefill touches every expert, so only the wider one plans a
    prefetch to stage and commit); each on the card and on the CPU. Tokens
    card == CPU == the all-resident run, ``counters()`` card == CPU. Then
    ``issue_async`` on the card under ``set_sync_debug_mode("error")``:
    staging waits on nothing."""
    arch, make = TINY["compressed"]
    rng = np.random.default_rng(1)
    lengths = (20, 33, 7)
    base = EngineConfig(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
                        prefill_chunk=16, decode_horizon=4, reserve_full=True)
    models = {}
    for experts in (8, 16):
        cfg = dataclasses.replace(get_config(arch).reduced(), num_experts=experts)
        params_cpu = make(cfg, seed=0, device="cpu")
        models[experts] = (cfg, params_cpu, to_device(params_cpu, DEV))
    prompts = [rng.integers(0, models[8][0].vocab_size, size=n).astype(np.int32) for n in lengths]

    def serve(experts, ecfg, dev):
        cfg, params_cpu, params_gpu = models[experts]
        if ecfg.offload_dir is not None:  # each engine spills into a directory of its own
            ecfg = dataclasses.replace(ecfg, offload_dir=f"{ecfg.offload_dir}/{dev}")
        eng = PagedServingEngine(cfg, params_gpu if dev == DEV else params_cpu, ecfg, device=dev)
        out = eng.serve(Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(prompts))
        return out, eng.metrics.counters()

    done = []
    with tempfile.TemporaryDirectory(prefix="tiny_spill_") as spill:
        runs = (("sync H=1", 8, dict(resident_experts=3, decode_horizon=1)),
                ("tiered H=4", 8, dict(resident_experts=3, offload_dir=spill,
                                       host_expert_bytes=64 << 10)),
                ("16 experts, async H=1", 16, dict(resident_experts=8, decode_horizon=1,
                                                   async_offload=True)))
        for label, experts, kw in runs:
            ecfg = dataclasses.replace(base, **kw)
            alone = serve(experts, base, DEV)[0]
            (card, c_card), (cpu, c_cpu) = serve(experts, ecfg, DEV), serve(experts, ecfg, "cpu")
            if card != cpu or card != alone:
                raise AssertionError(f"tiny offload ({label}): tokens card == cpu {card == cpu}, "
                                     f"== all-resident {card == alone}")
            if c_card != c_cpu:
                bad = [k for k in c_card if c_card[k] != c_cpu[k]]
                raise AssertionError(f"tiny offload ({label}): counters {bad} differ card vs cpu")
            if not c_card["expert_miss_uploads"] or (
                    ecfg.async_offload and not c_card["uploads_committed"]):
                raise AssertionError(f"tiny offload ({label}): {c_card['expert_miss_uploads']} "
                                     f"misses, {c_card['uploads_committed']} committed")
            done.append(f"{label}: {c_card['expert_miss_uploads']} miss + "
                        f"{c_card['expert_prefetch_uploads']} prefetch uploads, "
                        f"{c_card['decode_replays']} decode replays, "
                        f"{c_card['uploads_overlapped']} staged / "
                        f"{c_card['uploads_committed']} committed / "
                        f"{c_card['uploads_dropped_stale']} dropped, "
                        f"{c_card['tier_disk_hits']} disk fetches")
    cfg, _, params_gpu = models[8]
    mgr = ExpertOffloadManager([p["moe_ce"] for p in params_gpu["layers"]], resident_slots=3)
    counts = np.zeros((cfg.num_layers, mgr.num_slots), np.int64)
    counts[:, mgr.meta[1].start + 3] = 5
    mgr.update_stats(counts)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        staged = mgr.issue_async(mgr.residency_targets())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    committed = mgr.commit_async()
    if not staged[0] or committed[0] != staged[0]:
        raise AssertionError(f"tiny offload: staged {staged}, committed {committed}")
    log(f"tiny offload ({cfg.name} reduced): {'; '.join(done)}; each: "
        f"tokens card == cpu == all-resident, counters card == cpu; issue_async of "
        f"{staged[0]} rows under sync debug mode 'error': no host sync")


def tiny_pipeline():
    """The reduced ``moonshot-v1-16b-a3b`` (f32, seed 0, built on the host and
    copied) compressed by the port's pipeline on the card and on the CPU
    (``workload.tiny_pipeline``): the same PMQ plan, packed codes equal on
    ≥ 99.9 % of their bytes (the count that differ printed), and each tree's
    greedy tokens equal; then a sampled (T = 0.8) megastep of the card's
    tree under ``set_sync_debug_mode("error")``."""
    cfg = get_config(workload.ARCH).reduced()
    params_host = build_uncompressed(cfg, seed=0, device="cpu")
    _, plan_g, avg_g, codes_g, out_g, params_g = workload.tiny_pipeline(DEV, params_host)
    _, plan_c, avg_c, codes_c, out_c, _ = workload.tiny_pipeline("cpu", params_host)
    if [b.tolist() for b in plan_g.bits] != [b.tolist() for b in plan_c.bits]:
        raise AssertionError(f"tiny pipeline: PMQ plans differ card vs cpu: "
                             f"{[b.tolist() for b in plan_g.bits]} / "
                             f"{[b.tolist() for b in plan_c.bits]}")
    differ = int((codes_g != codes_c).sum())
    if differ > 1e-3 * codes_c.numel():
        raise AssertionError(f"tiny pipeline: {differ} of {codes_c.numel()} packed code bytes "
                             f"differ card vs cpu")
    if out_g != out_c:
        raise AssertionError("tiny pipeline: greedy tokens differ card vs cpu")
    log(f"tiny pipeline ({cfg.name} reduced, f32): plan card == cpu "
        f"{[b.tolist() for b in plan_g.bits]}, layer-uniform {avg_g} / {avg_c} bits; packed code "
        f"bytes differing {differ} of {codes_c.numel()}; {len(out_c)} requests, greedy tokens "
        f"card == cpu")
    sync_free_megastep(cfg, params_g, temperature=0.8)


def tiny_otp_training():
    """``train_otp`` (3 steps, λ = 2) on the reduced PMQ + OTP model (f32,
    seed 0) on the card and on the CPU, on the same draws (the default
    draws come from one CPU generator): the routers within 2e-3 and the
    history within 1e-3 relative."""
    cfg = get_config(workload.ARCH).reduced()
    params_cpu = build_synthetic(cfg, seed=0, device="cpu")
    data = make_calibration_tokens(cfg.vocab_size, 8, 16, seed=3)
    tcfg = OTPTrainConfig(steps=3, batch=2, lr=5e-3, lam=2.0, seed=0)
    runs = {}
    for name, params in (("card", to_device(params_cpu, DEV)), ("cpu", params_cpu)):
        top = {k: v for k, v in params.items() if k != "layers"}
        runs[name] = train_otp(params["layers"], top, cfg, data, tcfg)
    (rg, hg), (rc, hc) = runs["card"], runs["cpu"]
    err = max((a[n].cpu() - b[n]).abs().max().item() for a, b in zip(rg, rc) for n in a)
    hist = max(abs(a[key] - b[key]) / max(abs(b[key]), 1e-12)
               for a, b in zip(hg, hc) for key in ("loss", "kl", "mask_ratio"))
    if err > 2e-3 or hist > 1e-3:
        raise AssertionError(f"tiny OTP training: routers differ card vs cpu by {err:.3e}, "
                             f"history by {hist:.3e} relative")
    log(f"tiny OTP training ({cfg.name} reduced, f32, 3 steps, λ = 2): routers card vs cpu "
        f"max|diff| {err:.3e}, history max rel diff {hist:.3e}; mask ratio "
        f"{[round(h['mask_ratio'], 4) for h in hg]}")


def tiny_adamw8():
    """AdamW with 8-bit moments on the card against the CPU: the reduced
    ``TRAIN_ARCH`` (f32) takes three steps at lr 1e-3 on the CPU, and the
    card applies each step's CPU gradients to its own params and state. The
    moments' int8 codes and scales, and the params, may differ in at most
    1e-4 of their elements (codes: any difference; scales: 1e-6 relative;
    params: 1e-5 · max|param|): the update is elementwise, so only the bias
    corrections' ``pow`` may round apart."""
    cfg = dataclasses.replace(get_config(workload.TRAIN_ARCH).reduced(), dtype="float32")
    bundle = get_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, state_bits=8)
    loader = HostDataLoader(vocab=cfg.vocab_size, global_batch=4, seq_len=32, seed=0)
    params = bundle.init(torch.Generator().manual_seed(0))
    card = to_device(params, DEV)
    opt, opt_card = adamw_init(params, ocfg), adamw_init(card, ocfg)
    for i in range(3):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = bundle.train_loss(live, batch_to(loader.batch_at(i), "cpu"))
        grads = tree_unflatten(live, torch.autograd.grad(loss, tree_leaves(live)))
        params, opt = adamw_update(params, grads, opt, ocfg)
        card, opt_card = adamw_update(card, to_device(grads, DEV), opt_card, ocfg)
    off, total = {"codes": 0, "scales": 0, "params": 0}, {"codes": 0, "scales": 0, "params": 0}
    for (path, a), (_, b) in zip(tree_paths({"opt": opt["per_param"], "params": params}),
                                 tree_paths({"opt": opt_card["per_param"], "params": card})):
        b = b.detach().cpu()
        a = a.detach()
        kind = "codes" if path[-1] == ".q" else "scales" if path[-1] == ".scale" else "params"
        tol = {"codes": 0.0, "scales": 1e-6 * a.abs().max().item(),
               "params": 1e-5 * a.abs().max().item()}[kind]
        off[kind] += int(((a.float() - b.float()).abs() > tol).sum())
        total[kind] += a.numel()
    log(f"tiny AdamW 8-bit ({cfg.name} reduced, f32, 3 steps at lr 1e-3, the CPU's gradients): "
        f"card vs cpu elements apart {off} of {total}")
    if any(off[k] > 1e-4 * total[k] for k in off):
        raise AssertionError(f"tiny AdamW 8-bit: card and cpu apart in {off} of {total}")


def tiny_ffn_backend():
    """The reduced PMQ + OTP model (f32) served with ``ffn_backend="ref"``
    (the plain grouped GEMMs), ``"grouped"`` (the kernels) and ``"scan"``
    (``quant_matmul`` per expert matrix) on the card, and with ``"scan"`` on
    the CPU: the same greedy tokens in all four; the grouped kernels launch
    only under ``grouped``, and ``scan`` launches ``quant_matmul`` and no
    grouped GEMM; then a ``scan`` decode megastep under
    ``set_sync_debug_mode("error")``."""
    cfg = get_config(workload.ARCH).reduced()
    params = build_synthetic(cfg, seed=0, device=DEV)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (20, 33, 7)]
    outs, launches = {}, {}
    for backend, dev in (("ref", DEV), ("grouped", DEV), ("scan", DEV), ("scan", "cpu")):
        ecfg = EngineConfig(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
                            prefill_chunk=16, decode_horizon=4, reserve_full=True,
                            ffn_backend=backend)
        build.reset_launches()
        key = f"{backend} {'card' if dev == DEV else 'cpu'}"
        outs[key] = PagedServingEngine(cfg, to_device(params, dev), ecfg, device=dev).serve(
            Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(prompts))
        launches[key] = dict(build.LAUNCHES)
    gmm = {k: v["moe_gmm"] + v["moe_gmm_swiglu"] for k, v in launches.items()}
    if (len({json.dumps(o, sort_keys=True) for o in outs.values()}) != 1
            or gmm["ref card"] or not gmm["grouped card"] or gmm["scan card"]
            or not launches["scan card"]["quant_matmul"] or any(launches["scan cpu"].values())):
        raise AssertionError(f"ffn_backend: tokens equal "
                             f"{ {k: o == outs['grouped card'] for k, o in outs.items()} }, "
                             f"launches {launches}")
    log(f"ffn_backend ({cfg.name} reduced, f32): 'ref', 'grouped' and 'scan' on the card and "
        f"'scan' on the CPU serve the same greedy tokens ({len(prompts)} requests x 12); "
        f"grouped GEMM launches {gmm}; scan quant_matmul launches "
        f"{launches['scan card']['quant_matmul']}")
    sync_free_megastep(cfg, params, ffn_backend="scan")


#: phase 4's reduced non-transformer models: (arch, layers or None for the
#: reduced config's, prompt tokens) — recurrentgemma at 5 layers runs its
#: trailing recurrent blocks, xlstm on 72 tokens its chunked mLSTM scan
FAMILY_TINY = (("whisper-small", None, 16), ("recurrentgemma-2b", None, 20),
               ("recurrentgemma-2b", 5, 20), ("xlstm-350m", None, 16), ("xlstm-350m", None, 72))
FAMILY_TINY_STEPS = 8


def tiny_families():
    """Each of :data:`FAMILY_TINY` (f32, its bundle's ``init`` at seed 0 on
    the CPU, copied to the card), 2 prompts prefilled and decoded
    :data:`FAMILY_TINY_STEPS` greedy steps on the card and on the CPU:
    identical tokens, per-step logits within 1e-3·max|logit|, no kernel
    launched."""
    build.reset_launches()
    for arch, layers, s in FAMILY_TINY:
        cfg = get_config(arch).reduced()
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        params = get_model(cfg).init(torch.Generator().manual_seed(0))
        batch = workload.family_batch(cfg, 2, s, "cpu")
        runs = {dev: workload.greedy_family(cfg, to_device(params, dev),
                                            {k: v.to(dev) for k, v in batch.items()},
                                            FAMILY_TINY_STEPS + 1)
                for dev in ("cpu", DEV)}
        (tok_c, lg_c, _, _), (tok_g, lg_g, _, _) = runs["cpu"], runs[DEV]
        err = float((lg_g - lg_c).abs().max())
        scale = float(lg_c.abs().max())
        if not torch.equal(tok_g, tok_c) or not err <= 1e-3 * scale:
            raise AssertionError(f"{arch} reduced ({cfg.num_layers} layers, {s} tokens): card "
                                 f"tokens {tok_g.tolist()} against the CPU's {tok_c.tolist()}, "
                                 f"logits max|diff| {err:.3e} of max|logit| {scale:.3e}")
        log(f"{arch} reduced ({cfg.family}, {cfg.num_layers} layers, f32, {s}-token prompts): "
            f"prefill + {FAMILY_TINY_STEPS} greedy steps, card == CPU tokens "
            f"{tok_g.tolist()}, logits max|diff| {err:.3e} (max|logit| {scale:.3e})")
    if any(build.LAUNCHES.values()):
        raise AssertionError(f"families: kernels launched: {dict(build.LAUNCHES)}")


# ------------------------------------------------ phase 5: full width
#: kernels each serving path must launch (binary_matmul has no serving caller)
FP_PATH = WIDE_MOE_PATH = ("quant_matmul", "moe_gmm_swiglu", "moe_gmm", "paged_attention")
INT8_PATH = ("quant_matmul", "moe_gmm_swiglu", "moe_gmm", "paged_attention_quant")
# every linear is a bf16 matmul
DENSE_PATH = COMMAND_R_PATH = UNCOMPRESSED_MOE_PATH = VLM_PATH = WINDOWED_PATH = \
    ("paged_attention",)
# the per-expert scan runs every expert matrix through quant_matmul
SCAN_PATH = ("quant_matmul", "paged_attention")


def _serve(cfg, params, ecfg, reqs):
    eng = PagedServingEngine(cfg, params, ecfg, device=DEV)
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    return eng, out


def begin_path() -> None:
    """Start a serving path: collect the engines of earlier paths (an engine
    and its tracer's metrics consumer form a cycle, so only the collector
    frees their pools), so that the path's peak device memory is its own,
    then zero the peak and the launch counts."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()


def _check_tokens(name, cfg, out, reqs):
    """Each request of ``reqs`` answered with its own ``max_new`` tokens,
    each in the vocabulary."""
    if sorted(out) != sorted(r.rid for r in reqs):
        raise AssertionError(f"{name}: answered {sorted(out)}, asked {[r.rid for r in reqs]}")
    for r in reqs:
        toks = out[r.rid]
        if len(toks) != r.max_new or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{name} request {r.rid}: bad output {toks}")


def _drive(name, cfg, params, ecfg, reqs, needed):
    """One serving path with the launch counts set to 0 just before it and
    read just after; fails on a bad output or a kernel of the path that
    never launched (or the other attention kernel launching)."""
    begin_path()
    eng, out = _serve(cfg, params, ecfg, reqs)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check_tokens(name, cfg, out, reqs)
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched while serving: {missing}")
    stray = [k for k, v in launches.items() if v and k not in needed]
    if stray:
        raise AssertionError(f"{name}: kernels off this path launched: {stray}")
    return eng, out, launches, peak


def compressed_paths():
    """The PMQ + OTP model's fp, int8 KV + shared-prefix, tenant-mix,
    preemption and expert-offload paths: their launches, and the fp path's
    expert bytes per decode step and in all. Each path's engines are local
    to its function, so ``begin_path`` frees them before the next."""
    t0 = time.perf_counter()
    cfg, params = workload.build(DEV)
    torch.cuda.synchronize()
    log(f"full width: {cfg.name} d_model={cfg.d_model} layers={cfg.num_layers} "
        f"experts={cfg.num_experts} top-{cfg.top_k} vocab={cfg.vocab_size} bf16; "
        f"built in {time.perf_counter() - t0:.1f} s; "
        f"weights on device {weight_bytes(params) / 1e9:.3f} GB")
    fp_launches, experts = fp_path(cfg, params)
    q_launches = prefix_path(cfg, params)
    cut = workload.first_layers(cfg, params, workload.CUT_LAYERS)
    mix_launches = tenant_mix_path(*cut)
    preempt_launches = preemption_path(*cut)
    offload_launches = offload_path(*cut)
    scan_launches = walled("scan", lambda: scan_path(*cut))
    return (fp_launches, q_launches, mix_launches, preempt_launches, offload_launches,
            scan_launches, experts)


def fp_path(cfg, params):
    """The fp workload twice: its launches and expert bytes (per decode
    step, in all)."""
    eng, fp_out, fp_launches, peak = _drive("fp path", cfg, params, workload.ENGINE,
                                            workload.requests(cfg), FP_PATH)
    _, out2 = _serve(cfg, params, workload.ENGINE, workload.requests(cfg))
    if out2 != fp_out:
        raise AssertionError("fp path: a second engine served different tokens")
    s = eng.summary()
    log(f"full width serving (fp KV): {len(fp_out)} requests x {workload.MAX_NEW} tokens; "
        f"peak device memory {peak / 1e9:.3f} GB; TTFT mean {s['ttft_mean_s']:.3f} s "
        f"max {s['ttft_max_s']:.3f} s; decode {s['decode_tokens']} tokens in "
        f"{s['decode_s']:.3f} s = {s['decode_tokens_per_s']:.1f} tokens/s; "
        f"OTP expert activation {s['expert_activation']:.4f}; launches {fp_launches}; "
        f"second engine (full depth) tokens identical")
    log("full width serving summary (fp KV): " + json.dumps(s))
    experts = (float(np.mean(profile_decode.expert_step_bytes(eng))),
               sum(weight_bytes(p["moe_ce"]) for p in params["layers"]))
    return fp_launches, experts


def prefix_path(cfg, params):
    """The int8 KV + shared-prefix workload, checked against an int8 engine
    without the cache and a second prefix engine: its launches."""
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
    return q_launches


def _tenant_mix_run(cfg, params, ecfg, faults):
    t0 = time.perf_counter()
    eng = PagedServingEngine(cfg, params, ecfg, faults, device=DEV)
    out = workload.serve_tenant_mix(eng, workload.tenant_mix_requests(cfg))
    torch.cuda.synchronize()
    return eng, out, time.perf_counter() - t0


def tenant_mix_path(cfg, params):
    """The tenant mix through the control plane, four times (see the module
    docstring): its launches; fails on any check."""
    begin_path()
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
    log(f"full width serving (tenant mix, {cfg.num_layers} layers): policy fair, "
        f"{workload.TENANT_MIX.num_blocks} pages; tokens per tenant {tokens}; sheds "
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


def _preempt_run(cfg, params, ecfg, faults):
    t0 = time.perf_counter()
    eng = PagedServingEngine(cfg, params, ecfg, faults, device=DEV)
    out = eng.serve(workload.requests(cfg))
    torch.cuda.synchronize()
    return eng, out, time.perf_counter() - t0


def preemption_path(cfg, params):
    """The fp workload on ``PREEMPT``'s 11-page pool with page growth, twice
    (see the module docstring): its launches; fails on any check. Tokens
    are held to ``fp_out``, an unpressured run on ``ENGINE`` of the same
    model, served before the counts are zeroed."""
    _, fp_out = _serve(cfg, params, workload.ENGINE, workload.requests(cfg))
    begin_path()
    a, out_a, wall_a = _preempt_run(cfg, params,
                                    dataclasses.replace(workload.PREEMPT, trace_level="spans"),
                                    None)
    b, out_b, wall_b = _preempt_run(cfg, params,
                                    dataclasses.replace(workload.PREEMPT, trace_level="full"),
                                    workload.PREEMPT_FAULTS.replay())
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    victim = workload.PREEMPT_VICTIM
    swap_bytes = (workload.PREEMPT_VICTIM_PAGES * 2 * cfg.num_layers * workload.PREEMPT.block_size
                  * cfg.num_kv_heads * cfg.head_dim * a.cache.k.element_size())
    ca, cb = a.metrics.counters(), b.metrics.counters()
    schedule = workload.preempt_schedule(ca)
    if schedule != workload.PREEMPT_COUNTERS:
        bad = [k for k in schedule if schedule[k] != workload.PREEMPT_COUNTERS[k]]
        raise AssertionError(f"preemption (a): schedule counters {bad} differ from the "
                             f"reference's: {json.dumps({k: schedule[k] for k in bad})}")
    grows = sum(e["name"] == "page_grow" for e in a.tracer.events)
    if ([p["rid"] for p in ca["preemptions"]] != [victim] or grows != 3
            or not ca["swap_out_bytes"] == ca["swap_in_bytes"] == swap_bytes):
        raise AssertionError(f"preemption (a): preemptions {ca['preemptions']}, {grows} page "
                             f"grows, swap bytes out {ca['swap_out_bytes']} in "
                             f"{ca['swap_in_bytes']} (expected {swap_bytes})")
    if out_a != fp_out:
        raise AssertionError(f"preemption (a): rids {[r for r in fp_out if out_a[r] != fp_out[r]]}"
                             f" differ from the unpressured run's tokens")
    if (cb["swap_fallbacks"], cb["swap_in_bytes"], cb["prefill_dispatches"]) != (1, 0, 21):
        raise AssertionError(f"preemption (b): {cb['swap_fallbacks']} swap fallbacks, "
                             f"{cb['swap_in_bytes']} swap-in bytes, "
                             f"{cb['prefill_dispatches']} prefill chunks; expected 1, 0, 21")
    events = validate_events(b.tracer.events)
    validate_chrome_trace(b.tracer.chrome_trace())
    want_events = workload.PREEMPT_FAULT_EVENTS + len(cb["capacity_utilization"])
    if events != want_events:
        raise AssertionError(f"preemption (b): {events} trace events, the reference's schedule "
                             f"gives {want_events}")
    differ = [r for r in fp_out if out_b[r] != fp_out[r]]
    if differ:
        raise AssertionError(f"preemption (b): rids {differ} differ from the unpressured "
                             f"run's tokens (rid {victim} re-prefilled)")
    missing = [k for k in FP_PATH if launches[k] == 0]
    stray = [k for k, v in launches.items() if v and k not in FP_PATH]
    if missing or stray:
        raise AssertionError(f"preemption: kernels never launched {missing}, off the path "
                             f"{stray}")
    for name, eng, wall in (("(a) swap", a, wall_a), ("(b) swap-in corrupt -> re-prefill", b,
                                                      wall_b)):
        s = eng.summary()
        log(f"full width serving (preemption {name}): wall {wall:.1f} s; preemptions "
            f"{s['preemptions']}; swap bytes out {s['swap_out_bytes']} in {s['swap_in_bytes']}; "
            f"swap fallbacks {s['swap_fallbacks']}; prefill chunks {s['prefill_chunks']}; "
            f"megasteps {eng.metrics.megasteps}; decode {s['decode_tokens']} tokens in "
            f"{s['decode_s']:.3f} s = {s['decode_tokens_per_s']:.1f} tokens/s")
    spans = {e["name"]: e["dur_us"] / 1e3 for e in a.tracer.events
             if e["name"] in ("kv_swap_out", "kv_swap_in")}
    log(f"full width serving (preemption, {cfg.num_layers} layers): "
        f"{workload.PREEMPT.num_blocks} pages; (a) "
        f"kv_swap_out {spans['kv_swap_out']:.1f} ms, kv_swap_in {spans['kv_swap_in']:.1f} ms "
        f"(host wall, device copies included); schedule "
        f"counters = reference's, {grows} page grows, rid {victim} swapped out and in "
        f"({swap_bytes} bytes), every rid's tokens = the unpressured run's; (b) trace events "
        f"{events}, every rid's tokens = the unpressured run's, rid {victim}'s "
        f"{len(out_b[victim])} after its re-prefill among them; peak device memory "
        f"{peak / 1e9:.3f} GB; launches {launches}")
    log("full width serving summary (preemption, swap): " + json.dumps(a.summary()))
    return launches


def _offload_run(cfg, params, ecfg, faults=None):
    """One engine on the offload workload: ``(engine, tokens, budgets at
    construction, construction wall, serving wall)``."""
    t0 = time.perf_counter()
    eng = PagedServingEngine(cfg, params, ecfg, faults, device=DEV)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    budgets = eng.offload.budgets if eng.offload is not None else None
    out = eng.serve(workload.offload_requests(cfg))
    torch.cuda.synchronize()
    return eng, out, budgets, built, time.perf_counter() - t0 - built


def _offload_report(eng) -> dict:
    """What the offload path prints of one run (the engine is freed after)."""
    m, s = eng.metrics, eng.summary()
    chunks = m.prefill_dispatches - m.prefill_replays
    return {"prefill_runs": m.prefill_dispatches, "prefill_chunks": chunks,
            "runs_per_decode_step": m.decode_dispatches / max(m.megasteps, 1),
            "decode_runs": m.decode_dispatches, "decode_steps": m.megasteps,
            "miss_uploads": m.expert_miss_uploads, "miss_bytes": m.expert_miss_bytes,
            "prefetch_uploads": m.expert_prefetch_uploads,
            "prefetch_bytes": m.expert_prefetch_bytes, "grows": eng.offload.grows,
            "budgets_after": eng.offload.budgets, "resident_bytes": eng.offload.resident_bytes,
            "decode_offload_s": float(sum(m.decode_offload_s)),
            "decode_compute_s": float(sum(m.decode_compute_s)),
            "upload_hidden_s": s["upload_hidden_s"], "upload_stall_s": s["upload_stall_s"],
            "counters": m.counters()}


def offload_path(cfg, params):
    """The expert-offload workload (``OFFLOAD``, see the module docstring)
    three times — (c) all-resident, the token oracle; (a) synchronous two
    tiers at trace level ``spans``; (b) async with the tier store in a
    temporary directory and ``offload_faults`` — each engine freed before
    the next. The counts and the peak are zeroed after (c) and again after
    (a), so each offload run's launches and peak are its own: their summed
    launches; fails on any check."""
    all_bytes = sum(p["moe_ce"].weight_bytes for p in params["layers"])
    c, out_c, _, _, wall_c = _offload_run(cfg, params,
                                          dataclasses.replace(workload.OFFLOAD,
                                                              resident_experts=None))
    del c
    begin_path()
    a, out_a, budgets_a, built_a, wall_a = _offload_run(
        cfg, params, dataclasses.replace(workload.OFFLOAD, trace_level="spans"))
    launches_a, peak_a = dict(build.LAUNCHES), torch.cuda.max_memory_allocated()
    events = validate_events(a.tracer.events)
    validate_chrome_trace(a.tracer.chrome_trace())
    ra = _offload_report(a)
    del a
    begin_path()
    with tempfile.TemporaryDirectory(prefix="expert_spill_") as spill:
        free = shutil.disk_usage(spill).free
        if free < 1.25 * all_bytes:
            raise AssertionError(f"offload (b): {free / 1e9:.1f} GB free in {spill}, the spill "
                                 f"needs {all_bytes / 1e9:.3f} GB")
        b, out_b, budgets_b, built_b, wall_b = _offload_run(
            cfg, params, dataclasses.replace(
                workload.OFFLOAD, async_offload=True, offload_dir=spill,
                host_expert_bytes=workload.OFFLOAD_HOST_BYTES), workload.offload_faults())
        launches_b, peak_b = dict(build.LAUNCHES), torch.cuda.max_memory_allocated()
        disk_bytes, cache_bytes = b.offload.store.disk_bytes, b.offload.store.host_cached_bytes
        rb = _offload_report(b)
        del b
        gc.collect()
    ca, cb = ra["counters"], rb["counters"]
    bad = [name for name, out in (("(a)", out_a), ("(b)", out_b)) if out != out_c]
    if bad:
        raise AssertionError(f"offload {bad}: tokens differ from the all-resident run's")
    if not (ca["expert_miss_uploads"] > 0 and ra["prefill_runs"] > ra["prefill_chunks"]
            and ra["grows"] >= 1 and ra["resident_bytes"] < all_bytes):
        raise AssertionError(f"offload (a): miss uploads {ca['expert_miss_uploads']}, prefill "
                             f"runs {ra['prefill_runs']} for {ra['prefill_chunks']} chunks, "
                             f"grows {ra['grows']}, resident {ra['resident_bytes']} of "
                             f"{all_bytes} bytes")
    planned = cb["plan_actions"].get("expert_uploads", 0)
    if not (cb["tier_disk_hits"] > 0 and cb["upload_retries"] >= 1
            and cb["degraded_serves"] == 0 and (not planned or cb["uploads_overlapped"] > 0)):
        raise AssertionError(f"offload (b): disk hits {cb['tier_disk_hits']}, upload retries "
                             f"{cb['upload_retries']}, degraded {cb['degraded_serves']}, "
                             f"planned uploads {planned}, staged {cb['uploads_overlapped']}")
    for name, launches in (("(a)", launches_a), ("(b)", launches_b)):
        missing = [k for k in FP_PATH if launches[k] == 0]
        stray = [k for k, v in launches.items() if v and k not in FP_PATH]
        if missing or stray:
            raise AssertionError(f"offload {name}: kernels never launched {missing}, off the "
                                 f"path {stray}")
    runs = (("(a) sync", ra, budgets_a, built_a, wall_a, launches_a, peak_a),
            ("(b) async + tiers + faults", rb, budgets_b, built_b, wall_b, launches_b, peak_b))
    for name, r, budgets, built, wall, launches, peak in runs:
        log(f"full width serving (offload {name}): engine built in {built:.2f} s, served in "
            f"{wall:.2f} s; prefill {r['prefill_runs']} runs for {r['prefill_chunks']} chunk(s) "
            f"({r['prefill_runs'] / max(r['prefill_chunks'], 1):.1f} per chunk); decode "
            f"{r['decode_runs']} runs for {r['decode_steps']} steps "
            f"({r['runs_per_decode_step']:.1f} per step); miss uploads {r['miss_uploads']} "
            f"({r['miss_bytes']} B), prefetch uploads {r['prefetch_uploads']} "
            f"({r['prefetch_bytes']} B); grows {r['grows']}, budgets {budgets} -> "
            f"{r['budgets_after']}; resident expert bytes {r['resident_bytes']} of {all_bytes} "
            f"all-resident ({r['resident_bytes'] / all_bytes:.4f}); decode_offload_s "
            f"{r['decode_offload_s']:.3f}, decode_compute_s {r['decode_compute_s']:.3f}; "
            f"upload_hidden_s {r['upload_hidden_s']:.4f}, upload_stall_s "
            f"{r['upload_stall_s']:.4f}; peak device memory {peak / 1e9:.3f} GB; launches "
            f"{launches}")
    log(f"full width serving (offload, {cfg.num_layers} layers): "
        f"{workload.OFFLOAD.resident_experts} of {cfg.num_experts} slots per layer; (c) "
        f"all-resident served in {wall_c:.2f} s; tokens "
        f"(a) == (b) == (c); (a) trace events {events} (valid); (b) spill + host copy in "
        f"{built_b:.2f} s (host copy alone, (a): {built_a:.2f} s), disk bytes {disk_bytes}, "
        f"host-cache bytes {cache_bytes} of {workload.OFFLOAD_HOST_BYTES}, disk fetches "
        f"{cb['tier_disk_hits']} ({cb['tier_disk_bytes']} B), host hits {cb['tier_host_hits']}, "
        f"upload faults {cb['fault_injected']}, retries {cb['upload_retries']}, degraded "
        f"{cb['degraded_serves']}, planned upload actions {planned}, staged "
        f"{cb['uploads_overlapped']} committed {cb['uploads_committed']} dropped "
        f"{cb['uploads_dropped_stale']}; the peaks include the all-resident model's buckets, "
        f"which stay allocated beside each engine's partitions")
    return {k: launches_a[k] + launches_b[k] for k in launches_a}


def teacher_forced_gap(cfg, params, prompt, prefix, tok_a: int, tok_b: int):
    """The dense-cache oracle's logits after ``prompt`` and ``prefix``: the
    gap between ``tok_a`` and ``tok_b`` in bf16 ulps of that step's
    max|logit|, and the least routing margins of the same run (top-k router,
    OTP or None)."""
    seq = np.concatenate([prompt, np.asarray(prefix, np.int32)]).astype(np.int32)
    _, steps = dense_greedy_reference(cfg, params, seq, 1, device=DEV)
    v = steps[0]
    gap = abs(float(bf16_ulps(v[tok_a] - v[tok_b], np.abs(v).max())))
    return (gap, *routing_margins(cfg, params, seq, 0))


def first_drift(name, cfg, params, prompts, got, want) -> str:
    """Each row's agreement of ``got`` with ``want`` (token lists by row)
    and, at its first differing step, :func:`teacher_forced_gap` between the
    two tokens; a drift that no near-tie within :data:`ORACLE_GAP_ULPS`
    explains goes to :data:`ORACLE_FAULTS`."""
    parts = []
    for i, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        part = f"row {i} {sum(a == b for a, b in zip(g, w))}/{len(w)}"
        first = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if first is not None:
            gap, router, otp = teacher_forced_gap(cfg, params, prompt, w[:first], w[first],
                                                  g[first])
            near = min(m for m in (gap, router, otp) if m is not None) <= ORACLE_GAP_ULPS
            part += (f" (first difference at {first}: gap {gap:.3f} ulps, least routing margin "
                     f"{router:.3f}" + (f", OTP {otp:.3f}" if otp is not None else "") + " ulps; "
                     + ("near-tie)" if near else f"no near-tie within {ORACLE_GAP_ULPS} ulps)"))
            if not near:
                ORACLE_FAULTS.append(f"{name} row {i} step {first}")
        parts.append(part)
    return "; ".join(parts)


def scan_path(cfg, params):
    """``SCAN``: the fp workload with ``ffn_backend="scan"`` on the cut model
    — ``quant_matmul`` and ``paged_attention`` launch and no grouped GEMM; a
    second engine's tokens identical; the drift from a ``grouped`` engine's
    tokens of the same layers held to :func:`first_drift`. Returns the first
    run's launches."""
    ecfg = dataclasses.replace(workload.ENGINE, ffn_backend="scan")
    reqs = workload.requests
    eng, out, launches, peak = _drive("scan path", cfg, params, ecfg, reqs(cfg), SCAN_PATH)
    _, out2 = _serve(cfg, params, ecfg, reqs(cfg))
    if out2 != out:
        raise AssertionError("scan path: a second engine served different tokens")
    _, grouped = _serve(cfg, params, workload.ENGINE, reqs(cfg))
    s = eng.summary()
    log(f"full width serving (scan, {cfg.name}, first {cfg.num_layers} layers): {len(out)} "
        f"requests x {workload.MAX_NEW} tokens; peak device memory {peak / 1e9:.3f} GB; TTFT mean "
        f"{s['ttft_mean_s']:.3f} s max {s['ttft_max_s']:.3f} s; decode {s['decode_tokens']} "
        f"tokens in {s['decode_s']:.3f} s = {s['decode_tokens_per_s']:.1f} tokens/s; launches "
        f"{launches}; second engine tokens identical")
    rids = sorted(out)
    log("scan path: tokens against a grouped engine's on the same layers: " + first_drift(
        "scan path", cfg, params, [r.prompt for r in reqs(cfg)], [out[r] for r in rids],
        [grouped[r] for r in rids]))
    return launches


#: ``EP``: ranks on the one card, the meshes of the layer check, the greedy
#: tokens decoded on ``data=1 × model=EP_WORLD``
EP_WORLD, EP_MESHES, EP_STEPS = 4, ((1, 4), (2, 2)), 16
#: kernels each rank launches: the layer check by backend (the shared
#: experts' linears are 4-bit), the dense-cache decode (no paged attention)
EP_LAYER_PATH = {"grouped": ("quant_matmul", "moe_gmm_swiglu", "moe_gmm"),
                 "scan": ("quant_matmul",)}
EP_DECODE_PATH = ("quant_matmul", "moe_gmm_swiglu", "moe_gmm")


def ep_path():
    """``EP``: the first ``workload.CUT_LAYERS`` layers of the fp model built
    with ``ep=EP_WORLD`` (buckets 4 / 60 / 4, 17 slots a rank), driven by
    :data:`EP_WORLD` ranks on this card over gloo
    (:func:`repro_torch.launch.ep_ranks.run`). Layer 0's compressed MoE at
    decode (4 × 1) and prefill (4 × 64) on each mesh of :data:`EP_MESHES`
    with ``grouped`` and ``scan``, each rank held to the single-process layer
    on its data shard's tokens within the bf16 tolerance, ``mask_l1`` equal,
    its path's kernels launched on every rank; each rank's expert bytes its
    bucket rows, summing to the layer's; then :data:`EP_STEPS` greedy tokens
    of the dense-cache prefill of the fp prompts on ``data=1 × model=4``,
    held to the single-process run (a first drift only at a near-tie).
    Returns the launches of the layer checks and of the decode, summed over
    the ranks."""
    cfg = dataclasses.replace(get_config(workload.ARCH), num_layers=workload.CUT_LAYERS)
    begin_path()
    t0 = time.perf_counter()
    params = build_synthetic(cfg, seed=0, device=DEV, ep=EP_WORLD)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    p0 = params["layers"][0]
    ce0 = p0["moe_ce"]
    counts = [m.count for m in ce0.meta]
    if any(c % EP_WORLD for c in counts):
        raise AssertionError(f"EP: buckets {counts} built with ep={EP_WORLD}")
    gen = torch.Generator(device=DEV).manual_seed(11)
    inputs = {name: torch.randn((4, s, cfg.d_model), generator=gen, device=DEV).to(torch.bfloat16)
              for name, s in (("decode", 1), ("prefill", workload.PROMPT_LEN))}
    prompts = [r.prompt for r in workload.requests(cfg)]
    batch = {"tokens": torch.as_tensor(np.stack(prompts)).long().to(DEV)}
    backends = ("grouped", "scan")
    oracle = {}
    with torch.no_grad():
        for data in sorted({d for d, _ in EP_MESHES}):
            for name, x in inputs.items():
                b = x.shape[0] // data
                for backend in backends:
                    for d in range(data):
                        y, info = compressed_moe_layer(p0["moe"], ce0, x[d * b:(d + 1) * b], cfg,
                                                       otp_params=p0["otp"], ffn_backend=backend)
                        oracle[(data, name, backend, d)] = (y.float().cpu().numpy(),
                                                            float(info["mask_l1"]))
    toks_ref, logits_ref, _, _ = workload.greedy_family(cfg, params, batch, EP_STEPS)
    t1, t1_wall = time.perf_counter(), time.time()
    res = ep_ranks.run(cfg, params, world=EP_WORLD, inputs=inputs, meshes=EP_MESHES,
                       backends=backends, batch=batch, steps=EP_STEPS)
    ranks_s = time.perf_counter() - t1
    layer_launches = {k: 0 for k in build.LAUNCHES}
    worst = {}
    for r, o in enumerate(res):
        for (data, model, name, backend), (coord, y, ml1, la) in o["layer"].items():
            want, want_l1 = oracle[(data, name, backend, coord["data"])]
            err, scale = float(np.abs(y - want).max()), float(np.abs(want).max())
            case = f"rank {r} {data}x{model} {name} {backend}"
            if not (np.isfinite(y).all() and err <= TOL[torch.bfloat16] * scale):
                raise AssertionError(f"EP {case}: max|rank - single process| {err:.3e} of "
                                     f"max|single process| {scale:.3e}")
            if ml1 != want_l1:
                raise AssertionError(f"EP {case}: mask_l1 {ml1} against {want_l1}")
            needed = EP_LAYER_PATH[backend]
            if any(la[k] == 0 for k in needed) or any(v and k not in needed
                                                       for k, v in la.items()):
                raise AssertionError(f"EP {case}: launches {la}")
            worst[(data, model, name, backend)] = max(worst.get((data, model, name, backend), 0),
                                                      err / scale)
            for k, v in la.items():
                layer_launches[k] += v
    whole = ce0.weight_bytes
    for data, model in EP_MESHES:
        held = [o["layer_bytes"][(data, model)] for o in res]
        for d in range(data):
            line = [b for coord, b in held if coord["data"] == d]
            if sum(line) != whole or any(b != whole // model for b in line):
                raise AssertionError(f"EP {data}x{model}: layer 0 expert bytes {held} of {whole}")
    all_layers = sum(p["moe_ce"].weight_bytes for p in params["layers"])
    if sum(o["expert_bytes"] for o in res) != all_layers:
        raise AssertionError(f"EP: expert bytes {[o['expert_bytes'] for o in res]} of "
                             f"{all_layers}")
    decode_launches = {k: sum(o["greedy_launches"][k] for o in res) for k in build.LAUNCHES}
    for r, o in enumerate(res):
        la = o["greedy_launches"]
        if any(la[k] == 0 for k in EP_DECODE_PATH) or any(v and k not in EP_DECODE_PATH
                                                           for k, v in la.items()):
            raise AssertionError(f"EP decode rank {r}: launches {la}")
        if not np.array_equal(o["greedy"][0], res[0]["greedy"][0]):
            raise AssertionError(f"EP decode: rank {r}'s tokens differ from rank 0's")
    toks = res[0]["greedy"][0]
    ranks_logits = res[0]["greedy"][1]
    drift = first_drift("EP decode", cfg, params, prompts, toks.tolist(), toks_ref.tolist())
    step_err = float(np.abs(ranks_logits - logits_ref.numpy()).max())
    log(f"EP ({cfg.name}, first {cfg.num_layers} layers, {EP_WORLD} ranks on one card over "
        f"gloo): built with ep={EP_WORLD} in {build_s:.1f} s, the single-process oracles in "
        f"{t1 - t0 - build_s:.1f} s, buckets {counts} "
        f"({ce0.num_slots // EP_WORLD} slots a rank); layer 0 against the single-process layer "
        f"(its data shard's tokens), max|err| / max|single| by case "
        f"{ {f'{d}x{m} {n} {b}': round(v, 6) for (d, m, n, b), v in worst.items()} } "
        f"(limit {TOL[torch.bfloat16]}), mask_l1 equal; layer 0 expert bytes by rank "
        f"{ {f'{d}x{m}': [o['layer_bytes'][(d, m)][1] for o in res] for d, m in EP_MESHES} } "
        f"of {whole}; all layers {[o['expert_bytes'] for o in res]} of {all_layers}")
    log(f"EP decode (data=1 x model={EP_WORLD}, dense-cache prefill of {len(prompts)} x "
        f"{workload.PROMPT_LEN} + {EP_STEPS} greedy tokens): against the single-process run: "
        f"{drift}; rank 0's logits max|diff| {step_err:.4g}; prefill / decode s by rank "
        f"{[(round(o['greedy'][2], 3), round(o['greedy'][3], 3)) for o in res]} = "
        f"{[round(len(prompts) * (EP_STEPS - 1) / o['greedy'][3], 1) for o in res]} tokens/s; "
        f"peak device memory by rank (GB) "
        f"{[round((o['peak_bytes'] or 0) / 1e9, 3) for o in res]}; walls by rank (s) "
        f"{[round(o['wall_s'], 1) for o in res]}; ranks started (payload open) after "
        f"{[round(o['started_at'] - t1_wall, 1) for o in res]} s; spawn to results "
        f"{ranks_s:.1f} s; "
        f"collective routes {res[0]['routes']}; decode launches (all ranks) {decode_launches}")
    return layer_launches, decode_launches


#: STEPS: the ranks sharing the card, the OTP step's kernels on every rank,
#: the full-training model's depth and steps
STEPS_WORLD = 4
#: (a)'s router gradients, max|rank − single| / max|single|, a fixed limit
#: between two readings: sound ranks read 0.0352 on the card (bf16 GEMMs in
#: other partitions; the same gradients through the per-expert scan against
#: the grouped GEMMs read 0.0212 in one process), and the EP region with its
#: ``enter`` on the OTP mask dropped reads 0.77-1.18 on the CPU ranks of
#: ``tests/test_torch_steps_ranks.py`` (each rank keeps its own experts' share)
STEPS_OTP_GRAD_TOL = 0.1
STEPS_OTP_PATH = ("quant_matmul", "moe_gmm_swiglu", "moe_gmm")
STEPS_TRAIN_ARCH, STEPS_TRAIN_STEPS, STEPS_ACCUM = "tinyllama-1.1b", 2, 2
#: (b)'s depth: 22 layers leave four ranks and the single process's
#: parameters, gradients and two steps' results no room on the card, with
#: ``remat="block"`` too (a rank ran out at 12.0 GiB of its own, 78.9 GiB
#: in use on the card; ``PERF.md`` §6)
STEPS_TRAIN_LAYERS = 11
STEPS_TRAIN_BATCH, STEPS_TRAIN_SEQ = 8, 128
#: (c): the other families at full width in f32, one training step on
#: ``data=1 × model=4``, each cut to the depth named for the script's time
#: (arch, layers, encoder layers); a batch of 2 × 64 tokens (whisper: over
#: its 1500 frames)
STEPS_FAMILIES = (("whisper-small", 2, 2), ("recurrentgemma-2b", 5, 0), ("xlstm-350m", 2, 0))
STEPS_FAMILY_BATCH, STEPS_FAMILY_SEQ = 2, 64
#: the leaves the reference's specs cut that the port keeps whole on every
#: rank (``ROADMAP.md`` §3): recurrentgemma's attention, whose one KV head
#: ``P(None, "model")`` would cut inside the head
STEPS_KEPT_WHOLE = re.compile(r"^groups/\d+/attn/attn/w[qkvo]/w$")


def _rel_l2(a, b) -> float:
    """‖a − b‖ / ‖b‖ over lists of ``{name: array}`` (numpy)."""
    num = sum(float(((x[k] - y[k]) ** 2).sum()) for x, y in zip(a, b) for k in y)
    return (num / max(sum(float((y[k] ** 2).sum()) for y in b for k in y), 1e-30)) ** 0.5


def _rel(a, b) -> float:
    """max|a − b| / max|b| over lists of ``{name: array}`` (numpy)."""
    err = max(float(np.abs(x[k] - y[k]).max()) for x, y in zip(a, b) for k in y)
    return err / max(max(float(np.abs(y[k]).max()) for y in b for k in y), 1e-30)


def steps_path(otp_cfg=None, train_cfg=None, families_cfgs=None):
    """``STEPS``: the step builders across :data:`STEPS_WORLD` ranks on this
    card over gloo (``repro_torch.launch.step_ranks``). (a) One OTP step of
    the first ``workload.CUT_LAYERS`` layers of the PMQ model built with
    ``ep=4`` on ``data=1 × model=4`` — expert parallelism, attention split 4
    heads a rank, the shared experts' pair whole (its row half does not
    divide into 128-groups) — on 4 × 64 tokens and fixed Gumbel draws,
    against the single process's step: each rank's router gradients within
    :data:`STEPS_OTP_GRAD_TOL` × their max, loss and KL within ``TOL`` (bf16)
    × the loss, the sharded update fed the single process's gradients equal
    to its updated routers bit for bit, the step's routers moved the other
    way than the single process's only where its gradient lies within the
    gradient limit of 0; ``STEPS_OTP_PATH``'s kernels launched on every rank
    and no other, counted over the step alone. (b) ``tinyllama-1.1b`` in f32
    (no TF32; its first :data:`STEPS_TRAIN_LAYERS` layers),
    :data:`STEPS_TRAIN_STEPS` steps of ``build_step``'s train step
    (``accum=2``, ZeRO-1, 32-bit moments) on ``data=2 × model=2`` against
    the single process's same steps (run first; its state freed): each
    step's loss within 1e-4 relative, the first step's gradients on each
    rank's state blocks within 1e-4 × max, the sharded update fed the single
    process's gradients equal to its first step bit for bit, the parameters
    after the steps within 2 · lr · steps (their count more than 1e-4 × max
    apart printed), each rank's optimizer state a quarter of the whole but
    the norms' half. (c) :func:`steps_families` (``families_cfgs``: its
    models). Returns the launches of (a), summed over the ranks."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import step_ranks, steps

    begin_path()
    t0 = time.perf_counter()
    cfg = otp_cfg or dataclasses.replace(get_config(workload.ARCH),
                                         num_layers=workload.CUT_LAYERS)
    frozen = build_synthetic(cfg, seed=0, device=DEV, ep=STEPS_WORLD)
    otp = [p.pop("otp") for p in frozen["layers"]]
    opt = adamw_init({k: torch.stack([o[k] for o in otp]) for k in ("fc1", "fc2")},
                     steps.OTP_ADAMW)
    gen = torch.Generator().manual_seed(21)
    seq = workload.PROMPT_LEN if otp_cfg is None else 16
    shape = ShapeConfig("train_4k", seq, 4, "train")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, seq), generator=gen).to(DEV)}
    draws = otp_mod.gumbel_uniforms(gen, (4 * seq, cfg.top_k), DEV)
    art = steps.build_step(cfg, shape, None, train_mode="otp")
    _, _, grads1_t = steps.otp_gradients(cfg, None, otp, frozen, batch, draws)
    new1_t, _, loss1, kl1 = art.fn(steps._own(otp), steps._own(opt), frozen, batch, draws)
    # copies: the tensors go to the ranks, whose transfer may move their storage
    grads1 = [{k: v.float().cpu().numpy().copy() for k, v in g.items()} for g in grads1_t]
    new1 = [{k: v.float().cpu().numpy().copy() for k, v in o.items()} for o in new1_t]
    old = [{k: v.float().cpu().numpy().copy() for k, v in o.items()} for o in otp]
    otp_s = time.perf_counter() - t0
    log(f"STEPS: the OTP model built and its single-process step in {otp_s:.1f} s")

    tcfg = train_cfg or dataclasses.replace(get_config(STEPS_TRAIN_ARCH), dtype="float32",
                                            num_layers=STEPS_TRAIN_LAYERS)
    bundle = get_model(tcfg)
    tshape = ShapeConfig("train_4k", STEPS_TRAIN_SEQ if train_cfg is None else 16,
                         STEPS_TRAIN_BATCH, "train")
    params = bundle.init(torch.Generator(device=DEV).manual_seed(0))
    loader = HostDataLoader(vocab=tcfg.vocab_size, global_batch=STEPS_TRAIN_BATCH,
                            seq_len=tshape.seq_len, seed=0)
    tbatch = batch_to(loader.batch_at(0), DEV)
    tart = steps.build_step(tcfg, tshape, None, accum=STEPS_ACCUM)
    t1 = time.perf_counter()
    _, tgrads = tart.grads(params, tbatch)
    tgrads = {p: g.detach() for p, g in tgrads.items()}
    final, topt, losses1, params1 = steps._own(params), steps.init_opt_blocks(tart, DEV), [], None
    for _ in range(STEPS_TRAIN_STEPS):  # the step writes into its donated params and state
        final, topt, loss = tart.fn(final, topt, tbatch)
        losses1.append(float(loss))
        params1 = params1 or steps._own(final)
    whole_state = {p: v.numel() * v.element_size()
                   for p, v in tree_paths(topt["per_param"])}
    del topt
    train1_s = time.perf_counter() - t1
    log(f"STEPS: {tcfg.name}'s single-process steps in {train1_s:.1f} s")
    if DEV.type == "cuda":
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    payload = {"otp": {"cfg": cfg, "shape": shape, "otp": otp, "opt": opt, "frozen": frozen,
                       "batch": batch, "draws": draws, "grads": grads1_t, "otp1": new1_t},
               "train": {"cfg": tcfg, "shape": tshape, "accum": STEPS_ACCUM,
                         "steps": STEPS_TRAIN_STEPS, "params": params, "grads": tgrads,
                         "params1": params1, "final": final, "batch": tbatch}}
    t2 = time.perf_counter()
    res = step_ranks.run(payload, world=STEPS_WORLD)
    ranks_s = time.perf_counter() - t2

    launches = {k: sum(o["otp"]["launches"][k] for o in res) for k in build.LAUNCHES}
    worst, faults = {}, []
    for r, o in enumerate(res):
        a = o["otp"]
        la = a["launches"]
        if any(la[k] == 0 for k in STEPS_OTP_PATH) or any(v and k not in STEPS_OTP_PATH
                                                           for k, v in la.items()):
            faults.append(f"STEPS OTP rank {r}: launches {la}")
        # the gradients against their max within STEPS_OTP_GRAD_TOL; loss and
        # KL against the loss (the KL is a small difference of two
        # distributions); the sharded update fed the single process's
        # gradients equal to its routers bit for bit; AdamW's first update is
        # lr · sign(g) but where |g| ~ eps, so the step's routers may move the
        # other way than the single process's only where its gradient lies
        # within the gradient limit of 0
        g_max = max(float(np.abs(y[k]).max()) for y in grads1 for k in y)
        flips = [np.sign(x[k] - o0[k]) != np.sign(y[k] - o0[k])
                 for x, y, o0 in zip(a["otp"], new1, old) for k in y]
        near0 = [np.abs(g[k]) <= STEPS_OTP_GRAD_TOL * g_max for g in grads1 for k in g]
        errs = {"grads": _rel(a["grads"], grads1),
                "flips_off_band": sum(int((f & ~z).sum()) for f, z in zip(flips, near0)),
                "loss": abs(a["loss"] - float(loss1)) / abs(float(loss1)),
                "kl": abs(a["kl"] - float(kl1)) / abs(float(loss1))}
        limits = {"grads": STEPS_OTP_GRAD_TOL, "flips_off_band": 0,
                  "loss": TOL[torch.bfloat16], "kl": TOL[torch.bfloat16]}
        bad = {k: v for k, v in errs.items() if not v <= limits[k]}
        if not a["update_bitwise"]:
            bad["update_bitwise"] = False
        if bad:
            faults.append(f"STEPS OTP rank {r}: errors {bad} above {limits}")
        errs["flips"] = sum(int(f.sum()) for f in flips) / sum(f.size for f in flips)
        errs["routers_rel"] = _rel(a["otp"], new1)
        errs["grads_l2"] = _rel_l2(a["grads"], grads1)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in errs.items()}
        t = o["train"]
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(t["losses"], losses1))
        if not (loss_err <= 1e-4 and t["grad_err"] <= 1e-4 * t["grad_scale"]
                and t["update_bitwise"] and t["max_err"] <= t["update_bound"]):
            faults.append(f"STEPS train rank {r}: losses {t['losses']} against "
                                 f"{losses1}; first step's gradients max|diff| "
                                 f"{t['grad_err']:.3e} of max {t['grad_scale']:.3e}; sharded "
                                 f"update bitwise {t['update_bitwise']}; parameters max|diff| "
                                 f"{t['max_err']:.3e} (bound {t['update_bound']:.1e})")
        want = sum(b // (2 if any(n in str(p) for n in ("ln1", "ln2", "final_norm")) else 4)
                   for p, b in whole_state.items())
        if t["state_bytes"] != want:
            faults.append(f"STEPS train rank {r}: optimizer state {t['state_bytes']} B, "
                          f"expected {want} B of {sum(whole_state.values())}")
    plan = res[0]["otp"]["plan"]
    log(f"STEPS ({STEPS_WORLD} ranks on one card over gloo) OTP step ({cfg.name}, first "
        f"{cfg.num_layers} layers, built with ep={STEPS_WORLD}, data=1 x model={STEPS_WORLD}, "
        f"tensor-parallel pairs {plan} — a pair false stays whole on every rank; 4 x {seq} "
        f"tokens, fixed Gumbel draws): single process (build, oracle) {otp_s:.1f} s; each rank "
        f"against it, worst error by quantity { {k: round(v, 6) for k, v in worst.items()} } "
        f"(grads / max|grads| — grads_l2 in the L2 norm —, flips_off_band: router elements "
        f"updated the other way with |g| above the gradient limit — flips: the share updated "
        f"the other way —, routers_rel / max|routers|, loss and kl / loss; limits {limits}); "
        f"the sharded update on the single process's gradients bitwise by rank "
        f"{[o['otp']['update_bitwise'] for o in res]}; loss {float(loss1):.6f}, kl "
        f"{float(kl1):.6f}; step s (the step alone) by "
        f"rank {[round(o['otp']['step_s'], 3) for o in res]}; peak device memory by rank (GB) "
        f"{[round((o['otp_peak'] or 0) / 1e9, 3) for o in res]}; launches (all ranks) {launches}; "
        f"{beside_pre_remat('STEPS (a)', cfg)}")
    log(f"STEPS train ({tcfg.name}, {tcfg.num_layers} layers, f32, data=2 x model="
        f"{STEPS_WORLD // 2}, accum={STEPS_ACCUM}, ZeRO-1, 32-bit moments, {STEPS_TRAIN_STEPS} "
        f"steps of {STEPS_TRAIN_BATCH} x {tshape.seq_len} tokens): single process "
        f"{train1_s:.1f} s, losses {losses1}; ranks' losses "
        f"{[o['train']['losses'] for o in res]} (limit 1e-4 relative); first step's gradients "
        f"max|diff| / max by rank "
        f"{[round(o['train']['grad_err'] / o['train']['grad_scale'], 9) for o in res]} (limit "
        f"1e-4); the sharded update on the single process's gradients bitwise by rank "
        f"{[o['train']['update_bitwise'] for o in res]}; after {STEPS_TRAIN_STEPS} steps "
        f"parameters max|diff| by rank {[o['train']['max_err'] for o in res]} of max "
        f"{res[0]['train']['scale']:.4g} (bound 2 x lr x steps = "
        f"{res[0]['train']['update_bound']:.1e}: Adam's update of a gradient near eps moves "
        f"by up to lr under reordered sums), elements more than 1e-4 x max apart by rank "
        f"{[o['train']['beyond'] for o in res]}; "
        f"optimizer state bytes by rank {[o['train']['state_bytes'] for o in res]} of "
        f"{sum(whole_state.values())}; step s by rank "
        f"{[[round(x, 3) for x in o['train']['step_s']] for o in res]}; peak device memory by "
        f"rank (GB) {[round((o['train_peak'] or 0) / 1e9, 3) for o in res]}; spawn to results "
        f"{ranks_s:.1f} s; collective routes {res[0]['routes']}; "
        f"{beside_pre_remat('STEPS (b)', tcfg)}")
    del payload, res, params, final, frozen, otp, opt, params1, tgrads
    faults += steps_families(families_cfgs)
    if faults:
        raise AssertionError("; ".join(faults))
    return launches


def steps_families(cfgs=None):
    """``STEPS`` (c): one f32 training step (no TF32) of each model of
    :data:`STEPS_FAMILIES` (or ``cfgs``) across :data:`STEPS_WORLD` ranks on
    ``data=1 × model=4``, against the single process's (run first): whisper's
    ``cross`` and ``attn`` 3 heads a rank, its MLPs by F, its vocabulary of
    51865 whole (it does not divide); recurrentgemma's RG-LRU and MLPs a
    quarter a rank, its attention whole (:data:`STEPS_KEPT_WHOLE`), its
    vocabulary of 256000 split; xlstm one head a rank, its vocabulary of
    50304 split. Each rank's loss within 1e-5 relative, its gradients within
    1e-4 × max of its share of the single process's, its parameter bytes the
    reference's specs' share but for the leaves kept whole. Returns the
    faults found."""
    from repro_torch.launch import step_ranks, steps

    if DEV.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cases = []
    for cfg in cfgs or [dataclasses.replace(get_config(a), dtype="float32", num_layers=n,
                                            encoder_layers=e) for a, n, e in STEPS_FAMILIES]:
        params = get_model(cfg).init(torch.Generator(device=DEV).manual_seed(0))
        batch = workload.family_batch(cfg, STEPS_FAMILY_BATCH, STEPS_FAMILY_SEQ, DEV)
        batch["labels"] = torch.roll(batch["tokens"], -1, 1)
        loss, grads = steps.tree_gradients(cfg, params, batch)
        cases.append({"name": cfg.name, "cfg": cfg, "params": params, "batch": batch,
                      "grads": grads, "loss": float(loss)})
    single_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = step_ranks.run_families({"families": cases}, world=STEPS_WORLD)
    ranks_s = time.perf_counter() - t1
    faults = []
    for case in cases:
        name = case["name"]
        for r, o in enumerate(res):
            got = o["families"][name]
            kept = [p for p in got["differ"] if not STEPS_KEPT_WHOLE.search(p)]
            if not (abs(got["loss"] - case["loss"]) <= 1e-5 * abs(case["loss"])
                    and got["grad_err"] <= 1e-4 * got["grad_scale"] and not kept):
                faults.append(f"STEPS (c) {name} rank {r}: loss {got['loss']} against "
                              f"{case['loss']}, gradients max|diff| {got['grad_err']:.3e} of max "
                              f"{got['grad_scale']:.3e}, bytes off the reference's share at "
                              f"{kept}")
        o = res[0]["families"][name]
        cfg = case["cfg"]
        log(f"STEPS (c) {name} (f32, {cfg.num_layers} layers"
            f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, "
            f"{STEPS_FAMILY_BATCH} x {STEPS_FAMILY_SEQ} tokens, data=1 x model={STEPS_WORLD}, "
            f"pairs of the first block {o['plan']}, vocabulary {cfg.vocab_size} "
            f"{'split' if cfg.vocab_size % STEPS_WORLD == 0 else 'whole'}): loss "
            f"{case['loss']:.6f}, ranks' {[round(x['families'][name]['loss'], 6) for x in res]} "
            f"(limit 1e-5 relative); gradients max|diff| / max by rank "
            f"{[x['families'][name]['grad_err'] / x['families'][name]['grad_scale'] for x in res]}"
            f" (limit 1e-4); parameter bytes a rank {o['bytes']} of {o['whole']} whole, the "
            f"reference's specs' share {o['reference']}, leaves kept whole {len(o['differ'])} "
            f"({o['differ'][:4]}{' ...' if len(o['differ']) > 4 else ''}); step s by rank "
            f"{[round(x['families'][name]['step_s'], 3) for x in res]}")
    log(f"STEPS (c): single process {single_s:.1f} s, spawn to results {ranks_s:.1f} s; peak "
        f"device memory by rank (GB) {[round((o['peak'] or 0) / 1e9, 3) for o in res]}; "
        f"{beside_pre_remat('STEPS (c)', cases[0]['cfg'])}; "
        f"collective routes {res[0]['routes']}")
    return faults


def build_logged(make):
    """``(cfg, params)`` of a full-width dense or uncompressed-MoE model built
    on the card by ``make``, with its build line (time, weights and the
    build's peak device memory)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = make(DEV)
    torch.cuda.synchronize()
    log(f"full width: {cfg.name} ({cfg.family}) d_model={cfg.d_model} layers={cfg.num_layers} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff_expert or cfg.d_ff} "
        f"experts={cfg.num_experts} vocab={cfg.vocab_size} {cfg.dtype}; built in "
        f"{time.perf_counter() - t0:.1f} s; weights on device {weight_bytes(params) / 1e9:.3f} GB; "
        f"build peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return cfg, params


#: a near-tie: the paged engine and the dense-cache oracle add in other
#: orders in bf16, so where the oracle's logit of its own token exceeds
#: that of the engine's by at most this many bf16 ulps of the step's
#: max|logit| (or, in an MoE model, a routing decision up to that step is
#: as close), the argmax may flip without a defect; a larger gap is one
ORACLE_GAP_ULPS = 4.0
#: divergences from the oracle that no near-tie explains, raised once every
#: full-width path has printed its own
ORACLE_FAULTS: list = []


def bf16_ulps(gap, scale):
    """``gap`` in units of the bf16 spacing at ``|scale|`` (8 significant
    bits); tensors are taken row by row."""
    return gap / 2.0 ** (np.floor(np.log2(np.abs(scale))) - 7)


def _least_margin(logits: torch.Tensor, k: int) -> float:
    """Smallest gap over the rows of ``logits`` between each row's k-th and
    (k+1)-th largest value, in bf16 ulps of the row's max|·|."""
    logits = logits.float()
    top = torch.topk(logits, k + 1, dim=-1).values
    return float(bf16_ulps((top[:, k - 1] - top[:, k]).cpu().numpy(),
                           logits.abs().amax(-1).cpu().numpy()).min())


def routing_margins(cfg, params, prompt, steps: int):
    """The least routing margins of the dense-cache oracle's run over
    ``prompt`` and its first ``steps`` decode steps — every token an
    oracle's logits at step ``steps`` depend on — at any layer, in bf16
    ulps: the top-k router's (its k-th against its (k+1)-th logit) and the
    OTP router's (its best candidate mask against the next; None without
    OTP)."""
    seen = {"router": [], "otp": []}
    route, dm = moe_mod.route_topk, otp_mod.dm_logits

    def route_logged(router_p, x2, k):
        seen["router"].append(_least_margin(linear(router_p, x2.float()), k))
        return route(router_p, x2, k)

    def dm_logged(p, x2, gates_sorted):
        out = dm(p, x2, gates_sorted)
        seen["otp"].append(_least_margin(out, 1))
        return out

    moe_mod.route_topk = cm_mod.route_topk = route_logged
    otp_mod.dm_logits = dm_logged
    try:
        dense_greedy_reference(cfg, params, prompt, steps + 1, device=DEV)
    finally:
        moe_mod.route_topk = cm_mod.route_topk = route
        otp_mod.dm_logits = dm
    return min(seen["router"]), (min(seen["otp"]) if seen["otp"] else None)


def oracle_agreement(name, eng, params, reqs, out) -> str:
    """Each request decoded through the dense-cache oracle beside the
    engine's tokens: the agreement and, at the first differing step, the
    oracle's gap from its token to the engine's and its top-2 gap, in bf16
    ulps of that step's max|logit| (in an MoE model also the least routing
    margins up to that step). A divergence that no near-tie
    (:data:`ORACLE_GAP_ULPS`) explains goes to :data:`ORACLE_FAULTS`."""
    cfg = eng.model_cfg
    parts = []
    for r in reqs:
        dense, steps = dense_greedy_reference(cfg, params, r.prompt, r.max_new, device=DEV)
        got = out[r.rid]
        part = f"rid {r.rid} {sum(a == b for a, b in zip(got, dense))}/{len(dense)}"
        first = next((i for i, (a, b) in enumerate(zip(got, dense)) if a != b), None)
        if first is not None:
            v = steps[first]
            scale = np.abs(v).max()
            gap = float(bf16_ulps(v[dense[first]] - v[got[first]], scale))
            top2 = float(bf16_ulps(v[dense[first]] - np.partition(v, -2)[-2], scale))
            part += (f" (first difference at {first}: oracle gap to the engine's token "
                     f"{gap:.3f} ulps, top-2 gap {top2:.3f} ulps, max|logit| {scale:.4g}")
            margins = [gap]
            if cfg.is_moe:
                router, otp = routing_margins(cfg, params, r.prompt, first)
                part += f"; least routing margin {router:.3f} ulps"
                margins.append(router)
                if otp is not None:
                    part += f", OTP {otp:.3f} ulps"
                    margins.append(otp)
            near_tie = min(margins) <= ORACLE_GAP_ULPS
            part += ("; near-tie)" if near_tie else
                     f"; no near-tie within {ORACLE_GAP_ULPS} ulps)")
            if not near_tie:
                ORACLE_FAULTS.append(f"{name} rid {r.rid} step {first}")
        parts.append(part)
    return f"{name}: paged tokens against the dense-cache oracle's: " + "; ".join(parts)


def plain_path(name, cfg, params, ecfg, needed, reqs=workload.requests, counted=None):
    """A model served twice with ``ecfg`` on ``reqs(cfg)`` (the fp workload's
    requests by default), each request also decoded through the dense-cache
    oracle (:func:`oracle_agreement`): its launches, its expert bytes per
    decode step and in all, its tokens and the first engine's summary.
    ``counted = (what, bytes)``: a dry run's count of the bytes above the
    weights, printed beside the served peak."""
    weights = weight_bytes(params)
    eng, out, launches, peak = _drive(name, cfg, params, ecfg, reqs(cfg), needed)
    _, out2 = _serve(cfg, params, ecfg, reqs(cfg))
    if out2 != out:
        raise AssertionError(f"{name}: a second engine served different tokens")
    s = eng.summary()
    experts = (float(np.mean(profile_decode.expert_step_bytes(eng))),
               sum(weight_bytes(p.get("moe_ce")) + weight_bytes(p.get("moe", {}).get("experts"))
                   for p in params["layers"]))
    log(f"full width serving ({name}, {cfg.name}): {len(out)} requests x "
        f"{reqs(cfg)[0].max_new} tokens; weights on device {weights / 1e9:.3f} GB; peak device "
        f"memory {peak / 1e9:.3f} GB; TTFT mean {s['ttft_mean_s']:.3f} s max "
        f"{s['ttft_max_s']:.3f} s; decode {s['decode_tokens']} tokens in {s['decode_s']:.3f} s "
        f"= {s['decode_tokens_per_s']:.1f} tokens/s; launches {launches}; second engine "
        f"({cfg.num_layers} layers) tokens identical")
    log(f"full width serving summary ({name}): " + json.dumps(s))
    if counted is not None:
        log(f"{name}: the dry run's count of {counted[0]}: {counted[1] / 1e9:.3f} GB above "
            f"the {weights / 1e9:.3f} GB of weights, {(weights + counted[1]) / 1e9:.3f} GB in "
            f"all, beside the served peak {peak / 1e9:.3f} GB (counted / measured "
            f"{(weights + counted[1]) / peak:.3f})")
    log(oracle_agreement(name, eng, params, reqs(cfg), out))
    return launches, experts, out, s


def _timed(fn):
    """``(fn(), seconds)``, the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def compress_path(cfg, params, moe_out):
    """``COMPRESS``: the uncompressed model (``params``, consumed layer by
    layer in (e)) compressed on the card by the port's pipeline, then served:
    (a) calibrate, (b) Eq. 6 eps, (c) the DP plan against the MILP's, (d)
    GPTQ on layer 0 against RTN on the same plan, (e) the layer-uniform
    serving tree, (f) the fp workload twice (``FP_PATH``'s launches; greedy
    agreement with the uncompressed model's tokens ``moe_out`` printed, not
    gated: the weights are random), (g) sampled at T = 0.8 with seeds 0, 0
    and 1 on the first ``workload.CUT_LAYERS`` layers. Returns the launches
    of (f)."""
    gc.collect()  # the uncompressed path's engines and pools
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    tokens = torch.as_tensor(workload.calibration_tokens(cfg), device=DEV)
    calib, dt = _timed(lambda: pipeline.calibrate(params, tokens, cfg))
    t = calib.moe_inputs[0].shape[0]
    log(f"compress (a) calibrate: {tokens.shape[0]} x {tokens.shape[1]} = {tokens.numel()} "
        f"tokens (numpy seed {workload.CALIB_SEED}) through {cfg.num_layers} layers in "
        f"{dt:.3f} s; MoE inputs [{t}, {d}] f32 per layer on the device")

    eps, dt = _timed(lambda: pipeline.compute_eps(params, calib, cfg))
    forwards = cfg.num_layers * (1 + e * 3)
    share = float((eps[..., 0] >= eps[..., 2]).mean())
    if not np.isfinite(eps).all() or share <= 0.9:
        raise AssertionError(f"compress (b): eps finite {np.isfinite(eps).all()}, share "
                             f"eps[1 bit] >= eps[3 bit] {share}")
    log(f"compress (b) compute_eps: {forwards} MoE-layer forwards over "
        f"{min(pipeline.EPS_TOKENS, t)} tokens in {dt:.3f} s ({dt / forwards * 1e3:.3f} ms "
        f"each); eps finite, {eps.min():.4e} to {eps.max():.4e}; share of experts with "
        f"eps[1 bit] >= eps[3 bit] {share:.4f}")

    plan, dt_dp = _timed(lambda: pipeline.run_pmq(calib, eps, cfg, pipeline.TARGET_AVG_BITS))
    milp, dt_milp = _timed(lambda: pipeline.run_pmq(calib, eps, cfg, pipeline.TARGET_AVG_BITS,
                                                    solver="milp"))
    rel = abs(plan.objective - milp.objective) / abs(milp.objective)
    if rel > 1e-9:
        raise AssertionError(f"compress (c): DP objective {plan.objective!r} against MILP "
                             f"{milp.objective!r} (rel {rel:.2e})")
    budgets = plan.layer_budgets.tolist()
    log(f"compress (c) run_pmq: dp {dt_dp:.3f} s, milp {dt_milp:.3f} s; "
        f"objective {plan.objective!r} / {milp.objective!r} (rel {rel:.1e}); histogram "
        f"{dict(sorted(plan.histogram().items()))}; average {plan.avg_bits:.6f} bits; layer "
        f"budgets {sorted(set(budgets), reverse=True)} ({budgets.count(max(budgets))} layers at "
        f"{max(budgets)}); layer 0 "
        f"{ {int(b): int(c) for b, c in zip(*np.unique(plan.bits[0], return_counts=True))} }")

    one = dict(params, layers=params["layers"][:1])
    (gptq, _), dt = _timed(lambda: pipeline.compress_model(one, calib, plan, cfg, use_gptq=True))
    rtn, _ = pipeline.compress_model(one, calib, plan, cfg, use_gptq=False)
    dtype = params["embed"].dtype
    h2 = calib.moe_inputs[0][None].to(dtype)
    y_fp = moe_layer(params["layers"][0]["moe"], h2, cfg).y.float()
    mse = {}
    for name, blk in (("gptq", gptq[0]), ("rtn", rtn[0])):
        y, _ = compressed_moe_layer(blk["moe"], blk["moe_ce"], h2, cfg)
        mse[name] = float(((y.float() - y_fp) ** 2).mean())
    if not mse["gptq"] < 1.05 * mse["rtn"]:
        raise AssertionError(f"compress (d): layer-0 MSE GPTQ {mse['gptq']:.4e} against RTN "
                             f"{mse['rtn']:.4e}")
    log(f"compress (d) GPTQ (compress_model, use_gptq=True) on layer 0: {e} experts x 3 "
        f"matrices in {dt:.3f} s ({dt / (3 * e) * 1e3:.1f} ms per matrix, f64 on the card); "
        f"layer-0 MoE output MSE on the {t} calibration tokens ({str(dtype)[6:]}): GPTQ "
        f"{mse['gptq']:.4e}, RTN {mse['rtn']:.4e} ({mse['gptq'] / mse['rtn']:.4f}x RTN)")
    del gptq, rtn, one, h2, y_fp

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (params_c, avg), dt = _timed(lambda: pipeline.compress_for_serving(
        params, calib, cfg, eps=eps, consume=True))
    peak = torch.cuda.max_memory_allocated()
    del calib
    gc.collect()
    ce0 = params_c["layers"][0]["moe_ce"]
    hist = {m.bits: m.count * cfg.num_layers for m in ce0.meta}
    g = cfg.quant.group
    row_fixed = 8 * (2 * -(-d // g) * f + -(-f // g) * d)  # f32 scale + zero per group
    want_bytes = cfg.num_layers * (e * row_fixed + budgets[0] * 3 * d * f // 8)
    got_bytes = sum(p["moe_ce"].weight_bytes for p in params_c["layers"])
    if avg != budgets[0] / e or got_bytes != want_bytes or "otp" in params_c["layers"][0]:
        raise AssertionError(f"compress (e): {avg} bits (want {budgets[0] / e}), expert buckets "
                             f"{got_bytes} B (want {want_bytes})")
    log(f"compress (e) compress_for_serving (layer-uniform, layer 0's {budgets[0]} bits): "
        f"histogram {hist}, average {avg} bits in {dt:.3f} s, each layer's float weights freed "
        f"as it was compressed; device memory {before / 1e9:.3f} GB before, peak "
        f"{peak / 1e9:.3f} GB, {torch.cuda.memory_allocated() / 1e9:.3f} GB after; expert "
        f"buckets {got_bytes} B; weights on device {weight_bytes(params_c) / 1e9:.3f} GB; "
        f"no OTP routers")

    eng, out, launches, peak = _drive("compressed (pipeline) path", cfg, params_c,
                                      workload.COMPRESS, workload.requests(cfg), FP_PATH)
    _, out2 = _serve(cfg, params_c, workload.COMPRESS, workload.requests(cfg))
    if out2 != out:
        raise AssertionError("compressed (pipeline) path: a second engine served different "
                             "tokens")
    s = eng.summary()
    agree = sum(a == b for rid in out for a, b in zip(out[rid], moe_out[rid]))
    n = sum(len(v) for v in out.values())
    first = [next((i for i, (a, b) in enumerate(zip(out[r], moe_out[r])) if a != b), None)
             for r in sorted(out)]
    log(f"compress (f) full width serving (pipeline-compressed, fp KV): {len(out)} requests x "
        f"{workload.MAX_NEW} tokens; peak device memory {peak / 1e9:.3f} GB; TTFT mean "
        f"{s['ttft_mean_s']:.3f} s max {s['ttft_max_s']:.3f} s; decode {s['decode_tokens']} "
        f"tokens in {s['decode_s']:.3f} s = {s['decode_tokens_per_s']:.1f} tokens/s; launches "
        f"{launches}; second engine tokens identical; greedy agreement with the uncompressed "
        f"model {agree} of {n} positions (first difference per request {first}; not gated: "
        f"random weights)")
    log("full width serving summary (compressed (pipeline)): " + json.dumps(s))

    sampled = []
    cut_cfg, cut_c = workload.first_layers(cfg, params_c, workload.CUT_LAYERS)
    for seed in (0, 0, 1):
        ecfg = dataclasses.replace(workload.COMPRESS, temperature=0.8, sample_seed=seed)
        (_, o), dt = _timed(lambda: _serve(cut_cfg, cut_c, ecfg, workload.requests(cfg)))
        _check_tokens("compress (g)", cfg, o, workload.requests(cfg))
        sampled.append((o, dt))
    (a, dt_a), (b, dt_b), (c, dt_c) = sampled
    if a != b:
        raise AssertionError("compress (g): two sampled engines with seed 0 differ")
    differ = sum(x != y for rid in a for x, y in zip(a[rid], c[rid]))
    log(f"compress (g) sampled serving (T = 0.8, first {cut_cfg.num_layers} layers): seed 0 "
        f"twice byte-identical ({dt_a:.3f} / {dt_b:.3f} s); seed 1 differs at {differ} of "
        f"{n} positions ({dt_c:.3f} s)")
    del eng
    return launches, otp_path(*workload.first_layers(cfg, params_c, workload.CUT_LAYERS))


#: kernels of the OTP training forward (its attention is the dense sweep)
OTP_TRAIN_PATH = ("quant_matmul", "moe_gmm_swiglu", "moe_gmm")


def otp_memory_prediction(cfg, t: int) -> dict:
    """Bytes the OTP training adds on top of the model (derived before the
    first run): what the port's autograd keeps per layer (the SwiGLU's
    compacted input and the capacity layout, ~24 [T, D] bf16 activations;
    under ``remat="block"`` a layer's input and its attention's output, and
    one layer's whole at a time while it is recomputed), the f32 logits
    (student, teacher, softmax) and the f32 copy of the output embedding the
    logits keep for the backward, and the backward's dequantized expert
    slices; beside it what autograd through the plain grouped GEMMs would
    keep: each GEMM's gathered ``[blocks, K, N]`` f32 weights, three GEMMs a
    layer."""
    d, f, v = cfg.d_model, cfg.d_ff_expert, cfg.vocab_size
    cap = dispatch_capacity(cfg, t)
    rows = cfg.num_experts * cap
    layer = rows * (d + f) * 2 + 24 * t * d * 2
    kept = layer
    if cfg.remat == "block":
        kept = 2 * t * d * 2 + layer / cfg.num_layers
    logits = 3 * t * v * 4 + v * d * 4
    transient = 2 * 4 * grad_mod.SLICE_ELEMENTS  # two operands' slices, f32 and its temporaries
    plain_layer = 3 * (rows // gmm_block_rows(cap)) * d * f * 4
    return dict(activations=cfg.num_layers * kept, logits=logits, transient=transient,
                plain=cfg.num_layers * plain_layer)


def otp_path(cfg, params_c):
    """``OTP``: (h) routers trained on the pipeline-compressed tree
    (its first ``workload.CUT_LAYERS`` layers) by ``train_otp``
    (``workload.OTP_TRAIN``: 20 steps, batch 4 × 64, λ = 2, τ = 1, lr 5e-3)
    at full width, ``OTP_TRAIN_PATH``'s kernels launched in the
    forward and no other, the peak set against its prediction, the loss, KL
    and mask ratio finite; (i) the fp workload served twice with the trained
    routers: ``FP_PATH``'s launches, tokens identical, the OTP activation
    below 1.0, each request held to the dense-cache oracle. Returns the
    launches of (h) and (i)."""
    t = workload.OTP_TRAIN.batch * workload.OTP_SEQ
    pred = otp_memory_prediction(cfg, t)
    blocks = params_c["layers"]
    top = {k: v for k, v in params_c.items() if k != "layers"}
    begin_path()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    (routers, hist), dt = _timed(lambda: train_otp(blocks, top, cfg, workload.otp_tokens(cfg),
                                                   workload.OTP_TRAIN))
    train_launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in OTP_TRAIN_PATH if train_launches[k] == 0]
    stray = [k for k, n in train_launches.items() if n and k not in OTP_TRAIN_PATH]
    if missing or stray:
        raise AssertionError(f"OTP training: kernels never launched {missing}, off its path "
                             f"{stray}")
    if not all(np.isfinite([h[key] for h in hist for key in ("loss", "kl", "mask_ratio")])):
        raise AssertionError("OTP training: non-finite loss, KL or mask ratio")
    first, last = hist[:5], hist[-5:]
    mean = lambda hs, key: float(np.mean([h[key] for h in hs]))
    log(f"OTP (h) train_otp at full width ({cfg.num_layers} layers, {workload.OTP_TRAIN}): "
        f"{len(hist)} steps in {dt:.3f} s ({dt / len(hist):.3f} s a step); device memory "
        f"{before / 1e9:.3f} GB before, peak {peak / 1e9:.3f} GB (+{(peak - before) / 1e9:.3f}); "
        f"predicted +{(pred['activations'] + pred['logits']) / 1e9:.3f} GB kept for the "
        f"backward (activations {pred['activations'] / 1e9:.3f}, logits and f32 embedding "
        f"{pred['logits'] / 1e9:.3f}) and up to {pred['transient'] / 1e9:.3f} GB of dequantized "
        f"expert slices; autograd through the plain GEMMs would keep "
        f"{pred['plain'] / 1e9:.1f} GB; launches {train_launches}; "
        f"{beside_pre_remat('OTP (h)', cfg)}")
    ratio = [[round(h["mask_ratio"], 4) for h in hs] for hs in (first, last)]
    kl = [[float(f"{h['kl']:.4g}") for h in hs] for hs in (first, last)]
    log(f"OTP (h) mask ratio first five {ratio[0]}, last five {ratio[1]} (mean "
        f"{mean(first, 'mask_ratio'):.4f} -> {mean(last, 'mask_ratio'):.4f}); KL first five "
        f"{kl[0]}, last five {kl[1]}")
    params_otp = dict(params_c, layers=[dict(p, otp=r) for p, r in zip(blocks, routers)])
    eng, out, launches, peak = _drive("OTP-trained path", cfg, params_otp, workload.COMPRESS,
                                      workload.requests(cfg), FP_PATH)
    _, out2 = _serve(cfg, params_otp, workload.COMPRESS, workload.requests(cfg))
    s = eng.summary()
    if out2 != out or not s["expert_activation"] < 1.0:
        raise AssertionError(f"OTP (i): second engine tokens identical {out2 == out}, "
                             f"activation {s['expert_activation']}")
    log(f"OTP (i) full width serving with the trained routers: {len(out)} requests x "
        f"{workload.MAX_NEW} tokens; peak device memory {peak / 1e9:.3f} GB; decode "
        f"{s['decode_tokens']} tokens in {s['decode_s']:.3f} s = "
        f"{s['decode_tokens_per_s']:.1f} tokens/s; OTP expert activation "
        f"{s['expert_activation']:.4f}; launches {launches}; second engine tokens identical")
    log(oracle_agreement("OTP-trained path", eng, params_otp, workload.requests(cfg), out))
    return train_launches, launches


def vlm_path():
    """``VLM``: ``llava-next-mistral-7b`` served on tokens alone (twice, the
    dense-cache oracle beside it), then the dense-cache prefill of its 2880
    patch embeddings ahead of the first prompt and 16 greedy tokens, twice.
    Returns the serving launches."""
    cfg, params = build_logged(workload.build_vlm)
    launches, _, _, _ = plain_path("vlm path", cfg, params, workload.VLM, VLM_PATH)
    patches = workload.vlm_patches(cfg, DEV)
    prompt = workload.requests(cfg)[0].prompt
    batch = {"tokens": torch.as_tensor(prompt[None].astype(np.int64), device=DEV),
             "patch_embeds": patches}
    begin_path()
    (cache, logits), wall = _timed(lambda: get_model(cfg).prefill(params, batch))
    pos = cfg.num_patch_tokens + len(prompt)
    if cache["pos"] != pos or cache["k"].shape[2] != pos:
        raise AssertionError(f"vlm patch prefill: cache pos {cache['pos']}, rows "
                             f"{cache['k'].shape[2]}, expected {pos}")
    if not torch.isfinite(logits).all():
        raise AssertionError("vlm patch prefill: non-finite logits")
    kv = nbytes(cache["k"], cache["v"])
    del cache, logits
    runs = [_timed(lambda: dense_greedy_reference(cfg, params, prompt, workload.VLM_PATCH_NEW,
                                                  patch_embeds=patches, device=DEV)[0])
            for _ in range(2)]
    toks = runs[0][0]
    _check_tokens("vlm patch decode", cfg, {0: toks},
                  [Request(rid=0, prompt=prompt, max_new=workload.VLM_PATCH_NEW)])
    if runs[1][0] != toks:
        raise AssertionError("vlm patch decode: a second run decoded different tokens")
    if any(build.LAUNCHES.values()):
        raise AssertionError(f"vlm patch decode: kernels launched on the dense-cache path: "
                             f"{dict(build.LAUNCHES)}")
    log(f"vlm patch prefill ({cfg.name}): {cfg.num_patch_tokens} patch embeddings + "
        f"{len(prompt)} prompt tokens prefilled in {wall:.3f} s; cache pos {pos}; KV cache "
        f"{kv / 1e9:.3f} GB; {workload.VLM_PATCH_NEW} greedy tokens {toks} in "
        f"{runs[0][1]:.3f} / {runs[1][1]:.3f} s (prefill included, cache padded by "
        f"{workload.VLM_PATCH_NEW} rows), identical on a second run; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return launches


def windowed_path():
    """``WINDOWED``: ``gemma3-27b`` on 2 requests of 1088 + 32 tokens, twice,
    the dense-cache oracle beside it. Returns the launches."""
    cfg, params = build_logged(workload.build_windowed)
    ecfg = workload.WINDOWED
    wins = layer_windows_static(cfg, ecfg.max_blocks_per_slot * ecfg.block_size)
    local = int((wins == cfg.local_window).sum())
    log(f"windowed path: {local} local layers (window {cfg.local_window}) and "
        f"{cfg.num_layers - local} global; decode positions {workload.WINDOWED_PROMPT_LEN}-"
        f"{workload.WINDOWED_PROMPT_LEN + workload.WINDOWED_MAX_NEW - 1}, past the window; "
        f"prefill chunk {ecfg.prefill_chunk}")
    launches, _, _, _ = plain_path("windowed path", cfg, params, ecfg, WINDOWED_PATH,
                                   reqs=workload.windowed_requests)
    return launches


def command_r_path():
    """``COMMAND_R``: ``command-r-35b`` at full width (all 40 layers, bf16,
    :func:`workload.build_command_r`) served on ``ENGINE``'s geometry by
    :func:`plain_path`, beside the dry run's count of a bf16 ``prefill_step``
    of the same 4 × 64 tokens on ``meta`` (most of it the f32 copy of the
    tied table that each logits call makes). Returns the launches."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.op_analysis import analyze_step

    cfg = get_config(workload.COMMAND_R_ARCH)
    shape = ShapeConfig("prefill_32k", workload.PROMPT_LEN, workload.NUM_REQUESTS, "prefill")
    art = steps.build_step(cfg, shape, None, precision="bf16")
    s = analyze_step(art.fn, art.arg_specs)
    what = f"a bf16 prefill_step of {workload.NUM_REQUESTS} × {workload.PROMPT_LEN} tokens"
    launches, _, _, _ = plain_path("command-r path", *build_logged(workload.build_command_r),
                                   workload.COMMAND_R, COMMAND_R_PATH,
                                   counted=(what, s.peak_bytes))
    return launches


def wide_moe_path():
    """``WIDE_MOE``: ``kimi-k2-1t-a32b`` at 2 layers (PMQ + OTP) on the fp
    workload, twice, the dense-cache oracle beside it: its expert bytes, OTP
    activation and drop-free prefill dispatch buffer. Returns the launches."""
    cfg, params = build_logged(workload.build_wide_moe)
    launches, (step, every), _, s = plain_path("wide MoE path", cfg, params, workload.WIDE_MOE,
                                               WIDE_MOE_PATH)
    meta = params["layers"][0]["moe_ce"].meta
    cap = dispatch_capacity(dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts)),
                            workload.WIDE_MOE.prefill_chunk)
    log(f"wide MoE path ({cfg.name}, {cfg.num_layers} of 61 layers): buckets "
        f"{[(m.bits, m.count) for m in meta]}; expert bytes on the device {every / 1e9:.3f} GB, "
        f"read per decode step {step / 1e9:.3f} GB; OTP expert activation "
        f"{s['expert_activation']:.4f}; drop-free prefill dispatch buffer [{cfg.num_experts}, "
        f"{cap}, {cfg.d_model}] = {cfg.num_experts * cap * cfg.d_model * 2 / 1e9:.3f} GB bf16")
    return launches


#: the weight bytes each family's config gives in bf16 (the reference
#: ``init``'s parameters by ``jax.eval_shape``, times 2)
FAMILY_WEIGHT_GB = {"whisper-small": 0.589, "recurrentgemma-2b": 5.789, "xlstm-350m": 0.757}


def teacher_forced_agreement(name, cfg, params, batch, toks) -> str:
    """Each request's decoded tokens against one teacher-forced forward over
    its prompt and tokens: the agreement and, at the first step where the
    forward picks another token, its gap to the decoded one in bf16 ulps of
    that step's max|logit|; a gap above :data:`ORACLE_GAP_ULPS` goes to
    :data:`ORACLE_FAULTS`."""
    tf = workload.teacher_forced_logits(cfg, params, batch, toks)
    parts = []
    for r in range(toks.shape[0]):
        pick = tf[r].argmax(dim=-1)
        same = (pick == toks[r]).tolist()
        part = f"rid {r} {sum(same)}/{len(same)}"
        if not all(same):
            i = same.index(False)
            v = tf[r, i].numpy()
            gap = float(bf16_ulps(v[int(pick[i])] - v[int(toks[r, i])], np.abs(v).max()))
            near = gap <= ORACLE_GAP_ULPS
            part += (f" (first difference at {i}: gap {gap:.3f} ulps of max|logit| "
                     f"{np.abs(v).max():.4g}; {'near-tie' if near else 'no near-tie'})")
            if not near:
                ORACLE_FAULTS.append(f"{name} rid {r} step {i}")
        parts.append(part)
    return f"{name}: decoded tokens against a teacher-forced forward's: " + "; ".join(parts)


def family_path(arch: str):
    """``WHISPER``, ``RECURRENT`` or ``XLSTM``: the model at full width in
    bf16 (its ``init`` at seed 0 on the card), :data:`workload.FAMILY_ARCHS`'s
    requests decoded greedily twice through the dense-cache ``prefill`` and
    ``decode_step`` — identical tokens, each held to a teacher-forced
    forward, no kernel launched. Returns the launches (all 0)."""
    cfg, params = build_logged(lambda dev: workload.build_family(arch, dev))
    n, s = workload.FAMILY_ARCHS[arch]
    batch = workload.family_batch(cfg, n, s, DEV)
    begin_path()
    runs = [workload.greedy_family(cfg, params, batch, workload.FAMILY_MAX_NEW)
            for _ in range(2)]
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    toks, _, t_prefill, t_decode = runs[0]
    if tuple(toks.shape) != (n, workload.FAMILY_MAX_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: bad tokens {toks.tolist()}")
    if not torch.equal(runs[1][0], toks):
        raise AssertionError(f"{arch}: a second run decoded different tokens")
    if any(launches.values()):
        raise AssertionError(f"{arch}: kernels launched: {launches}")
    decoded = n * (workload.FAMILY_MAX_NEW - 1)
    log(f"full width decoding ({arch}, {cfg.family}): {n} requests x {s} prompt tokens"
        f"{' over frames ' + str(list(batch['frames'].shape)) if 'frames' in batch else ''}, "
        f"{workload.FAMILY_MAX_NEW} greedy tokens; weights on device "
        f"{weight_bytes(params) / 1e9:.3f} GB (config: {FAMILY_WEIGHT_GB[arch]} GB); peak "
        f"device memory {peak / 1e9:.3f} GB; prefill {t_prefill:.3f} s (second run "
        f"{runs[1][2]:.3f} s); decode {decoded} tokens in {t_decode:.3f} s = "
        f"{decoded / t_decode:.1f} tokens/s (second run {decoded / runs[1][3]:.1f}); tokens "
        f"identical on a second run; launches {launches}")
    log(teacher_forced_agreement(arch, cfg, params, batch, toks))
    return launches


def xlstm_memory_prediction(cfg, nparams: int, batch: int, seq: int) -> dict:
    """Bytes of the f32 training step (derived from the shapes): the
    parameter states (params, grads, AdamW's m and v, and the update's new
    params, m and v beside the old), the mLSTM's ``C [B, H, dh, dh]`` kept at
    the 64-step chunk boundaries, one chunk's recompute (``C`` and the
    outer product ``v kᵀ`` a step), and ``C`` at every step without the
    chunked recompute."""
    dh = 2 * cfg.d_model // cfg.num_heads
    c = batch * cfg.num_heads * dh * dh * 4
    layers = cfg.num_layers // 2
    return {"states": 7 * 4 * nparams, "boundaries": layers * (-(-seq // MLSTM_CHUNK)) * c,
            "recompute": 2 * MLSTM_CHUNK * c, "every_step": layers * seq * c}


def xlstm_train():
    """``XLSTM``'s training: ``xlstm-350m`` at full width in f32,
    :data:`workload.XLSTM_TRAIN_STEPS` steps of 4 × 256 tokens
    (``HostDataLoader``, seed 0) through ``launch.train.train_step`` (AdamW,
    32-bit moments): finite losses, the peak beside its prediction, no kernel
    launched. Returns the launches."""
    cfg, params = build_logged(lambda dev: workload.build_family(
        "xlstm-350m", dev, "float32", num_layers=workload.XLSTM_TRAIN_LAYERS))
    bundle = get_model(cfg)
    ocfg = AdamWConfig(lr=workload.TRAIN_LR)
    bsz, seq = workload.XLSTM_TRAIN_BATCH, workload.XLSTM_TRAIN_SEQ
    loader = HostDataLoader(vocab=cfg.vocab_size, global_batch=bsz, seq_len=seq, seed=0)
    nparams = sum(t.numel() for t in tree_leaves(params))
    pred = xlstm_memory_prediction(cfg, nparams, bsz, seq)
    begin_path()
    opt = adamw_init(params, ocfg)

    def step(params, opt, batch):
        return train_step(bundle.train_loss, params, opt, batch, ocfg, warmup=10,
                          total=workload.XLSTM_TRAIN_STEPS + 1)

    losses, times = [], []
    for i in range(workload.XLSTM_TRAIN_STEPS):
        batch = batch_to(loader.batch_at(i), DEV)
        if i == 0:
            (params, opt, loss), t = dryrun_train_step("d", f"{cfg.name} f32, {cfg.num_layers} "
                                                       f"layers, {bsz} × {seq}", step,
                                                       (params, opt, batch))
        else:
            (params, opt, loss), t = _timed(lambda: step(params, opt, batch))
        losses.append(float(loss))
        times.append(t)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"xlstm train: losses {losses}")
    if any(launches.values()):
        raise AssertionError(f"xlstm train: kernels launched: {launches}")
    gb = {k: round(v / 1e9, 3) for k, v in pred.items()}
    log(f"full width training ({cfg.name}, {nparams / 1e6:.1f} M params, f32, AdamW 32-bit "
        f"moments): {len(losses)} steps of {bsz} x {seq} tokens, "
        f"{[round(t, 3) for t in times]} s; losses {[round(x, 4) for x in losses]}; peak device "
        f"memory {peak / 1e9:.3f} GB against the prediction (GB, derived) {gb}: states + "
        f"boundaries + one chunk's recompute = "
        f"{(pred['states'] + pred['boundaries'] + pred['recompute']) / 1e9:.3f} GB plus the "
        f"other activations, where C at every step alone would be "
        f"{pred['every_step'] / 1e9:.3f} GB; launches {launches}; "
        f"{beside_pre_remat('xlstm training', cfg)}")
    return launches


#: each training path on the card before the port read ``cfg.remat``
#: (every path trains under the full configs' ``"block"`` since),
#: recomputed attention chunks, stepped the recurrences over rows and kept
#: the loss chunks' table in bf16 (``PERF.md`` §6; NVIDIA H100 80GB HBM3,
#: 700.00 W): ``(peak, s a step)`` as each path prints them
PRE_REMAT_TRAINING = {"TRAIN": ("18.351 GB", "0.1413 s (median)"),
                 "xlstm training": ("6.758 GB", "7.455, 5.332, 5.085 s"),
                 "OTP (h)": ("14.758 GB", "0.511 s"),
                 "STEPS (a)": ("2.044 GB a rank", "1.436-1.437 s"),
                 "STEPS (b)": ("6.864-6.868 GB a rank", "5.31-5.34, 5.04-5.05 s"),
                 "STEPS (c)": ("5.999 GB a rank", "whisper 10.10, recurrentgemma 0.400-0.403, "
                               "xlstm 0.327-0.329 s")}


def beside_pre_remat(path: str, cfg) -> str:
    """This run's ``remat`` and the path's readings before it, for its log line."""
    peak, step = PRE_REMAT_TRAINING[path]
    return f"remat={cfg.remat!r}; before remat: peak {peak}, {step} a step"


def _bitwise_tree(a, b) -> bool:
    return all(bitwise_equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def train_path():
    """``TRAIN``: ``tinyllama-1.1b`` at full width in f32 trained for
    ``TRAIN_STEPS`` steps through ``launch.train.train_step`` (AdamW, 32-bit
    moments, warmup 10) on ``HostDataLoader`` batches, under
    ``torch.use_deterministic_algorithms`` (each op without a deterministic
    form printed): the loss falls; the step is checkpointed (async writer,
    a ``tempfile`` directory) and restored into a fresh trainer, whose next
    step's loss and params equal the uninterrupted run's bit for bit.
    Returns the launches (the dense path runs no kernel of the port)."""
    cfg = dataclasses.replace(get_config(workload.TRAIN_ARCH), dtype="float32",
                              num_layers=workload.TRAIN_LAYERS)
    bundle = get_model(cfg)
    ocfg = AdamWConfig(lr=workload.TRAIN_LR)
    n = workload.TRAIN_STEPS
    loader = HostDataLoader(vocab=cfg.vocab_size, global_batch=workload.TRAIN_BATCH,
                            seq_len=workload.TRAIN_SEQ, seed=0)
    step_kw = dict(warmup=10, total=n + 1)

    def step(params, opt, i):
        return train_step(bundle.train_loss, params, opt, batch_to(loader.batch_at(i), DEV),
                          ocfg, **step_kw)

    begin_path()
    nparams = cfg.param_count()
    pred = nparams * 4 * 7  # params, grads, m, v, and the new params, m, v beside the old
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            (params, opt), dt = _timed(lambda: (lambda p: (p, adamw_init(p, ocfg)))(
                bundle.init(torch.Generator(device=DEV).manual_seed(0))))
            losses, times = [], []
            for i in range(n):
                if i == 0:
                    (params, opt, loss), t_step = dryrun_train_step(
                        "c", f"{cfg.name} f32, {cfg.num_layers} layers, {workload.TRAIN_BATCH} × "
                        f"{workload.TRAIN_SEQ}", lambda p, o, b: train_step(
                            bundle.train_loss, p, o, b, ocfg, **step_kw),
                        (params, opt, batch_to(loader.batch_at(0), DEV)))
                else:
                    (params, opt, loss), t_step = _timed(lambda: step(params, opt, i))
                losses.append(float(loss))
                times.append(t_step)
            peak = torch.cuda.max_memory_allocated()
            if not (np.isfinite(losses).all() and np.mean(losses[-5:]) < np.mean(losses[:5])):
                raise AssertionError(f"train: loss did not fall: {losses}")
            with tempfile.TemporaryDirectory() as tmp:
                free = shutil.disk_usage(tmp).free
                ckpt = Checkpointer(tmp, keep=1)
                (_, _), t_save = _timed(lambda: (ckpt.save(n - 1, {"params": params,
                                                                  "opt": opt}), ckpt.wait()))
                size = sum(os.path.getsize(os.path.join(r, f))
                           for r, _, fs in os.walk(tmp) for f in fs)
                params_a, _, loss_a = step(params, opt, n)
                del params, opt
                fresh = bundle.init(torch.Generator(device=DEV).manual_seed(1))
                like = {"params": fresh, "opt": adamw_init(fresh, ocfg)}
                state, t_load = _timed(lambda: ckpt.restore(n - 1, like))
                del fresh, like
                params_b, _, loss_b = step(state["params"], state["opt"], n)
                del state
        finally:
            torch.use_deterministic_algorithms(False)
    launches = dict(build.LAUNCHES)
    nondet = sorted({str(w.message).split("\n")[0][:160] for w in caught
                     if "deterministic" in str(w.message)})
    same_loss = bitwise_equal(loss_a, loss_b)
    same_params = _bitwise_tree(params_a, params_b)
    gap = max((a - b).abs().max().item()
              for a, b in zip(tree_leaves(params_a), tree_leaves(params_b)))
    log(f"train ({cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{nparams / 1e9:.3f} B params, f32, AdamW 32-bit moments): init {dt:.3f} s; "
        f"{n} steps of {workload.TRAIN_BATCH} x {workload.TRAIN_SEQ} tokens, median "
        f"{statistics.median(times):.4f} s a step (first {times[0]:.3f} s); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first five {[round(x, 4) for x in losses[:5]]}, "
        f"last five {[round(x, 4) for x in losses[-5:]]}); peak device memory "
        f"{peak / 1e9:.3f} GB (predicted {pred / 1e9:.3f} GB plus activations); launches "
        f"{launches}; {beside_pre_remat('TRAIN', cfg)}")
    log(f"train checkpoint: {size / 1e9:.3f} GB written in {t_save:.3f} s ({free / 1e9:.1f} GB "
        f"free in TMPDIR), restored into a fresh trainer in {t_load:.3f} s; step {n} after the "
        f"restore: loss {float(loss_b):.6f} against {float(loss_a):.6f} uninterrupted, loss "
        f"bitwise equal {same_loss}, params bitwise equal {same_params} (max|diff| {gap:.3e}); "
        f"ops without a deterministic form: {nondet or 'none'}")
    if not (same_loss and same_params):
        raise AssertionError("train: the resumed step differs from the uninterrupted one")
    if any(launches.values()):
        raise AssertionError(f"train: kernels launched on the dense training path: {launches}")
    del params_a, params_b
    train_8bit(bundle, loader, dataclasses.replace(ocfg, state_bits=8), step_kw, losses)
    return launches


def train_8bit(bundle, loader, ocfg8, step_kw, losses32):
    """``TRAIN``'s steps again from the same init and batches with 8-bit
    moments (reported beside the 32-bit losses, not gated: the reference's
    linear code for ``v`` steps by ``lr · m̂ / eps`` where a small ``v``
    rounds to 0 and the row's gradient is 0; the card's 8-bit update is
    held to the CPU's by :func:`tiny_adamw8`)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init(torch.Generator(device=DEV).manual_seed(0))
    opt = adamw_init(params, ocfg8)
    losses, times = [], []
    for i in range(workload.TRAIN_STEPS):
        (params, opt, loss), t_step = _timed(lambda: train_step(
            bundle.train_loss, params, opt, batch_to(loader.batch_at(i), DEV), ocfg8, **step_kw))
        losses.append(float(loss))
        times.append(t_step)
    log(f"train 8-bit moments (lr {ocfg8.lr:g}, the same init and batches; reported, not "
        f"gated): median {statistics.median(times):.4f} s a step; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (max {max(losses):.4f} at step {int(np.argmax(losses))}; 32-bit "
        f"{losses32[0]:.4f} -> {losses32[-1]:.4f}); all losses "
        f"{[round(x, 4) for x in losses]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")


def dryrun_bf16_step():
    """``DRYRUN`` (e): ``TRAIN``'s model in bf16 (its first
    ``workload.TRAIN_LAYERS`` layers; the loss chunks' logits from the bf16
    table through one product with an f32 result), one ``train_step`` of
    ``TRAIN_BATCH`` × ``TRAIN_SEQ`` tokens counted and run as (c) is: the
    counted peak over the card's within :data:`DRYRUN_TRAIN_BAND`, the loss
    finite. Returns the launches (none)."""
    cfg = dataclasses.replace(get_config(workload.TRAIN_ARCH), num_layers=workload.TRAIN_LAYERS)
    bundle = get_model(cfg)
    ocfg = AdamWConfig(lr=workload.TRAIN_LR)
    loader = HostDataLoader(vocab=cfg.vocab_size, global_batch=workload.TRAIN_BATCH,
                            seq_len=workload.TRAIN_SEQ, seed=0)
    begin_path()
    params = bundle.init(torch.Generator(device=DEV).manual_seed(0))
    opt = adamw_init(params, ocfg)
    (_, _, loss), _ = dryrun_train_step(
        "e", f"{cfg.name} {cfg.dtype}, {cfg.num_layers} layers, {workload.TRAIN_BATCH} × "
        f"{workload.TRAIN_SEQ}, remat={cfg.remat!r}",
        lambda p, o, b: train_step(bundle.train_loss, p, o, b, ocfg, warmup=10,
                                   total=workload.TRAIN_STEPS + 1),
        (params, opt, batch_to(loader.batch_at(0), DEV)))
    if not math.isfinite(float(loss)):
        raise AssertionError(f"DRYRUN (e): loss {float(loss)}")
    launches = dict(build.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"DRYRUN (e): kernels launched: {launches}")
    return launches


WALLS: dict = {}


def walled(name: str, fn):
    """``fn()``, its host wall time kept in ``WALLS[name]`` (seconds)."""
    t0 = time.perf_counter()
    out = fn()
    WALLS[name] = round(time.perf_counter() - t0, 1)
    return out


def free_model() -> None:
    """Release the last path's model (its references died with the path's
    function) and the allocator's cached blocks before the next is built."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated after freeing the model: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")


#: ``DRYRUN`` (a): production cells counted on ``meta`` on the host, one
#: rank of the single-pod 16 × 16 mesh (``python -m repro_torch.launch.dryrun``'s)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("moonshot-v1-16b-a3b", "decode_32k"),
                ("xlstm-350m", "train_4k"))
#: (b): the quantized prefill step's kernels, and its batch of prompts
DRYRUN_PATH = ("quant_matmul", "moe_gmm_swiglu", "moe_gmm")
DRYRUN_BATCH = 4
#: (b)'s gate: the dry run's peak over the card's, each the bytes the step
#: allocates above what its arguments hold (``PERF.md`` §6, stated before
#: the call that first tested it)
DRYRUN_PEAK_BAND = (0.75, 1.33)
#: (c), (d), (e): the same ratio for the first training step of ``TRAIN``,
#: of the xlstm training and of ``TRAIN``'s model in bf16 (``PERF.md`` §6,
#: stated before the call that first tested it)
DRYRUN_TRAIN_BAND = (0.95, 1.05)


def dryrun_train_step(tag: str, name: str, step, args):
    """``DRYRUN`` (c), (d) and (e): a training path's first ``step(*args)``
    counted by the op counter on ``meta`` copies of its arguments, then run
    on the card, its peak above the arguments measured (the peak zeroed and
    the base taken just before it). The counted peak over the measured must
    lie in :data:`DRYRUN_TRAIN_BAND`. Returns the step's result and its
    seconds."""
    from repro_torch.launch.op_analysis import analyze_step

    t0 = time.perf_counter()
    s = analyze_step(step, tuple(to_device(a, "meta") for a in args))
    count_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    ratio = s.peak_bytes / peak
    log(f"DRYRUN ({tag}) {name}, the first training step: counted on meta in {count_s:.1f} s "
        f"— {s.flops / 1e12:.4f} TFLOP, {s.hbm_bytes / 1e9:.3f} GB of HBM traffic, peak "
        f"{s.peak_bytes / 1e9:.4f} GB above the {base / 1e9:.3f} GB allocated (the arguments); "
        f"on the card: peak {peak / 1e9:.4f} GB above them (counted / measured {ratio:.3f}), "
        f"{dt:.3f} s")
    lo, hi = DRYRUN_TRAIN_BAND
    if not lo <= ratio <= hi:
        raise AssertionError(f"DRYRUN ({tag}): counted peak {s.peak_bytes} B over the card's "
                             f"{peak} B = {ratio:.3f}, outside {DRYRUN_TRAIN_BAND}")
    return out, dt


def dryrun_path():
    """``DRYRUN``: the dry run (``repro_torch.launch.dryrun``), on the host
    and held to the card. (a) :data:`DRYRUN_CELLS` on ``meta`` (rank 0 of
    the production mesh, no process, no device): each cell's roofline
    terms, dominant term and bytes a card printed; each must finish with
    FLOPs above 0. (b) ``build_step``'s quantized ``prefill_step`` (1 × 1) on
    the PMQ + OTP model's first ``workload.CUT_LAYERS`` layers, 4 prompts
    of ``workload.PROMPT_LEN`` tokens: counted by the op counter on
    ``meta`` copies of the same arguments, then run on the card after a
    warm-up run; each kernel's launches counted on ``meta`` must equal
    its ``LAUNCHES`` on the card (:data:`DRYRUN_PATH`'s, and no other), the
    predicted peak over the measured one must lie in
    :data:`DRYRUN_PEAK_BAND`, and the roofline time is printed beside the
    step's device time (not gated). Returns (b)'s launches on the card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.op_analysis import analyze_step

    for arch, shape_name in DRYRUN_CELLS:
        r = dryrun.run_cell(arch, shape_name, False, accum=0, out_dir=None, quiet=True)
        if not r["flops_per_dev"] > 0:
            raise AssertionError(f"DRYRUN: {arch} × {shape_name} counted no FLOPs")
        mem = r["memory"]
        log(f"DRYRUN (a) {arch} × {shape_name}: {r['step']}, rank 0 of 16 × 16 counted on meta "
            f"in {r['trace_s']:.1f} s: {r['flops_per_dev'] / 1e12:.2f} TFLOP, "
            f"{r['hbm_bytes_per_dev'] / 1e12:.3f} TB of HBM traffic, collectives "
            f"{r['collective_bytes_per_dev']}; compute {r['compute_term_s'] * 1e3:.2f} ms, "
            f"memory {r['memory_term_s'] * 1e3:.2f} ms, collective "
            f"{r['collective_term_s'] * 1e3:.2f} ms → {r['dominant']}; "
            f"{mem['per_device_total'] / 1e9:.2f} GB a card (arguments "
            f"{mem['argument'] / 1e9:.2f}, peak {mem['temp'] / 1e9:.2f}; fits 80 GB: "
            f"{mem['fits_80gb']}); launches {r['launches']}")

    begin_path()
    cfg = dataclasses.replace(get_config(workload.ARCH), num_layers=workload.CUT_LAYERS)
    params = build_synthetic(cfg, seed=0, device=DEV)
    shape = ShapeConfig("prefill_32k", workload.PROMPT_LEN, DRYRUN_BATCH, "prefill")
    art = steps.build_step(cfg, shape, None, precision="quant")
    gen = torch.Generator().manual_seed(31)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (DRYRUN_BATCH, workload.PROMPT_LEN),
                                     generator=gen, dtype=torch.int32).to(DEV)}
    t0 = time.perf_counter()
    s = analyze_step(art.fn, (to_device(params, "meta"), to_device(batch, "meta")))
    count_s = time.perf_counter() - t0
    terms = dryrun.roofline(s, steps._one_rank())
    art.fn(params, batch)  # warm-up: handles and the allocator's segments
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = art.fn(params, batch)
    b.record()
    b.synchronize()
    step_ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() - base
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    del out
    roof_ms = max(terms.values()) * 1e3
    log(f"DRYRUN (b) {workload.ARCH} quantized prefill_step, {workload.CUT_LAYERS} layers, "
        f"{DRYRUN_BATCH} × {workload.PROMPT_LEN} tokens on 1 × 1: counted on meta in "
        f"{count_s:.1f} s — {s.flops / 1e12:.4f} TFLOP ({s.flops_by_dtype}), "
        f"{s.hbm_bytes / 1e9:.3f} GB of HBM traffic, launches {s.launches}, peak "
        f"{s.peak_bytes / 1e9:.4f} GB; on the card: launches {launches}, peak "
        f"{peak / 1e9:.4f} GB above the arguments (predicted / measured "
        f"{s.peak_bytes / peak:.3f}), step {step_ms:.3f} ms against the roofline's "
        f"{roof_ms:.3f} ms (compute {terms['compute_term_s'] * 1e3:.3f}, memory "
        f"{terms['memory_term_s'] * 1e3:.3f}; measured / roofline {step_ms / roof_ms:.2f})")
    if launches != s.launches or set(launches) != set(DRYRUN_PATH):
        raise AssertionError(f"DRYRUN: launches on the card {launches} != counted on meta "
                             f"{s.launches} (expected {DRYRUN_PATH})")
    lo, hi = DRYRUN_PEAK_BAND
    if not lo <= s.peak_bytes / peak <= hi:
        raise AssertionError(f"DRYRUN: predicted peak {s.peak_bytes} B over the card's {peak} B "
                             f"= {s.peak_bytes / peak:.3f}, outside {DRYRUN_PEAK_BAND}")
    return dict(build.LAUNCHES)


def full_width():
    """Phase 5: ``DRYRUN`` (:func:`dryrun_path`), then the compressed model's
    five paths, then — the compressed
    model freed — the dense model's, then the uncompressed MoE's and, on the
    same weights, the pipeline's, then the VLM's, the sliding-window
    model's, command-r's and the 384-expert model's, each model freed before
    the next is built. Returns each path's launches."""
    dryrun_launches = walled("DRYRUN", dryrun_path)
    free_model()
    fp_launches, q_launches, mix_launches, preempt_launches, offload_launches, scan_launches, \
        (fp_step, fp_all) = walled("compressed paths", compressed_paths)
    free_model()
    ep_layer_launches, ep_launches = walled("EP", ep_path)
    free_model()
    steps_launches = walled("STEPS", steps_path)
    free_model()
    dense_launches, _, _, _ = walled("dense", lambda: plain_path(
        "dense path", *build_logged(workload.build_dense), workload.DENSE, DENSE_PATH))
    free_model()

    def uncompressed():
        cfg, params = build_logged(workload.build_uncompressed_moe)
        return cfg, params, plain_path("uncompressed MoE path", cfg, params,
                                       workload.UNCOMPRESSED_MOE, UNCOMPRESSED_MOE_PATH)

    cfg, params, (moe_launches, (moe_step, moe_all), moe_out, _) = walled("uncompressed MoE",
                                                                          uncompressed)
    log(f"expert bytes of {workload.ARCH} on the device: uncompressed {moe_all / 1e9:.3f} GB, "
        f"PMQ {fp_all / 1e9:.3f} GB ({moe_all / fp_all:.2f}x); read per decode step: "
        f"uncompressed {moe_step / 1e9:.3f} GB (every expert of every layer), PMQ + OTP fp "
        f"path {fp_step / 1e9:.3f} GB (the routed experts' packed rows; {moe_step / fp_step:.2f}x)")
    compress_launches, (otp_train_launches, otp_launches) = walled(
        "compress + OTP", lambda: compress_path(cfg, params, moe_out))
    del params
    free_model()
    vlm_launches = walled("vlm", vlm_path)
    free_model()
    windowed_launches = walled("windowed", windowed_path)
    free_model()
    command_r_launches = walled("command-r", command_r_path)
    free_model()
    wide_launches = walled("wide MoE", wide_moe_path)
    free_model()
    family_launches = {}
    for arch in workload.FAMILY_ARCHS:
        family_launches[f"{arch} decoding"] = walled(arch, lambda a=arch: family_path(a))
        free_model()
    family_launches["xlstm-350m training"] = walled("xlstm train", xlstm_train)
    free_model()
    train_launches = walled("train", train_path)
    free_model()
    bf16_launches = walled("DRYRUN bf16", dryrun_bf16_step)
    free_model()
    if ORACLE_FAULTS:
        raise AssertionError(f"divergences from the dense-cache oracle with no near-tie within "
                             f"{ORACLE_GAP_ULPS} bf16 ulps: {ORACLE_FAULTS}")
    return {"DRYRUN prefill step": dryrun_launches,
            "fp serving": fp_launches, "int8 KV + prefix serving": q_launches,
            "tenant mix serving": mix_launches, "preemption serving": preempt_launches,
            "offload serving": offload_launches, "scan serving": scan_launches,
            "expert-parallel layer check (4 ranks)": ep_layer_launches,
            "expert-parallel decoding (4 ranks)": ep_launches,
            "OTP step across ranks (4 ranks)": steps_launches,
            "dense serving": dense_launches,
            "uncompressed MoE serving": moe_launches,
            "compressed (pipeline) serving": compress_launches,
            "OTP training": otp_train_launches, "OTP-trained serving": otp_launches,
            "dense training": train_launches, "DRYRUN bf16 training step": bf16_launches,
            "vlm serving": vlm_launches, "windowed serving": windowed_launches,
            "command-r serving": command_r_launches,
            "wide MoE serving": wide_launches, **family_launches}


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

    log(f"build: {walled('build', build.timed_build):.1f} s ({build.BUILD_DIR})")
    t_phases = time.perf_counter()

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
    grad_parity(gen)
    parity_scan_shapes(gen, results)
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
    for model in TINY:
        tiny_preemption(model)
    tiny_offload()
    tiny_pipeline()
    tiny_otp_training()
    tiny_adamw8()
    tiny_ffn_backend()
    tiny_families()
    WALLS["phases 1-4"] = round(time.perf_counter() - t_phases, 1)
    paths = full_width()
    log(f"wall by phase (s, host clock): {WALLS}")

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
         **{key: r[key] for key in ("ms_min", "ms_max", "sm_clock", "prefill", "tp", "long",
                                     "decode_g5",
                                     "window_g2", "decode_g8", "k7168", "k8192", "k17408", "scan",
                                     "split_k_max_abs_err") if key in r}}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
