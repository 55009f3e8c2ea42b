"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each failure exits non-zero):

1. device line (``nvidia-smi`` name and power limit); TF32 off;
2. build the Hopper kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
3. kernel parity: each kernel against its plain PyTorch version on the
   card at the main path's shapes (bits 1/2/3/4, dead row blocks, G = 1 and
   2, windows, ragged lengths, permuted block tables; f32 and bf16), then
   its time beside the plain version, one library call and its bound;
4. tiny end-to-end parity: ``moonshot-v1-16b-a3b.reduced()`` (f32, PMQ +
   OTP, one seed) served on the card and on the CPU — identical greedy
   tokens, per-step logits within 1e-3·max|logit|; then one decode
   megastep on the card under ``set_sync_debug_mode("error")``, which
   fails if anything inside the horizon waits on the host;
5. full-width serving: the workload of ``repro_torch.launch.workload``
   (``moonshot-v1-16b-a3b`` at full width and all 48 layers in bf16, 4
   requests of 64 prompt and 32 new tokens) through ``PagedServingEngine``;
   every kernel must launch during serving and a second engine must emit
   byte-identical tokens;
6. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the JAX package, and refuses to run
without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
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
from repro_torch.core.synthetic import bucket_counts, build_synthetic  # noqa: E402
from repro_torch.core.tree import to_device, weight_bytes  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_swiglu  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.launch import workload  # noqa: E402
from repro_torch.models.moe import dispatch_capacity  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _paged_decode_core,
    paged_decode_horizon,
    paged_prefill_chunk,
)
from repro_torch.serving import EngineConfig, PagedKVCache, PagedServingEngine, Request  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 TC / f32 CUDA cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # × max|plain|, see module docstring
KERNELS = {
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:99"),
    "moe_gmm_swiglu": ("src/repro_torch/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:191"),
    "moe_gmm": ("src/repro_torch/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:93"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:225"),
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


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events).

    Before each timed launch the 50 MB L2 is flushed (weights then come
    from memory, as on the main path) and the stream is held by a ~1 ms
    device sleep while the host enqueues flush, events and ``fn`` — so the
    events bracket device work only, never the host's launch overhead."""
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        scrub.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


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
    # main-path decode shape: wq at 4 slots, 4-bit, bf16
    m, k, n = 4, 2048, 2048
    (data, s, z) = rand_weights(gen, 1, k, n, 4)
    data, s, z = data[0], s[0], z[0]
    x = torch.randn((m, k), generator=gen, device=DEV).to(torch.bfloat16)
    w_deq = ref.dequant_ref(data, s, z, 4, k, dtype=torch.bfloat16)
    results["quant_matmul"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: quant_matmul(x, data, s, z, bits=4)),
        plain_ms=time_ms(lambda: ref.quant_matmul_ref(x, data, s, z, bits=4)),
        library_ms=time_ms(lambda: torch.matmul(x, w_deq)),
        shape=f"M={m} K={k} N={n} 4-bit bf16",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes(x, data, s, z) + m * n * 2, 2 * m * k * n, torch.bfloat16))),
    )


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
    err = compare(f"{kind} b{bits} bm{bm} {dtype}", got, want, dtype)
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
        # main-path decode shape: the 2-bit bucket at 4 slots, bf16; 20 live experts
        _, n2, _ = bucket_counts(cfg.num_experts)
        live = [1] * 16 + [2] * 4 + [0] * (n2 - 20)
        err, c = _gmm_case(gen, kind, 2, torch.bfloat16, decode_cap, n2, live, k, n)
        errs.append(err)
        x, ws, be, na, bm, nlive, m = (c[key] for key in ("x", "ws", "be", "na", "bm",
                                                           "nlive", "m"))
        # the bytes and products this routing needs: the packed rows and group
        # params of the experts it touches, its routed rows of x, all of y
        used = sorted(set(be[:nlive].tolist()))
        w_bytes = sum(nbytes(t) // n2 * len(used) for w in ws for t in w)
        rows = sum(live)
        io_bytes = rows * k * 2 + m * n * 2
        if kind == "moe_gmm":
            call = lambda: moe_gmm(x, *ws[0], be, na, bits=2, bm=bm)
            plain = lambda: ref.moe_gmm_ref(x, *ws[0], be, na, bits=2, bm=bm)
            w_live = ref.dequant_ref(*ws[0], 2, k, dtype=torch.bfloat16)[be[:nlive].long()]
            x_live = x[: nlive * bm].view(nlive, bm, k)
            library = time_ms(lambda: torch.bmm(x_live, w_live))
        else:
            (wg, gs, gz), (wu, us, uz) = ws
            args = (wg, wu, gs, gz, us, uz, be, na)
            call = lambda: moe_gmm_swiglu(x, *args, bits=2, bm=bm)
            plain = lambda: ref.moe_gmm_swiglu_ref(x, *args, bits=2, bm=bm)
            library = None
        results[kind] = dict(
            max_abs_err=max(errs), ms=time_ms(call), plain_ms=time_ms(plain),
            library_ms=library,
            shape=f"2-bit bucket of {n2} experts, cap {decode_cap}, bm {bm}, "
                  f"{nlive} live blocks of {m // bm}, K={k} N={n} bf16",
            **dict(zip(("bound_ms", "bound_by"),
                       bound(w_bytes + io_bytes, 2 * len(ws) * rows * k * n,
                             torch.bfloat16))),
        )


def _attn_case(gen, dtype, b, hkv, g, dh, bs, nb, mb, lengths, window):
    q = torch.randn((b, hkv, g, dh), generator=gen, device=DEV).to(dtype)
    kp = torch.randn((nb, bs, hkv, dh), generator=gen, device=DEV).to(dtype)
    vp = torch.randn((nb, bs, hkv, dh), generator=gen, device=DEV).to(dtype)
    perm = torch.randperm(nb, generator=gen, device=DEV)[: b * mb]
    tables = perm.reshape(b, mb).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    got = paged_attention(q, kp, vp, tables, lens, window=window)
    want = ref.paged_attention_ref(q, kp, vp, tables, lens, window=window)
    err = compare(f"paged_attention G{g} win{window} {dtype}", got, want, dtype)
    return err, (q, kp, vp, tables, lens)


def parity_paged_attention(gen, results):
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for g, hkv, window in [(1, 16, None), (2, 8, None), (2, 8, 20), (1, 16, 7)]:
            errs.append(_attn_case(gen, dtype, 4, hkv, g, 128, 16, 40, 6,
                                   [1, 17, 80, 96], window)[0])
    # main-path decode shape: 4 slots mid-decode (prompt 64 + 16 new), bf16
    b, hkv, g, dh, bs, mb = 4, 16, 1, 128, 16, 6
    lengths = [80, 80, 80, 80]
    err, (q, kp, vp, tables, lens) = _attn_case(gen, torch.bfloat16, b, hkv, g, dh, bs,
                                                 24, mb, lengths, None)
    errs.append(err)
    pages = sum(-(-n // bs) for n in lengths)
    kv_bytes = pages * bs * hkv * dh * 2 * 2
    phys = (tables.long()[:, :, None] * bs + torch.arange(bs, device=DEV)).reshape(b, -1)
    k_g = kp.reshape(-1, hkv, dh)[phys].permute(0, 2, 1, 3)
    v_g = vp.reshape(-1, hkv, dh)[phys].permute(0, 2, 1, 3)
    mask = (torch.arange(mb * bs, device=DEV)[None, :] < lens[:, None].long())[:, None, None]
    qs = q.reshape(b, hkv, g, dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results["paged_attention"] = dict(
        max_abs_err=max(errs),
        ms=time_ms(lambda: paged_attention(q, kp, vp, tables, lens)),
        plain_ms=time_ms(lambda: ref.paged_attention_ref(q, kp, vp, tables, lens)),
        library_ms=time_ms(lambda: sdpa(qs, k_g, v_g, attn_mask=mask)),
        shape=f"B={b} Hkv={hkv} G={g} dh={dh} BS={bs} len={lengths[0]} bf16",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(kv_bytes + 2 * nbytes(q) + nbytes(tables, lens),
                         4 * b * hkv * g * sum(lengths) * dh, torch.bfloat16))),
    )


# ------------------------------------------------ phase 4: tiny parity
def greedy_logits(cfg, params, prompt, max_new, device):
    """Greedy decode of one request through the paged model functions,
    returning the tokens and the logits that chose each of them."""
    ecfg = EngineConfig()
    mcfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
    cache = PagedKVCache(cfg, num_blocks=8, block_size=16, max_slots=1,
                         max_blocks_per_slot=8, device=device)
    slot = cache.acquire_slot(len(prompt) + max_new)
    table = cache.tables_device()
    steps, toks = [], []
    for off in range(0, len(prompt), ecfg.prefill_chunk):
        n = min(ecfg.prefill_chunk, len(prompt) - off)
        chunk = torch.zeros((1, ecfg.prefill_chunk), dtype=torch.long, device=device)
        chunk[0, :n] = torch.as_tensor(prompt[off:off + n], device=device)
        logits, _ = paged_prefill_chunk(params, cache.k, cache.v, table[slot:slot + 1], chunk,
                                        off, n, mcfg, block_size=16)
    for i in range(max_new):
        steps.append(logits[0, -1].float().cpu())
        toks.append(int(torch.argmax(steps[-1])))
        if i == max_new - 1:
            break
        logits, _, _ = _paged_decode_core(
            params, cache.k, cache.v, table, torch.tensor([[toks[-1]]], device=device),
            torch.tensor([len(prompt) + i], device=device, dtype=torch.int32),
            torch.ones(1, dtype=torch.bool, device=device), mcfg, 8, 16, use_otp=True,
        )
    return toks, steps


def sync_free_megastep(cfg, params):
    """One decode megastep on the card under ``set_sync_debug_mode("error")``:
    anything inside the horizon that waits on the device (an ``.item()``, a
    ``bincount``, a blocking copy) raises."""
    mcfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts))
    cache = PagedKVCache(cfg, num_blocks=8, block_size=16, max_slots=2,
                         max_blocks_per_slot=4, device=DEV)
    cache.acquire_slot(40)
    cache.acquire_slot(30)
    i32 = dict(dtype=torch.int32, device=DEV)
    args = (params, cache.k, cache.v, cache.tables_device(),
            torch.tensor([[3], [5]], device=DEV), torch.tensor([20, 7], **i32),
            torch.ones(2, dtype=torch.bool, device=DEV), mcfg)
    kw = dict(block_size=16, horizon=4, budgets=torch.tensor([4, 2], **i32),
              eos_ids=torch.full((2,), -1, **i32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, emits, _, _ = paged_decode_horizon(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if emits.sum(dim=0).tolist() != [4, 2]:
        raise AssertionError(f"sync-free megastep emitted {emits.sum(dim=0).tolist()}")
    log("decode megastep under sync debug mode 'error': no host sync inside the horizon")


def tiny_parity():
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    params_cpu = build_synthetic(cfg, seed=0, device="cpu")
    params_gpu = to_device(params_cpu, DEV)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (20, 33, 7)]
    ecfg = EngineConfig(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
                        prefill_chunk=16, decode_horizon=4)
    outs = {}
    for name, dev, params in (("card", DEV, params_gpu), ("cpu", "cpu", params_cpu)):
        eng = PagedServingEngine(cfg, params, ecfg, device=dev)
        outs[name] = eng.serve(Request(rid=i, prompt=p, max_new=12) for i, p in enumerate(prompts))
    worst = 0.0
    for i, p in enumerate(prompts):
        tg, lg = greedy_logits(cfg, params_gpu, p, 12, DEV)
        tc, lc = greedy_logits(cfg, params_cpu, p, 12, "cpu")
        for s, (a, b) in enumerate(zip(lg, lc)):
            rel = (a - b).abs().max().item() / b.abs().max().item()
            worst = max(worst, rel)
            if rel > 1e-3:
                raise AssertionError(f"request {i} step {s}: logits differ by {rel:.2e}·max")
            if tg[s] != tc[s]:
                top2 = torch.topk(b, 2).values
                gap = (top2[0] - top2[1]).item() / b.abs().max().item()
                if gap >= 1e-4:
                    raise AssertionError(f"request {i} step {s}: tokens {tg[s]} != {tc[s]} "
                                         f"with a top-2 gap of {gap:.2e}·max")
                log(f"  request {i} diverges at step {s} on a genuine tie (gap {gap:.1e})")
                break
        if outs["card"][i] != outs["cpu"][i] and tg == tc:
            raise AssertionError(f"request {i}: engine tokens differ between card and cpu")
    log(f"tiny parity: {len(prompts)} requests, engine tokens card == cpu: "
        f"{outs['card'] == outs['cpu']}, worst per-step logit diff {worst:.2e}·max")
    sync_free_megastep(cfg, params_gpu)


# ------------------------------------------------ phase 5: full width
def full_width():
    t0 = time.perf_counter()
    cfg, params = workload.build(DEV)
    torch.cuda.synchronize()
    log(f"full width: {cfg.name} d_model={cfg.d_model} layers={cfg.num_layers} "
        f"experts={cfg.num_experts} top-{cfg.top_k} vocab={cfg.vocab_size} bf16; "
        f"built in {time.perf_counter() - t0:.1f} s; "
        f"weights on device {weight_bytes(params) / 1e9:.3f} GB")
    max_new = workload.MAX_NEW

    def serve():
        eng = PagedServingEngine(cfg, params, workload.ENGINE, device=DEV)
        out = eng.serve(workload.requests(cfg))
        torch.cuda.synchronize()
        return eng, out

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    eng, out = serve()
    launches = dict(build.LAUNCHES)
    for rid, toks in out.items():
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: bad output {toks}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched while serving: {missing}")
    _, out2 = serve()
    if out2 != out:
        raise AssertionError("a second engine served different tokens")
    s = eng.summary()
    log(f"full width serving: {len(out)} requests x {max_new} tokens; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; TTFT mean {s['ttft_mean_s']:.3f} s "
        f"max {s['ttft_max_s']:.3f} s; decode {s['decode_tokens']} tokens in "
        f"{s['decode_s']:.3f} s = {s['decode_tokens_per_s']:.1f} tokens/s; "
        f"OTP expert activation {s['expert_activation']:.4f}; launches {launches}; "
        f"second engine tokens identical")
    log("full width serving summary: " + json.dumps(s))
    return launches


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
    parity_quant_matmul(gen, results)
    parity_moe(gen, results, cfg)
    parity_paged_attention(gen, results)
    for name, r in results.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {name} [{r['shape']}]: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
            f"max|err| {r['max_abs_err']:.3e}")

    tiny_parity()
    launches = full_width()

    kernels = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in results.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
