"""Split the bf16 dequant-GEMM body's time between its products and the rest.

    python -m repro_torch.launch.probe_dequant

Builds ``csrc/dequant_gemm_sm90.cuh`` twice with ``nvcc`` into
``build/probe/``: as it ships, and with ``-DREPRO_SM90_PROBE_NO_PRODUCTS``,
which leaves out the k16 loop of A-fragment lookups and tensor-core
products (staging, value tables, the warps' reduction, the SwiGLU epilogue,
stores and the dead-row zeros stay). Times both at the main path's shapes —
``quant_matmul`` at decode (M=4, K=N=2048) and prefill (M=16, K=2048,
N=2816), 4-bit, and the 2-bit bucket at decode (59 experts, capacity 24,
bm 8, 20 live row blocks) through ``moe_gmm`` (K=1408 → N=2048) and
``moe_gmm_swiglu`` (two operands, K=2048 → N=1408) — as the median of 50
launches with the L2 flushed before each and without, plus an empty
``zero_`` of one element as the floor of the timing method. Prints one JSON
line. A probe of where the time goes, not a kernel of the port: nothing
imports it.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ..core.quantizers import quantize_parts
from ..kernels import build

PROBE_DIR = build.BUILD_DIR.parent / "probe"
_SHIM = """#include "dequant_gemm_sm90.cuh"
extern "C" int probe_gemm(const void* x, const void* w0, const void* w1, const void* scale,
                          const void* zero, const void* u0, const void* u1, const void* u_scale,
                          const void* u_zero, const void* be, const void* na, void* y, int M,
                          int K, int N, int bits, int group, int rows, void* stream) {
    repro::Operand a{static_cast<const uint8_t*>(w0), static_cast<const uint8_t*>(w1),
                     static_cast<const float*>(scale), static_cast<const float*>(zero)};
    repro::Operand b{static_cast<const uint8_t*>(u0), static_cast<const uint8_t*>(u1),
                     static_cast<const float*>(u_scale), static_cast<const float*>(u_zero)};
    const int* bp = static_cast<const int*>(be);
    const int* np = static_cast<const int*>(na);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (u0 != nullptr)  // a second operand: SwiGLU
        return (int)repro::sm90::dispatch<2>(x, a, b, bp, np, y, M, K, N, bits, group, rows, s);
    return (int)repro::sm90::dispatch<1>(x, a, a, bp, np, y, M, K, N, bits, group, rows, s);
}
"""
VARIANTS = {"full": [], "no_products": ["-DREPRO_SM90_PROBE_NO_PRODUCTS"]}


def _libraries() -> dict:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    shim = PROBE_DIR / "probe.cu"
    shim.write_text(_SHIM)
    procs = {}
    for name, flags in VARIANTS.items():
        cmd = [build._nvcc(), *build.NVCC_FLAGS[:-2], "-shared", "-I", str(build.SRC_DIR),
               *flags, "-o", str(PROBE_DIR / f"probe_{name}.so"), str(shim)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} probe:\n{err}")
        lib = ctypes.CDLL(str(PROBE_DIR / f"probe_{name}.so"))
        lib.probe_gemm.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.probe_gemm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _time_ms(fn, flush: bool, iters: int = 50) -> float:
    """Median device time (CUDA events) with the stream held while the host
    enqueues, optionally after flushing the 50 MB L2 (as chip_smoke.py)."""
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    ts = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if flush:
            scrub.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _cases(gen):
    dev = torch.device("cuda")

    def weights(e, k, n, bits):
        w = torch.randn((e, k, n), generator=gen, device=dev) * k**-0.5
        return quantize_parts(w, bits, 128, refine=False)

    cases = {}
    for name, (m, k, n) in (("quant_matmul decode M=4 K=2048 N=2048 4-bit", (4, 2048, 2048)),
                            ("quant_matmul prefill M=16 K=2048 N=2816 4-bit", (16, 2048, 2816))):
        data, s, z = weights(1, k, n, 4)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        cases[name] = (x, (data[0], None, s[0], z[0]), None, None, None, y, m, k, n, 4, 8)
    experts, cap, bm = 59, 24, 8
    live = [1] * 16 + [2] * 4
    ids = [e for e, r in enumerate(live) for _ in range(-(-r // bm))]
    nlive = len(ids)
    ids += [experts - 1] * (experts * cap // bm - nlive)
    be = torch.tensor(ids, dtype=torch.int32, device=dev)
    na = torch.tensor([nlive], dtype=torch.int32, device=dev)
    for name, (k, n), nop in (("moe_gmm", (1408, 2048), 1), ("moe_gmm_swiglu", (2048, 1408), 2)):
        ops = []
        for _ in range(nop):
            data, s, z = weights(experts, k, n, 2)
            ops.append((data, None, s, z))
        x = torch.randn((experts * cap, k), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.empty((experts * cap, n), dtype=torch.bfloat16, device=dev)
        key = f"{name} 2-bit bucket decode, 20 live blocks of 177, K={k} N={n}"
        cases[key] = (x, ops[0], ops[1] if nop == 2 else None, be, na, y, experts * cap, k, n,
                      2, bm)
    return cases


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_dequant measures the GPU; no CUDA device found")
    libs = _libraries()
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    out = {}
    for name, c in _cases(torch.Generator(device="cuda").manual_seed(0)).items():
        row = {}
        for variant, lib in libs.items():
            def call(lib=lib):
                x, a, b, be, na, y, m, k, n, bits, rows = c
                rc = lib.probe_gemm(ptr(x), *map(ptr, a), *map(ptr, b or (None,) * 4),
                                    ptr(be), ptr(na), ptr(y), m, k, n, bits, 128, rows, stream)
                if rc != 0:
                    raise RuntimeError(f"probe launch failed: CUDA error {rc}")
            row[f"{variant}_ms_flushed"] = _time_ms(call, flush=True)
            row[f"{variant}_ms_warm"] = _time_ms(call, flush=False)
        out[name] = row
    one = torch.empty(1, device="cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "cases": out,
                      "empty_zero_ms_flushed": _time_ms(lambda: one.zero_(), flush=True)}))


if __name__ == "__main__":
    main()
