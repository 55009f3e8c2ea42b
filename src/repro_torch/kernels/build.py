"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` — one process per
source, all started together — and links the objects into one shared
library with a plain C interface under ``<repo>/build/kernels/``, named by
a hash of the sources and flags (a changed source rebuilds; an unchanged
one loads the cached library). The library is loaded with ``ctypes``:
pointers and the stream travel as ``c_void_p``, ints as ``c_int``.

The build runs at the first kernel launch, so importing the package (as
the CPU tests do) needs neither ``nvcc`` nor a card. A missing ``nvcc`` or
a failed compile raises. Each compile's ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside the library as
``<source>-<hash>.ptxas.log``.

Every kernel wrapper counts its launches here (:data:`LAUNCHES`), one per
kernel launch and nowhere else, so a run can show that its main path went
through each kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = [
    "BUILD_DIR",
    "DTYPE_CODES",
    "LAUNCHES",
    "build",
    "check",
    "load_library",
    "reset_launches",
    "stream_ptr",
    "timed_build",
]

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: launches per kernel wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {
    "quant_matmul": 0, "moe_gmm": 0, "moe_gmm_swiglu": 0, "paged_attention": 0,
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w0, w1, scale, zero, y, M, K, N, bits, group, dtype, stream
    "repro_quant_matmul": [_P] * 6 + [_I] * 6 + [_P],
    # x, w0, w1, scale, zero, block_expert, num_active, y, M, K, N, bits,
    # group, bm, dtype, stream
    "repro_moe_gmm": [_P] * 8 + [_I] * 7 + [_P],
    # x, (g0, g1, gs, gz), (u0, u1, us, uz), block_expert, num_active, y,
    # M, K, N, bits, group, bm, dtype, stream
    "repro_moe_gmm_swiglu": [_P] * 12 + [_I] * 7 + [_P],
    # q, k_pool, v_pool, tables, lengths, out, B, Hkv, G, dh, BS, MB,
    # window, scale, dtype, stream
    "repro_paged_attention": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (cached by content).

    Objects and logs go to a directory of this process's own, and only the
    finished library and logs are moved into :data:`BUILD_DIR`, so two
    processes that build at once never see each other's partial files."""
    digest = _digest()
    lib = BUILD_DIR / f"librepro_kernels-{digest}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"build-{digest}-", dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            obj = work / f"{src.stem}.o"
            log = open(work / f"{src.stem}.ptxas.log", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, log, subprocess.Popen(cmd, stdout=log,
                                                          stderr=subprocess.STDOUT)))
        failed = []
        for src, _, log, proc in procs:
            if proc.wait() != 0:
                failed.append(src.name)
            log.close()
        for src, _, log, _ in procs:
            os.replace(log.name, BUILD_DIR / f"{src.stem}-{digest}.ptxas.log")
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}; see {BUILD_DIR}/*-{digest}.ptxas.log")
        tmp = work / lib.name
        subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                        *(str(o) for _, o, _, _ in procs)], check=True)
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def load_library() -> ctypes.CDLL:
    """Build on first use and load the library with typed signatures."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def timed_build() -> float:
    """Build (or load) the library; returns the seconds it took."""
    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        msg = load_library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
