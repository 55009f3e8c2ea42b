"""Where the time of a full-width decode megastep goes, on one GPU.

    python -m repro_torch.launch.profile_decode

Builds the workload of :mod:`repro_torch.launch.workload` (the one
``chip_smoke.py`` serves: ``moonshot-v1-16b-a3b`` at full width, 48 layers,
bf16, PMQ + OTP, 4 requests into a 4-slot engine, 8-step megasteps), runs
its admissions, prefills and first megastep as a warm-up, times the next
decode megastep without a profiler, then traces the one after it with
``torch.profiler`` (CPU + CUDA activity). Prints one JSON line: the
megastep's wall time with and without the profiler, the device time of
every CUDA kernel, memcpy and memset in the traced one (one stream, so
their sum is the device's busy time), the device's idle share, the number
of device operations per decode step, the port kernels' share, the ten
costliest device operations, and the least time a decode step could take:
the bytes it must move — every dense weight of every layer, the packed rows
and group params of each expert it routed a token to (from the step's
dispatch counts), the KV rows it attends over and the unembedding — over
3.35 TB/s.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..core.tree import weight_bytes
from ..serving import PagedServingEngine
from . import workload

PORT_KERNELS = ("dequant_gemm_kernel", "paged_attention_kernel")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def step_bytes(eng, positions) -> list:
    """Bytes each decode step of the engine's last megastep had to move
    (see the module docstring); ``positions`` are the active slots' KV
    lengths before the megastep."""
    cfg, params = eng.model_cfg, eng.params
    layers = params["layers"]
    dense = sum(weight_bytes({k: v for k, v in p.items() if k != "moe_ce"}) for p in layers)
    unembed = weight_bytes(params.get("unembed", params["embed"]))
    kv_row = 2 * cfg.num_kv_heads * cfg.head_dim * eng.cache.k.element_size()
    bs = eng.ecfg.block_size
    per_slot = []  # expert bytes of each permuted slot, per layer
    for p in layers:
        ce = p["moe_ce"]
        sizes = []
        for i, m in enumerate(ce.meta):
            sizes += [weight_bytes(ce.arrays[f"b{i}"]) / m.count] * m.count
        per_slot.append(np.asarray(sizes))
    out = []
    for s, emit in enumerate(eng.last_emits):
        if not emit.any():
            continue
        experts = sum(float(per_slot[l][eng.last_slot_counts[s, l] > 0].sum())
                      for l in range(len(layers)))
        pages = sum(-(-(positions[slot] + s + 1) // bs) for slot in np.flatnonzero(emit))
        out.append(dense + experts + unembed + len(layers) * pages * bs * kv_row)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode measures the GPU; no CUDA device found")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = workload.build("cuda")
    eng = PagedServingEngine(cfg, params, workload.ENGINE, device="cuda")
    for req in workload.requests(cfg):
        eng.submit(req)
    eng.step()  # admissions, prefills and the first megastep (warm-up)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # one decode megastep, untraced
    plain_wall_s = time.perf_counter() - t0
    positions = {slot: req.pos for slot, req in eng.scheduler.active.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()  # one decode megastep of all 4 slots
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    horizon = workload.ENGINE.decode_horizon
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in device)
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    port_us = sum(t for n, t in by_name.items() if any(k in n for k in PORT_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    nbytes = step_bytes(eng, positions)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "device": smi, "layers": cfg.num_layers, "horizon": horizon,
        "megastep_wall_ms_untraced": plain_wall_s * 1e3,
        "megastep_wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
        "device_ops_per_step": len(device) / horizon,
        "port_kernel_ms": port_us / 1e3,
        "top_device_ops_ms": [[n[:80], t / 1e3] for n, t in top],
        "step_bytes_mean": float(np.mean(nbytes)),
        "step_bound_ms": float(np.mean(nbytes)) / HBM_BYTES_PER_S * 1e3,
    }))


if __name__ == "__main__":
    main()
