"""Serve the full-width fp and int8 KV + shared-prefix workloads of one
checkout on one GPU and print what they emitted, so two trees' outputs can be
compared in one call.

    python3 src/repro_torch/launch/fp_tokens.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: the checkout this file
lies in); run it as a file, not with ``-m``. Builds that tree's
``launch/workload.py`` model (``moonshot-v1-16b-a3b`` at full width, PMQ +
OTP, seed 0) and serves ``ENGINE`` and ``SHARED_PREFIX`` once each. Prints
one JSON line: per workload the SHA-256 of the greedy tokens (request ids
in order), the OTP expert activation, decode tokens/s and mean TTFT, and
the device's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch


def digest(out: dict) -> str:
    return hashlib.sha256(json.dumps([out[r] for r in sorted(out)]).encode()).hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[3],
                    help="checkout whose src/repro_torch serves")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fp_tokens serves on the GPU; no CUDA device found")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(args.root.resolve() / "src"))
    workload = importlib.import_module("repro_torch.launch.workload")
    serving = importlib.import_module("repro_torch.serving")
    cfg, params = workload.build("cuda")
    result = {"root": str(args.root)}
    for name, ecfg, reqs in (("fp", workload.ENGINE, workload.requests),
                             ("shared_prefix", workload.SHARED_PREFIX,
                              workload.shared_prefix_requests)):
        eng = serving.PagedServingEngine(cfg, params, ecfg, device="cuda")
        out = eng.serve(reqs(cfg))
        torch.cuda.synchronize()
        s = eng.summary()
        result[name] = {"tokens_sha256": digest(out), "expert_activation":
                        s["expert_activation"], "decode_tokens_per_s": s["decode_tokens_per_s"],
                        "ttft_mean_s": s["ttft_mean_s"]}
    result["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
