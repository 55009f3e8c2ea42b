"""The dry run on one rank of the production mesh (port of
``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh) cell the reference lowers
and compiles the step for a 256- or 512-chip mesh and reads XLA's memory
and cost analyses and its own HLO analyzer. The port has no compiler and
no 256 processes to run: :func:`run_cell` builds the step with
:func:`~repro_torch.launch.steps.build_step` on
:func:`~repro_torch.launch.mesh.production_view` (the mesh's shape and one
rank's coordinate, no process groups), takes that rank's blocks of the
``meta`` argument specs (:func:`~repro_torch.launch.steps.shard_args`),
runs the step on them under the op counter
(:func:`~repro_torch.launch.op_analysis.analyze_step`: FLOPs, HBM bytes,
kernel launches, peak live bytes) and the collective ledger, and writes one
JSON per cell with H100 roofline terms. Nothing is allocated and no card is
needed.

The rank is rank 0, as the reference's SPMD shapes describe every device:
every cut is even but ZeRO-1's 8-bit chunks, whose last is the shortest,
so rank 0 holds the most argument bytes of any rank.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs.base import SHAPES, supported_shapes
from ..configs.registry import ARCH_IDS, get_config
from ..parallel.sharding import Mesh, _children
from . import mesh as mesh_mod
from .op_analysis import analyze_step
from .steps import build_step, shard_args

__all__ = ["COLLECTIVE_BYTES_PER_S", "HBM_BYTES_PER_S", "PEAK_FLOPS", "run_cell",
           "roofline"]

# NVIDIA H100 SXM (NVIDIA's H100 Tensor Core GPU data sheet, SXM5)
#: dense peak per card by the dtype of the products: bf16 tensor cores, and
#: f32 on the CUDA cores (the port runs f32 with IEEE products, no TF32)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: HBM3 bytes per second per card
HBM_BYTES_PER_S = 3.35e12
#: bytes per second each way per card: NVLink 4 within a host of 8 cards,
#: and between hosts one 400 Gb/s InfiniBand NDR NIC a card (as in a DGX H100)
COLLECTIVE_BYTES_PER_S = {"nvlink": 450e9, "network": 50e9}
#: cards per host, on the NVLink switch
HOST_CARDS = 8


def _link(mesh: Mesh, axes) -> str:
    """``nvlink`` where a group over ``axes`` (ranks row-major over the
    mesh's axes) stays within one host's cards, else ``network``."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    span = 1
    for n in names:
        stride = math.prod(mesh.shape[a] for a in mesh.axis_names[mesh.axis_names.index(n) + 1:])
        span += (mesh.shape[n] - 1) * stride
    return "nvlink" if span <= HOST_CARDS else "network"


def roofline(summary, mesh: Mesh) -> Dict[str, float]:
    """The three terms in seconds: FLOPs by dtype over their peak, HBM bytes
    over its rate, each collective's operand bytes over its link's rate."""
    compute = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                  for dt, f in summary.flops_by_dtype.items())
    coll = 0.0
    for kind, nbytes, axes, calls in summary.collective_events:
        coll += nbytes * calls / COLLECTIVE_BYTES_PER_S[_link(mesh, axes)]
    return {"compute_term_s": compute, "memory_term_s": summary.hbm_bytes / HBM_BYTES_PER_S,
            "collective_term_s": coll}


def _leaves(tree):
    """A tree's tensors (PackedTensor, CompressedExperts and Q8 nodes
    opened)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    kids = _children(tree)
    return [t for _, v in kids or () for t in _leaves(v)]


def _bytes_of(tree) -> Dict[int, int]:
    """``{storage id: bytes}`` of a tree's tensors (views share one)."""
    out = {}
    for t in _leaves(tree):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, train_mode: str = "auto",
             precision: str = "auto", accum: int = 1, state_bits: int = 32,
             out_dir: Optional[str] = "results/dryrun_torch", tag: str = "",
             cfg=None, shape=None, mesh: Optional[Mesh] = None, quiet: bool = False) -> dict:
    """One cell's counts on rank 0 of the production mesh (or of ``mesh``,
    a process-less view; ``cfg`` and ``shape`` override the registry's),
    written to ``out_dir`` as ``<arch>_<shape>_<mesh>[_<tag>].json``."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or mesh_mod.production_view(multi_pod)
    t0 = time.time()
    with torch.device("meta"):
        art = build_step(cfg, shape, mesh, train_mode=train_mode, precision=precision,
                         accum=accum, state_bits=state_bits)
        args = shard_args(art, art.arg_specs, mesh, cfg)
        arg_bytes = sum(_bytes_of(args).values())
        donated = {i for i in art.donate_argnums}
        in_storages = _bytes_of([a for i, a in enumerate(args) if i in donated])
        summary = analyze_step(art.fn, args)
    trace_s = time.time() - t0
    out_storages = _bytes_of(summary.result)
    alias = sum(n for k, n in out_storages.items() if k in in_storages)
    terms = roofline(summary, mesh)
    chips = math.prod(mesh.shape.values())
    mesh_name = "multi" if "pod" in mesh.axis_names else "single"
    per_dev = arg_bytes + summary.peak_bytes
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "step": art.name,
        "meta": art.meta,
        "trace_s": trace_s,
        # per device: the rank's blocks
        "flops_per_dev": float(summary.flops),
        "flops_by_dtype": summary.flops_by_dtype,
        "hbm_bytes_per_dev": float(summary.hbm_bytes),
        "collective_bytes_per_dev": {k: float(v) for k, v in summary.collective_bytes.items()},
        "collective_counts": dict(summary.num_collectives),
        "launches": dict(summary.launches),
        "memory": {
            "argument": arg_bytes,
            "output": sum(out_storages.values()),
            "temp": summary.peak_bytes,
            "alias": alias,
            # the arguments and the step's peak of live storages made in it
            # (its new outputs included; donated outputs are written in place)
            "per_device_total": per_dev,
            "fits_80gb": bool(per_dev <= 80e9),
        },
        **terms,
    }
    result["dominant"] = max(("compute_term_s", "memory_term_s", "collective_term_s"),
                             key=lambda k: result[k])
    if not quiet:
        print(f"[{arch} × {shape_name} × {mesh_name}] {art.name} traced on meta in "
              f"{trace_s:.1f}s: compute {terms['compute_term_s'] * 1e3:.2f}ms  memory "
              f"{terms['memory_term_s'] * 1e3:.2f}ms  collective "
              f"{terms['collective_term_s'] * 1e3:.2f}ms → {result['dominant']}  per-dev "
              f"{per_dev / 1e9:.2f}GB (fits80G={result['memory']['fits_80gb']})")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        with open(os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_name}{suffix}.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=tuple(SHAPES))
    p.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    p.add_argument("--all", action="store_true", help="every supported cell")
    p.add_argument("--train-mode", default="auto", choices=("auto", "full", "otp"))
    p.add_argument("--precision", default="auto", choices=("auto", "bf16", "quant"))
    p.add_argument("--accum", type=int, default=0,
                   help="microbatch accumulation (0 = auto per arch)")
    p.add_argument("--state-bits", type=int, default=32, choices=(8, 32))
    p.add_argument("--out", default="results/dryrun_torch")
    p.add_argument("--tag", default="", help="suffix for experiment variants")
    p.add_argument("--keep-going", action="store_true")
    args = p.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all or (args.shape and not args.arch):  # --shape alone: every arch that runs it
        cells = [(arch, s) for arch in ARCH_IDS for s in supported_shapes(get_config(arch))
                 if args.all or s == args.shape]
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape, --shape alone, or --all")
        cells = [(args.arch, args.shape)]
    failures = []
    t0 = time.time()
    for arch, shape_name in cells:
        if shape_name not in supported_shapes(get_config(arch)):
            print(f"[skip] {arch} × {shape_name} (not a supported shape)")
            continue
        for mp in meshes:
            try:
                run_cell(arch, shape_name, mp, train_mode=args.train_mode,
                         precision=args.precision, accum=args.accum,
                         state_bits=args.state_bits, out_dir=args.out, tag=args.tag)
            except Exception:
                traceback.print_exc()
                failures.append((arch, shape_name, mp))
                if not args.keep_going:
                    raise
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print(f"dry-run complete: {len(cells)} cells × {len(meshes)} mesh(es) in "
          f"{time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
