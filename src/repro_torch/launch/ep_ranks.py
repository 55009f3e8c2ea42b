"""Expert parallelism across processes on one machine: ``W`` ranks over
gloo, each holding its share of a compressed model's expert buckets, driven
through the port's entry points under ``sharding_rules``.

:func:`run` spawns the ranks (:func:`~repro_torch.launch.mesh.spawn_ranks`;
the parameters reach them as shared tensors — CUDA IPC on the card, shared
memory on the CPU — so the model is built once) and returns each rank's
results, as numpy arrays and plain values:

* the layer check: layer 0's compressed MoE (``compressed_moe_layer``) on
  each input of ``inputs`` (this rank's block of the batch), on each mesh of
  ``meshes`` and each expert-FFN backend of ``backends``: the output, the
  OTP ``mask_l1``, the launches and the rank's coordinate;
* greedy decoding (``workload.greedy_family``: the dense-cache prefill of
  ``batch`` and ``steps`` greedy tokens) on a ``data=1 × model=W`` mesh:
  tokens, per-step logits (rank 0), launches, wall;
* each rank's expert bytes (layer 0 on every mesh; all layers on the
  decode mesh), peak device memory, the route each collective took and
  the wall-clock time it started (its payload open, the group joined).

The kernels must be built before the ranks start (``chip_smoke.py``'s phase
2 builds them): a rank on the card loads the library and never builds it.
``chip_smoke.py``'s ``EP`` path runs this with the ranks sharing one card.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["run"]


def _cases(rank: int, world: int, payload: Dict) -> Dict:
    from ..core.compressed_moe import compressed_moe_layer
    from ..kernels import build
    from ..parallel.ep_shardmap import shard_experts, shard_params
    from ..parallel.sharding import ROUTES, sharding_rules
    from . import workload
    from .mesh import load_rank_kernels, make_test_mesh

    started = time.time()
    cfg, params = payload["cfg"], payload["params"]
    device = params["embed"].device
    load_rank_kernels(rank, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    p0 = params["layers"][0]
    out: Dict = {"layer": {}, "layer_bytes": {}, "started_at": started}
    for data, model in payload["meshes"]:
        mesh = make_test_mesh(data=data, model=model)
        ce = shard_experts(p0["moe_ce"], mesh)
        out["layer_bytes"][(data, model)] = (dict(mesh.coord), ce.weight_bytes)
        for name, x in payload["inputs"].items():
            b = x.shape[0] // data
            xl = x[mesh.coord["data"] * b:(mesh.coord["data"] + 1) * b]
            for backend in payload["backends"]:
                build.reset_launches()
                with torch.no_grad(), sharding_rules(mesh):
                    y, info = compressed_moe_layer(p0["moe"], ce, xl, cfg,
                                                   otp_params=p0.get("otp"),
                                                   ffn_backend=backend)
                sync()
                out["layer"][(data, model, name, backend)] = (
                    dict(mesh.coord), y.float().cpu().numpy(), float(info["mask_l1"]),
                    dict(build.LAUNCHES))
        del ce
    out["layer_wall_s"] = time.perf_counter() - t0
    mesh = make_test_mesh(data=1, model=world)
    local = shard_params(params, mesh, cfg)
    out["expert_bytes"] = sum(p["moe_ce"].weight_bytes for p in local["layers"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    build.reset_launches()
    t1 = time.perf_counter()
    with sharding_rules(mesh):
        toks, logits, prefill_s, decode_s = workload.greedy_family(
            cfg, local, payload["batch"], payload["steps"])
    out["greedy_wall_s"] = time.perf_counter() - t1
    out["greedy"] = (toks.numpy(), logits.numpy() if rank == 0 else None, prefill_s,
                     decode_s)
    out["greedy_launches"] = dict(build.LAUNCHES)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    out["routes"] = dict(ROUTES)
    out["wall_s"] = time.perf_counter() - t0
    return out


def run(cfg, params: Dict, *, world: int, inputs: Dict[str, torch.Tensor],
        meshes: Sequence[Tuple[int, int]], backends: Sequence[str], batch: Dict,
        steps: int) -> List[Dict]:
    """Spawn ``world`` ranks over ``params`` (whole; each rank keeps its
    share) and return their results, by rank
    (:func:`~repro_torch.launch.mesh.spawn_ranks`: fails if a rank fails or
    misses the deadline; every rank process is ended before it returns)."""
    from .mesh import spawn_ranks

    payload = dict(cfg=cfg, params=params, inputs=inputs, meshes=list(meshes),
                   backends=list(backends), batch=batch, steps=steps)
    return spawn_ranks(_cases, payload, world=world, name="expert-parallel")
