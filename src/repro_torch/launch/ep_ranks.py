"""Expert parallelism across processes on one machine: ``W`` ranks over
gloo, each holding its share of a compressed model's expert buckets, driven
through the port's entry points under ``sharding_rules``.

:func:`run` spawns the ranks (``torch.multiprocessing``, spawn start
method; the parameters reach them as shared tensors — CUDA IPC on the card,
shared memory on the CPU — so the model is built once; each rank gets them
through a queue of its own once all have started, so they open them at
once rather than one after another) and returns each
rank's results, as numpy arrays and plain values:

* the layer check: layer 0's compressed MoE (``compressed_moe_layer``) on
  each input of ``inputs`` (this rank's block of the batch), on each mesh of
  ``meshes`` and each expert-FFN backend of ``backends``: the output, the
  OTP ``mask_l1``, the launches and the rank's coordinate;
* greedy decoding (``workload.greedy_family``: the dense-cache prefill of
  ``batch`` and ``steps`` greedy tokens) on a ``data=1 × model=W`` mesh:
  tokens, per-step logits (rank 0), launches, wall;
* each rank's expert bytes (layer 0 on every mesh; all layers on the
  decode mesh), peak device memory, the route each collective took and
  the wall-clock time it started (its payload open).

The kernels must be built before the ranks start (``chip_smoke.py``'s phase
2 builds them): a rank on the card loads the library and never builds it.
``chip_smoke.py``'s ``EP`` path runs this with the ranks sharing one card.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["run"]

#: host threads of each rank (four ranks share the host's cores)
RANK_THREADS = 2
#: the ranks' deadline, from their start to their results
TIMEOUT_S = 300.0


def _rank(rank: int, world: int, store: str, inbox, queue) -> None:
    try:
        payload = inbox.get()  # the shared weights, opened here by every rank at once
        started = time.time()
        out = _cases(rank, world, store, payload)
        out["started_at"] = started
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails
        queue.put((rank, traceback.format_exc()))


def _cases(rank: int, world: int, store: str, payload: Dict) -> Dict:
    import torch.distributed as dist

    from ..core.compressed_moe import compressed_moe_layer
    from ..kernels import build
    from ..parallel.ep_shardmap import shard_experts, shard_params
    from ..parallel.sharding import ROUTES, sharding_rules
    from . import workload
    from .mesh import make_test_mesh

    torch.set_num_threads(RANK_THREADS)
    cfg, params = payload["cfg"], payload["params"]
    device = params["embed"].device
    if device.type == "cuda":
        if not build.library_path().exists():
            raise RuntimeError(f"rank {rank}: {build.library_path()} is not built; ranks load "
                               f"the kernels, they never build them")
        build.load_library()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        p0 = params["layers"][0]
        out: Dict = {"layer": {}, "layer_bytes": {}}
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
        local = shard_params(params, mesh)
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
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def run(cfg, params: Dict, *, world: int, inputs: Dict[str, torch.Tensor],
        meshes: Sequence[Tuple[int, int]], backends: Sequence[str], batch: Dict,
        steps: int) -> List[Dict]:
    """Spawn ``world`` ranks over ``params`` (whole; each rank keeps its
    share) and return their results, by rank. Fails if a rank fails or the
    ranks do not finish within :data:`TIMEOUT_S`; every rank process is
    ended before it returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    payload = dict(cfg=cfg, params=params, inputs=inputs, meshes=list(meshes),
                   backends=list(backends), batch=batch, steps=steps)
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        inboxes = [ctx.SimpleQueue() for _ in range(world)]
        procs = [ctx.Process(target=_rank, args=(r, world, store, inboxes[r], queue))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        results: Dict[int, object] = {}
        deadline = time.monotonic() + TIMEOUT_S
        try:
            # after every rank has started: each reads its message and opens
            # the shared tensors on its own, in parallel with the others (a
            # thread writes them, so a rank that never reads meets the deadline)
            threading.Thread(target=lambda: [ib.put(payload) for ib in inboxes],
                             daemon=True).start()
            while len(results) < world:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"expert-parallel ranks: {sorted(results)} of {world} "
                                       f"answered within {TIMEOUT_S} s")
                if not queue.empty():
                    rank, res = queue.get()
                    results[rank] = res
                    if isinstance(res, str):
                        raise RuntimeError(f"expert-parallel rank {rank} failed:\n{res}")
                elif any(p.exitcode not in (None, 0) for p in procs):
                    dead = {i: p.exitcode for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)}
                    raise RuntimeError(f"expert-parallel ranks exited: {dead}")
                else:
                    time.sleep(0.05)
            for proc in procs:
                proc.join(max(1.0, deadline - time.monotonic()))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
    return [results[r] for r in range(world)]
