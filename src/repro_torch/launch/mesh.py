"""Mesh builders (port of ``repro/launch/mesh.py``) over the initialised
``torch.distributed`` default group, one process per rank.

Every rank of the default group calls a builder, in the same order: it
makes the axes' process groups (:func:`~repro_torch.parallel.sharding.build_mesh`).
:func:`spawn_ranks` starts such a group on one machine (gloo, spawned
processes), as the card's multi-rank drivers (``ep_ranks``, ``step_ranks``)
run it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..parallel.sharding import Mesh, build_mesh

__all__ = ["load_rank_kernels", "make_production_mesh", "make_test_mesh", "production_view",
           "spawn_ranks"]

#: the reference's pod meshes: 16 × 16 chips, or 2 pods of them
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: ``data × model`` = 16 × 16 (256
    ranks), or ``pod × data × model`` = 2 × 16 × 16 (512 ranks). Axes:
    ``pod`` (between hosts), ``data`` (DP), ``model`` (EP). The world size
    must be the mesh's."""
    import torch.distributed as dist

    shape, names = PRODUCTION_SHAPES[multi_pod]
    need = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != need:
        raise ValueError(f"make_production_mesh(multi_pod={multi_pod}) is {shape} = {need} "
                         f"ranks; the initialised world has {world}")
    return build_mesh(names, shape)


def production_view(multi_pod: bool = False, coord=None) -> Mesh:
    """One rank's view of the production mesh without processes: its shape
    (``16 × 16``, or ``2 × 16 × 16`` with ``pod``) and the coordinate
    ``coord`` (default rank 0's), with no process groups. The step builders
    and :func:`~repro_torch.parallel.sharding.shard_tensor` read its blocks;
    a collective on it runs only under
    :func:`~repro_torch.parallel.sharding.counting`, which records it."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return Mesh(names, shape, coord=tuple(coord) if coord is not None else (0,) * len(shape))


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """A small ``data × model`` (or ``pod × data × model``) mesh. A world
    larger than the mesh is cut into consecutive replicas of it, each rank
    in the replica that holds it (the world size must be a multiple)."""
    import torch.distributed as dist

    shape, names = ((pod, data, model), ("pod", "data", "model")) if pod else \
        ((data, model), ("data", "model"))
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world % n:
        raise ValueError(f"a {shape} mesh does not tile a world of {world} ranks")
    return build_mesh(names, shape, blocks=[np.arange(i, i + n) for i in range(0, world, n)])


#: host threads of each spawned rank (the ranks share the host's cores)
RANK_THREADS = 2
#: the spawned ranks' deadline, from their start to their results
RANK_TIMEOUT_S = 300.0


def _spawned(cases, rank: int, world: int, store: str, inbox, queue) -> None:
    import traceback

    import torch.distributed as dist

    try:
        payload = inbox.get()  # the shared tensors, opened here by every rank at once
        torch.set_num_threads(RANK_THREADS)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            out = cases(rank, world, payload)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails
        queue.put((rank, traceback.format_exc()))


def load_rank_kernels(rank: int, device) -> None:
    """On the card, load the kernels' library, which must have been built
    before the ranks started: a rank loads it and never builds it."""
    from ..kernels import build

    if device.type != "cuda":
        return
    if not build.library_path().exists():
        raise RuntimeError(f"rank {rank}: {build.library_path()} is not built; ranks load "
                           f"the kernels, they never build them")
    build.load_library()


def spawn_ranks(cases, payload, *, world: int, name: str) -> List:
    """Run ``cases(rank, world, payload)`` in ``world`` spawned processes
    joined over gloo (a file store; :data:`RANK_THREADS` host threads each)
    and return their results, by rank. ``cases`` is a module-level function;
    ``payload`` reaches every rank through a queue of its own once all have
    started, so its shared tensors (CUDA IPC on the card, shared memory on
    the CPU) are opened by the ranks at once rather than one after another.
    Fails, naming ``name``, if a rank fails or the ranks do not finish
    within :data:`RANK_TIMEOUT_S`; every rank process is ended before it
    returns."""
    import os
    import tempfile
    import threading
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        inboxes = [ctx.SimpleQueue() for _ in range(world)]
        procs = [ctx.Process(target=_spawned, args=(cases, r, world, store, inboxes[r], queue))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        results: Dict[int, object] = {}
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            # a thread writes the payloads, so a rank that never reads meets the deadline
            threading.Thread(target=lambda: [ib.put(payload) for ib in inboxes],
                             daemon=True).start()
            while len(results) < world:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{name} ranks: {sorted(results)} of {world} answered "
                                       f"within {RANK_TIMEOUT_S} s")
                if not queue.empty():
                    rank, res = queue.get()
                    results[rank] = res
                    if isinstance(res, str):
                        raise RuntimeError(f"{name} rank {rank} failed:\n{res}")
                elif any(p.exitcode not in (None, 0) for p in procs):
                    dead = {i: p.exitcode for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)}
                    raise RuntimeError(f"{name} ranks exited: {dead}")
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
