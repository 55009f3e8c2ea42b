"""Mesh builders (port of ``repro/launch/mesh.py``) over the initialised
``torch.distributed`` default group, one process per rank.

Every rank of the default group calls a builder, in the same order: it
makes the axes' process groups (:func:`~repro_torch.parallel.sharding.build_mesh`).
"""
from __future__ import annotations

import numpy as np

from ..parallel.sharding import Mesh, build_mesh

__all__ = ["make_production_mesh", "make_test_mesh"]

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
