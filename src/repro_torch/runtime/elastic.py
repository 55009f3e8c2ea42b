"""Elastic scaling: rebuild the mesh at a smaller data extent and reshard
(port of ``repro/runtime/elastic.py``).

On node loss the job is re-provisioned as a smaller clean rectangle:

1. :func:`shrink_mesh` builds the new mesh (model extent kept — the EP
   layout never changes, only the DP width);
2. the checkpoint restores with the new shardings
   (``Checkpointer.restore(..., shardings=...)``: each rank reads its
   slices);
3. the global batch is kept by raising gradient accumulation
   (:func:`accum_for`).
"""
from __future__ import annotations

import numpy as np

from ..parallel.sharding import Mesh, build_mesh, shard_tree

__all__ = ["accum_for", "reshard_tree", "shrink_mesh"]


def shrink_mesh(mesh: Mesh, new_data: int) -> Mesh:
    """The same axis names with a smaller ``data`` extent, over the first
    ranks of ``mesh`` in its order. Collective: every rank of the default
    group calls it; a rank the new mesh leaves out gets ``coord`` None."""
    sizes = dict(mesh.shape)
    assert "data" in sizes, mesh.axis_names
    assert new_data <= sizes["data"]
    sizes["data"] = new_data
    shape = [sizes[n] for n in mesh.axis_names]
    ranks = mesh.ranks.reshape(-1)[:int(np.prod(shape))]
    return build_mesh(mesh.axis_names, shape, blocks=[ranks])


def accum_for(global_batch: int, per_step_batch: int) -> int:
    """Gradient-accumulation factor preserving the global batch."""
    assert global_batch % per_step_batch == 0
    return global_batch // per_step_batch


def reshard_tree(tree, shardings):
    """This rank's slices of a tree of whole tensors under ``shardings`` (a
    matching tree of :class:`~repro_torch.parallel.sharding.NamedSharding`):
    the reference's ``device_put`` of each leaf."""
    return shard_tree(tree, shardings)
