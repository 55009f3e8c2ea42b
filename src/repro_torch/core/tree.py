"""Walks over the port's parameter trees (nested dicts and lists of tensors,
:class:`PackedTensor` and :class:`CompressedExperts` leaves)."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from .compressed_moe import CompressedExperts
from .packing import PackedTensor

__all__ = ["map_dict", "to_device", "tree_paths", "weight_bytes"]


def map_dict(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """``fn`` over the leaves of nested dicts of one structure (``jax.tree.map``
    over dict trees): ``fn(leaf, *leaves of rest at the same path)``."""
    if isinstance(tree, dict):
        return {k: map_dict(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_paths(tree: Dict, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], object]]:
    """``(path, leaf)`` pairs of a nested-dict tree in sorted key order (the
    reference's flatten order for dict trees)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pair for k in sorted(tree) for pair in tree_paths(tree[k], prefix + (k,))]


def to_device(node, device):
    """A copy of the tree with every tensor on ``device``."""
    if isinstance(node, (torch.Tensor, PackedTensor, CompressedExperts)):
        return node.to(device)
    if isinstance(node, dict):
        return {k: to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [to_device(v, device) for v in node]
    return node


def weight_bytes(node) -> int:
    """Bytes of every parameter tensor (packed sizes for quantized leaves)."""
    if isinstance(node, torch.Tensor):
        return node.numel() * node.element_size()
    if isinstance(node, PackedTensor):
        return node.nbytes
    if isinstance(node, CompressedExperts):
        return node.weight_bytes + weight_bytes(node.slot_of_expert)
    if isinstance(node, dict):
        return sum(weight_bytes(v) for v in node.values())
    if isinstance(node, list):
        return sum(weight_bytes(v) for v in node)
    return 0
