"""Walks over the port's parameter trees (nested dicts and lists of tensors,
:class:`PackedTensor` and :class:`CompressedExperts` leaves)."""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from .compressed_moe import CompressedExperts
from .packing import PackedTensor

__all__ = ["to_device", "tree_leaves", "tree_map", "tree_paths", "tree_unflatten",
           "weight_bytes"]


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of nested dicts and lists of one structure
    (``jax.tree.map`` over the port's trees): ``fn(leaf, *leaves of rest at
    the same path)``. A node for which ``is_leaf`` is true is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists, in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, object]]:
    """``(path, leaf)`` pairs in the reference's flatten order: dict keys
    sorted, list and tuple items by index, a NamedTuple's fields as
    ``".name"``."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{n}", getattr(tree, n)) for n in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    return [pair for k, v in items for pair in tree_paths(v, prefix + (k,))]


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
