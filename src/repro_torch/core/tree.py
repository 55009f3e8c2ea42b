"""Walks over the port's parameter trees (nested dicts and lists of tensors,
:class:`PackedTensor` and :class:`CompressedExperts` leaves)."""
from __future__ import annotations



import torch

from .compressed_moe import CompressedExperts
from .packing import PackedTensor

__all__ = ["to_device", "weight_bytes"]


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
