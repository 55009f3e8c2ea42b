"""Block-table paged KV cache for the port's engine (port of the fp-pool part
of ``repro/serving/kvcache.py``; no prefix cache, no swap).

One preallocated pool per K and V, ``[L, NB·BS + 1, Hkv, dh]`` — the last
row of each layer is the scratch destination for dropped writes (see
:mod:`repro_torch.models.transformer`). A slot's logical position ``p``
lives at physical page ``block_tables[slot, p // bs]``, offset ``p % bs``.
Allocation order, block tables and slot order match the reference's byte
for byte, so the same admissions give the same tables.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["BlockAllocator", "PagedKVCache", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    """Raised when an allocation asks for more pages than are free."""


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size pages. An
    allocation returns exactly ``n`` distinct free pages or raises
    :class:`PoolExhausted` leaving state untouched; freeing a page that is
    not allocated (or twice in one call) raises ``ValueError``."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._allocated: set = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise PoolExhausted(
                f"requested {n} blocks, {len(self._free)} free of {self.num_blocks}"
            )
        blocks = [self._free.pop() for _ in range(n)]
        self._allocated.update(blocks)
        return blocks

    def free(self, blocks: List[int]) -> None:
        if len(set(blocks)) != len(blocks) or not self._allocated.issuperset(blocks):
            raise ValueError(f"double free / unknown block in {blocks}")
        self._allocated.difference_update(blocks)
        self._free.extend(blocks)


class PagedKVCache:
    """Pool tensors + per-slot block tables for ``max_slots`` sequences.
    The pools are updated in place by the model functions; everything else
    is host state."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int, max_slots: int,
                 max_blocks_per_slot: int, device, dtype=None):
        dt = dtype or (torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
        shape = (cfg.num_layers, num_blocks * block_size + 1, cfg.num_kv_heads, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dt, device=device)
        self.v = torch.zeros(shape, dtype=dt, device=device)
        self.block_size = block_size
        self.max_slots = max_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.allocator = BlockAllocator(num_blocks)
        self.block_tables = np.zeros((max_slots, max_blocks_per_slot), np.int32)
        self.slot_blocks: Dict[int, List[int]] = {}
        self.free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._tables_device = None

    def blocks_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.block_size)

    def max_slot_tokens(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    def can_admit(self, total_tokens: int) -> bool:
        n = self.blocks_needed(total_tokens)
        return (bool(self.free_slots) and n <= self.allocator.num_free
                and n <= self.max_blocks_per_slot)

    def acquire_slot(self, total_tokens: int) -> int:
        """Reserve a slot + enough pages for ``total_tokens`` kv entries."""
        n = self.blocks_needed(total_tokens)
        if n > self.max_blocks_per_slot:
            raise PoolExhausted(
                f"{total_tokens} tokens need {n} blocks > "
                f"max_blocks_per_slot={self.max_blocks_per_slot}"
            )
        if not self.free_slots:
            raise PoolExhausted("no free slots")
        blocks = self.allocator.alloc(n)  # raises before the slot is consumed
        slot = self.free_slots.pop()
        self.slot_blocks[slot] = blocks
        self.block_tables[slot] = 0
        self.block_tables[slot, : len(blocks)] = blocks
        self._tables_device = None
        return slot

    def release_slot(self, slot: int) -> None:
        self.allocator.free(self.slot_blocks.pop(slot))
        self.block_tables[slot] = 0
        self.free_slots.append(slot)
        self._tables_device = None

    @property
    def utilization(self) -> float:
        """Fraction of pool pages held by live slots."""
        return 1.0 - self.allocator.num_free / self.allocator.num_blocks

    def tables_device(self) -> torch.Tensor:
        """Device copy of the block tables, re-uploaded only after an
        admission or release."""
        if self._tables_device is None:
            self._tables_device = torch.as_tensor(self.block_tables, device=self.k.device)
        return self._tables_device
