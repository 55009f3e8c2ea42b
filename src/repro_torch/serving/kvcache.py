"""Block-table paged KV cache for the port's engine (port of
``repro/serving/kvcache.py``): fp or int8 pools, a refcounted page
allocator, the copy-on-write shared-prefix cache, on-demand page growth and
the host swap store of preempted slots.

One preallocated pool per K and V, ``[L, NB·BS + 1, Hkv, dh]`` — the last
row of each layer is the scratch destination for dropped writes (see
:mod:`repro_torch.models.transformer`). A slot's logical position ``p``
lives at physical page ``block_tables[slot, p // bs]``, offset ``p % bs``.
With ``kv_bits=8`` the pools hold uint8 codes and four f32 tables
``k_scale, k_zero, v_scale, v_zero`` ``[L, NB·BS + 1, Hkv]`` hold each
row's affine dequant pair. Allocation order, refcounts, prefix entries,
block tables and slot order match the reference's byte for byte, so the
same admissions give the same tables. The engine installs its span tracer
(:meth:`PagedKVCache.set_tracer`): prefix evictions and copy-on-write page
copies reach the trace and, through the ``cow_copy`` lifecycle event, the
metrics.

Slots grow **on demand** (``reserve_full=False``, the engine's default):
admission reserves pages for the context plus the next megastep's writes
and :meth:`PagedKVCache.grow` appends pages at megastep boundaries. Under
pressure a victim slot's pages move to host memory (:meth:`swap_out` →
:class:`SwappedKV` → :meth:`swap_in`): the device pages free at once and the
bit-exact KV is written back, in place, into the pages of the slot the
request is re-admitted to. The payload is laid out as the reference's,
``[L, n_pages, BS, Hkv, dh]``, so its bytes, size and CRC are the
reference's.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from .faults import SwapFault, checksum_tree
from .trace import NULL_TRACER

__all__ = ["BlockAllocator", "PagedKVCache", "PoolExhausted", "PrefixCache", "PrefixEntry",
           "SwappedKV"]

QUANT_TABLES = ("k_scale", "k_zero", "v_scale", "v_zero")


class PoolExhausted(RuntimeError):
    """Raised when an allocation asks for more pages than are free."""


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` fixed-size pages.

    :meth:`alloc` hands out pages at refcount 1; :meth:`incref` adds a
    holder (a prefix-cache entry, or a slot sharing a cached prefix page);
    :meth:`free` releases one hold, and a page returns to the free list only
    at refcount 0. An allocation returns exactly ``n`` distinct free pages
    or raises :class:`PoolExhausted` leaving state untouched; freeing or
    increfing a page that is not allocated (or freeing one twice in a call)
    raises ``ValueError`` before any count moves."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refcount: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> frozenset:
        """Pages with refcount ≥ 1."""
        return frozenset(self._refcount)

    @property
    def free_pages(self) -> tuple:
        return tuple(self._free)

    def refcount(self, block: int) -> int:
        """Current holders of ``block`` (0 = free)."""
        return self._refcount.get(block, 0)

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise PoolExhausted(
                f"requested {n} blocks, {len(self._free)} free of {self.num_blocks}"
            )
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._refcount[b] = 1
        return blocks

    def incref(self, blocks: List[int]) -> None:
        """Add one hold to each page (duplicates add one each)."""
        for b in blocks:
            if b not in self._refcount:
                raise ValueError(f"incref of unallocated block {b}")
        for b in blocks:
            self._refcount[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Release one hold per page; pages reaching refcount 0 return to
        the free list."""
        if len(set(blocks)) != len(blocks) or not all(b in self._refcount for b in blocks):
            raise ValueError(f"double free / unknown block in {blocks}")
        for b in blocks:
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                del self._refcount[b]
                self._free.append(b)


@dataclasses.dataclass
class SwappedKV:
    """Host-memory backing store of one preempted slot's KV pages.

    Whole pages are saved (the partial tail page included), so
    :meth:`PagedKVCache.swap_in` restores the cache bit for bit; int8 pools
    also save each row's scale/zero pair (``quant``), so codes and their
    dequant parameters travel together. ``checksum`` is the CRC of the
    pristine payload at swap-out; swap-in verifies it."""

    k: torch.Tensor  # [L, n_pages, BS, Hkv, dh] on the host
    v: torch.Tensor
    n_tokens: int  # valid kv entries covered by the saved pages
    quant: Optional[Dict[str, torch.Tensor]] = None  # [L, n_pages, BS, Hkv] × 4
    checksum: Optional[int] = None

    def payload_checksum(self) -> int:
        tree = {"k": self.k, "v": self.v}
        if self.quant is not None:
            tree["quant"] = self.quant
        return checksum_tree(tree)

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def nbytes(self) -> int:
        ts = (self.k, self.v, *(self.quant.values() if self.quant is not None else ()))
        return sum(t.numel() * t.element_size() for t in ts)


def _flip_first_byte(t: torch.Tensor) -> None:
    """In-transit damage: invert the payload's leading byte in place."""
    raw = t.view(-1).view(torch.uint8)
    raw[0] ^= 0xFF


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: the exact token bytes → the pages holding its KV
    (``pages`` covers tokens ``[0, n_tokens)``; each page carries one hold
    of this entry). ``last_logits`` — the prompt's final-token logits, on
    the device — is set on full-prompt entries only, so a full hit skips
    prefill entirely."""

    key: bytes
    pages: List[int]
    n_tokens: int
    last_logits: Optional[torch.Tensor] = None
    hits: int = 0


class PrefixCache:
    """LRU cache of prompt prefixes → physical page runs, layered on the
    block tables (reference ``PrefixCache``).

    A freshly prefilled prompt registers one entry per full-page boundary
    (``prompt[:j·BS]``) plus the full prompt (which may end mid-page and
    carries the final logits). Page-aligned pages are immutable and shared
    by incref; a full-prompt entry's partial tail page is copied for a
    sharer (copy-on-write), since the sharer's decode writes land there.
    Evicting an entry releases one hold per page; pages still held by live
    slots stay until those finish."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self.tracer = NULL_TRACER
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        # page → number of entries holding it (≤ its allocator refcount)
        self.holds: Dict[int, int] = {}

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def pages_held(self) -> frozenset:
        return frozenset(self.holds)

    def snapshot(self) -> List[PrefixEntry]:
        """Entries in LRU order (oldest first), recency untouched."""
        return list(self._entries.values())

    def reclaimable(self, protect: frozenset = frozenset()) -> int:
        """Pages :meth:`evict_for` could free now: a page frees when the
        holds of the entries not touching ``protect`` cover its whole
        refcount."""
        drop: Dict[int, int] = {}
        for ent in self._entries.values():
            if protect and not protect.isdisjoint(ent.pages):
                continue
            for pg in ent.pages:
                drop[pg] = drop.get(pg, 0) + 1
        return sum(1 for pg, d in drop.items() if d == self.allocator.refcount(pg))

    def lookup(self, prompt: np.ndarray) -> Optional[PrefixEntry]:
        """Longest cached prefix of ``prompt``: the full prompt first, then
        page boundaries descending. A hit becomes the most recent entry."""
        prompt = np.ascontiguousarray(prompt, np.int32)
        p, bs = len(prompt), self.block_size
        for n in [p] + [j * bs for j in range(p // bs, 0, -1) if j * bs != p]:
            ent = self._entries.get(prompt[:n].tobytes())
            if ent is not None:
                self._entries.move_to_end(ent.key)
                ent.hits += 1
                return ent
        return None

    def register(self, prompt: np.ndarray, blocks: List[int],
                 last_logits: Optional[torch.Tensor] = None) -> int:
        """Cache every page-boundary prefix of ``prompt`` plus the full
        prompt on the slot's ``blocks``. Existing keys keep their pages (the
        same bytes hold the same KV) and gain the logits if they lacked
        them. Returns the number of new entries."""
        prompt = np.ascontiguousarray(prompt, np.int32)
        p, bs = len(prompt), self.block_size
        bounds = [j * bs for j in range(1, p // bs + 1)]
        if p % bs or not bounds:
            bounds.append(p)  # full-prompt entry ends mid-page
        added = 0
        for n in bounds:
            key = prompt[:n].tobytes()
            logits = last_logits if n == p else None
            ent = self._entries.get(key)
            if ent is not None:
                if logits is not None and ent.last_logits is None:
                    ent.last_logits = logits
                continue
            pages = list(blocks[: -(-n // bs)])
            self.allocator.incref(pages)
            for pg in pages:
                self.holds[pg] = self.holds.get(pg, 0) + 1
            self._entries[key] = PrefixEntry(key=key, pages=pages, n_tokens=n,
                                             last_logits=logits)
            added += 1
        return added

    def _release(self, ent: PrefixEntry) -> None:
        self.allocator.free(ent.pages)
        for pg in ent.pages:
            self.holds[pg] -= 1
            if self.holds[pg] == 0:
                del self.holds[pg]
        del self._entries[ent.key]

    def evict_for(self, n_pages: int, protect: frozenset = frozenset()) -> int:
        """Evict LRU entries (skipping those touching ``protect``) until
        ``n_pages`` pages are free or none is evictable. Returns the number
        evicted."""
        evicted = 0
        while self.allocator.num_free < n_pages:
            victim = next((e for e in self._entries.values()
                           if not protect or protect.isdisjoint(e.pages)), None)
            if victim is None:
                break
            self._release(victim)
            evicted += 1
            self.tracer.instant("prefix_evict", track="pool", cat="kv",
                                tokens=victim.n_tokens, pages=len(victim.pages),
                                free=self.allocator.num_free)
        return evicted

    def clear(self) -> None:
        """Drop every entry, releasing all cache holds."""
        for ent in list(self._entries.values()):
            self._release(ent)

    def check_consistency(self) -> None:
        """Holds mirror the entries; every held page is live with refcount ≥
        its holds; entry page counts match their token counts."""
        recount: Dict[int, int] = {}
        for ent in self._entries.values():
            if len(ent.pages) != -(-ent.n_tokens // self.block_size):
                raise AssertionError(
                    f"prefix entry {ent.n_tokens} tokens / {len(ent.pages)} pages mismatch")
            for pg in ent.pages:
                recount[pg] = recount.get(pg, 0) + 1
        if recount != self.holds:
            raise AssertionError("prefix cache holds out of sync")
        for pg, h in self.holds.items():
            if self.allocator.refcount(pg) < h:
                raise AssertionError(
                    f"page {pg}: allocator refcount {self.allocator.refcount(pg)} "
                    f"< cache holds {h}")


class PagedKVCache:
    """Pool tensors + per-slot block tables for ``max_slots`` sequences.
    The pools (and int8 tables) are updated in place by the model
    functions and by :meth:`swap_in`; everything else is host state.
    ``faults`` is an optional :class:`~.faults.FaultPlan` that
    :meth:`swap_out` and :meth:`swap_in` consult."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int, max_slots: int,
                 max_blocks_per_slot: int, device, dtype=None, kv_bits: Optional[int] = None,
                 prefix_cache: bool = False):
        if kv_bits not in (None, 8):
            raise ValueError(f"kv_bits supports 8 (int8 codes) or None (fp pools), "
                             f"got {kv_bits}")
        dt = dtype or (torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
        shape = (cfg.num_layers, num_blocks * block_size + 1, cfg.num_kv_heads, cfg.head_dim)
        self.kv_bits = kv_bits
        self.quant: Optional[Dict[str, torch.Tensor]] = None
        if kv_bits is not None:
            dt = torch.uint8
            self.quant = {name: torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                          for name in QUANT_TABLES}
        self.k = torch.zeros(shape, dtype=dt, device=device)
        self.v = torch.zeros(shape, dtype=dt, device=device)
        self.block_size = block_size
        self.max_slots = max_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.allocator = BlockAllocator(num_blocks)
        self.prefix = PrefixCache(self.allocator, block_size) if prefix_cache else None
        self.block_tables = np.zeros((max_slots, max_blocks_per_slot), np.int32)
        self.slot_blocks: Dict[int, List[int]] = {}
        self.free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self.cow_copies = 0
        self._tables_device = None
        self.tracer = NULL_TRACER
        self.faults = None

    def set_tracer(self, tracer) -> None:
        self.tracer = tracer
        if self.prefix is not None:
            self.prefix.tracer = tracer

    @property
    def quant_tables(self) -> tuple:
        """``(k_scale, k_zero, v_scale, v_zero)`` of int8 pools, else ``()``."""
        return tuple(self.quant[n] for n in QUANT_TABLES) if self.quant is not None else ()

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the pools and their int8 tables."""
        return sum(t.numel() * t.element_size() for t in (self.k, self.v, *self.quant_tables))

    def blocks_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.block_size)

    def max_slot_tokens(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    def slot_deficit(self, slot: int, total_tokens: int) -> int:
        """Pages a live slot still needs to cover ``total_tokens`` kv
        entries: the engine grows by this before each megastep, so every
        write of the fused decode program lands on an allocated page."""
        return max(0, self.blocks_needed(total_tokens) - len(self.slot_blocks[slot]))

    def shared_prefix_pages(self, entry: Optional[PrefixEntry]) -> int:
        """Directly shared pages of a prefix match: its whole pages. A
        partial tail page is copied for the sharer, so it costs a fresh
        page."""
        return 0 if entry is None else entry.n_tokens // self.block_size

    def available_pages(self, protect: frozenset = frozenset()) -> int:
        """Free pages plus what prefix-cache eviction could free."""
        n = self.allocator.num_free
        if self.prefix is not None:
            n += self.prefix.reclaimable(protect)
        return n

    def can_admit(self, total_tokens: int, headroom: int = 0,
                  prefix_entry: Optional[PrefixEntry] = None) -> bool:
        """``headroom`` pages are spoken for (pending growth of the actives).
        A prefix match shrinks the bill to the fresh pages; evictable cache
        pages count as available, the match's own pages excepted."""
        n = self.blocks_needed(total_tokens)
        fresh = n - self.shared_prefix_pages(prefix_entry)
        protect = frozenset(prefix_entry.pages) if prefix_entry is not None else frozenset()
        return (bool(self.free_slots) and fresh <= self.available_pages(protect) - headroom
                and n <= self.max_blocks_per_slot)

    def _copy_page(self, src: int, dst: int, rid: int = -1) -> None:
        """Copy-on-write page duplication on the device: the K/V rows and,
        on int8 pools, their scale/zero rows move together, so the copy
        dequantizes bit-identically to the original."""
        t0 = self.tracer.now_us()
        bs = self.block_size
        rows_src, rows_dst = slice(src * bs, (src + 1) * bs), slice(dst * bs, (dst + 1) * bs)
        for t in (self.k, self.v, *self.quant_tables):
            t[:, rows_dst] = t[:, rows_src]
        self.cow_copies += 1
        self.tracer.lifecycle("cow_copy", track="pool", rid=rid, src_page=src, dst_page=dst)
        self.tracer.complete("cow_copy_span", track="pool", cat="kv", start_us=t0,
                             args={"src": src, "dst": dst})

    def acquire_slot(self, total_tokens: int, prefix_entry: Optional[PrefixEntry] = None,
                     rid: int = -1) -> int:
        """Reserve a slot + enough pages for ``total_tokens`` kv entries.

        With a ``prefix_entry`` the match's whole pages are shared (incref)
        and only the rest is allocated; a match ending mid-page also copies
        its tail page into the first fresh page (COW). LRU cache entries are
        evicted as needed, never those touching the match's pages."""
        n = self.blocks_needed(total_tokens)
        if n > self.max_blocks_per_slot:
            raise PoolExhausted(
                f"{total_tokens} tokens need {n} blocks > "
                f"max_blocks_per_slot={self.max_blocks_per_slot}"
            )
        if not self.free_slots:
            raise PoolExhausted("no free slots")
        if prefix_entry is None:
            if self.prefix is not None:
                self.prefix.evict_for(n)
            blocks = self.allocator.alloc(n)  # raises before the slot is consumed
        else:
            full = self.shared_prefix_pages(prefix_entry)
            tail = 1 if prefix_entry.n_tokens % self.block_size else 0
            if n - full < tail:
                raise ValueError(f"prefix match of {prefix_entry.n_tokens} tokens cannot "
                                 f"seed a {total_tokens}-token slot")
            self.prefix.evict_for(n - full, frozenset(prefix_entry.pages))
            fresh = self.allocator.alloc(n - full)  # raises first
            shared = list(prefix_entry.pages[:full])
            self.allocator.incref(shared)
            blocks = shared + fresh
            if tail:
                self._copy_page(prefix_entry.pages[full], fresh[0], rid=rid)
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

    # ----------------------------------------------------------- prefix
    def prefix_lookup(self, prompt: np.ndarray) -> Optional[PrefixEntry]:
        """Longest cached prefix of ``prompt`` (None when disabled or missed)."""
        return None if self.prefix is None else self.prefix.lookup(prompt)

    def register_prefix(self, prompt: np.ndarray, slot: int,
                        last_logits: Optional[torch.Tensor] = None) -> int:
        """Cache the freshly prefilled prompt's prefixes from a live slot's
        pages (no-op when the prefix cache is disabled)."""
        if self.prefix is None:
            return 0
        return self.prefix.register(prompt, self.slot_blocks[slot], last_logits)

    def clear_prefix_cache(self) -> None:
        if self.prefix is not None:
            self.prefix.clear()

    # ----------------------------------------------------------- growth
    def grow(self, slot: int, n: int) -> List[int]:
        """Append ``n`` pages to a live slot. LRU prefix entries are evicted
        first when the free list is short; raises :class:`PoolExhausted`,
        the slot untouched, when the pool is still short (the engine
        preempts a victim) or the slot would exceed ``max_blocks_per_slot``."""
        have = len(self.slot_blocks[slot])
        if have + n > self.max_blocks_per_slot:
            raise PoolExhausted(
                f"slot {slot}: growing {have}+{n} blocks exceeds "
                f"max_blocks_per_slot={self.max_blocks_per_slot}"
            )
        if self.prefix is not None:
            self.prefix.evict_for(n)
        blocks = self.allocator.alloc(n)  # raises with state untouched
        if not blocks:
            return blocks
        self.slot_blocks[slot].extend(blocks)
        self.block_tables[slot, have:have + len(blocks)] = blocks
        self._tables_device = None
        self.tracer.instant("page_grow", track="pool", cat="kv", slot=slot, pages=len(blocks),
                            slot_pages=len(self.slot_blocks[slot]),
                            free=self.allocator.num_free)
        return blocks

    # ------------------------------------------------------------- swap
    def _page_rows(self, blocks: List[int]) -> List[slice]:
        bs = self.block_size
        return [slice(b * bs, (b + 1) * bs) for b in blocks]

    def _fire(self, site: str, slot: int, rid: int):
        """The fault plan's spec for ``site`` (or None); a ``fail`` spec
        raises :class:`SwapFault` here, before any state moves."""
        spec = self.faults.fire(site, rid) if self.faults is not None else None
        if spec is not None:
            self.tracer.lifecycle("fault", track="pool", site=site, mode=spec.mode,
                                  rid=int(rid), slot=int(slot))
            if spec.mode == "fail":
                raise SwapFault(f"injected {site.replace('_', '-')} I/O failure (slot {slot})",
                                rid=int(rid) if rid >= 0 else None)
        return spec

    def swap_out(self, slot: int, n_tokens: int, rid: int = -1) -> SwappedKV:
        """Move a victim slot's whole pages to host memory and free the slot
        and its pages. The payload carries the CRC of its pristine bytes; a
        ``swap_out`` ``fail`` fault raises :class:`SwapFault` before any
        state moves, ``corrupt`` damages the host payload after the CRC is
        taken (swap-in's verification then trips). The device→host copy
        waits on the device: the engine calls this at a megastep boundary."""
        spec = self._fire("swap_out", slot, rid)
        rows = self._page_rows(self.slot_blocks[slot])
        t0 = self.tracer.now_us()

        def gather(t: torch.Tensor) -> torch.Tensor:
            return torch.stack([t[:, r] for r in rows], dim=1).cpu()

        swapped = SwappedKV(
            k=gather(self.k), v=gather(self.v), n_tokens=n_tokens,
            quant=({n: gather(t) for n, t in self.quant.items()}
                   if self.quant is not None else None),
        )
        swapped.checksum = swapped.payload_checksum()
        if spec is not None and spec.mode == "corrupt":
            _flip_first_byte(swapped.k)
        self.release_slot(slot)
        self.tracer.complete("kv_swap_out", track="pool", cat="kv", start_us=t0,
                             args={"slot": slot, "pages": swapped.n_pages,
                                   "bytes": swapped.nbytes})
        return swapped

    def swap_in(self, slot: int, swapped: SwappedKV, rid: int = -1) -> int:
        """Write swapped pages back into the first ``n_pages`` pages of a
        freshly acquired slot, in place (the engine holds the pool tensors),
        one page slice at a time: no atomics, legal under deterministic
        algorithms. The CRC is verified before any device state moves; a
        mismatch (real corruption or a ``swap_in`` fault) raises
        :class:`SwapFault` with the slot untouched. Returns the bytes
        uploaded."""
        blocks = self.slot_blocks[slot][:swapped.n_pages]
        if len(blocks) < swapped.n_pages:
            raise ValueError(f"slot {slot} holds {len(self.slot_blocks[slot])} pages, "
                             f"swap-in needs {swapped.n_pages}")
        if self.quant is not None and swapped.quant is None:
            raise ValueError("quantized pool restored from fp swap")
        spec = self._fire("swap_in", slot, rid)
        if spec is not None:  # corrupt: damage the host payload right before the verify
            swapped.k = swapped.k.clone()
            _flip_first_byte(swapped.k)
        if swapped.checksum is not None and swapped.payload_checksum() != swapped.checksum:
            raise SwapFault(f"swap payload failed checksum for slot {slot}",
                            rid=int(rid) if rid >= 0 else None)
        t0 = self.tracer.now_us()
        pairs = [(self.k, swapped.k), (self.v, swapped.v)]
        if self.quant is not None:
            pairs += [(self.quant[n], swapped.quant[n]) for n in QUANT_TABLES]
        for t, payload in pairs:
            payload = payload.to(t.device)
            for i, r in enumerate(self._page_rows(blocks)):
                t[:, r] = payload[:, i]
        self.tracer.complete("kv_swap_in", track="pool", cat="kv", start_us=t0,
                             args={"slot": slot, "pages": swapped.n_pages,
                                   "bytes": swapped.nbytes})
        return swapped.nbytes

    @property
    def utilization(self) -> float:
        """Fraction of pool pages held by live slots or cache entries."""
        return 1.0 - self.allocator.num_free / self.allocator.num_blocks

    def check_consistency(self) -> None:
        """Allocator/table invariants: every allocated page's refcount equals
        its live-slot references plus cache holds, no page is both free and
        referenced, pages are conserved, block tables mirror
        ``slot_blocks``, live slots are not free."""
        slot_refs: Dict[int, int] = {}
        for bl in self.slot_blocks.values():
            for b in bl:
                slot_refs[b] = slot_refs.get(b, 0) + 1
        holds = self.prefix.holds if self.prefix is not None else {}
        referenced = set(slot_refs) | set(holds)
        if referenced != set(self.allocator.allocated):
            raise AssertionError("referenced pages out of sync with allocator")
        free = self.allocator.free_pages
        if len(free) != len(set(free)):
            raise AssertionError("duplicate page in the free list")
        if set(free) & referenced:
            raise AssertionError("page both free and referenced")
        if len(free) + len(referenced) != self.allocator.num_blocks:
            raise AssertionError(f"page conservation violated: {len(free)} free + "
                                 f"{len(referenced)} referenced != {self.allocator.num_blocks}")
        for b in referenced:
            want = slot_refs.get(b, 0) + holds.get(b, 0)
            if self.allocator.refcount(b) != want:
                raise AssertionError(f"page {b}: refcount {self.allocator.refcount(b)} != "
                                     f"{slot_refs.get(b, 0)} slot refs + "
                                     f"{holds.get(b, 0)} cache holds")
        for slot, bl in self.slot_blocks.items():
            if slot in self.free_slots:
                raise AssertionError(f"live slot {slot} also in free_slots")
            if len(bl) != len(set(bl)):
                raise AssertionError(f"slot {slot} lists a page twice")
            if len(bl) > self.max_blocks_per_slot:
                raise AssertionError(f"slot {slot} over max_blocks_per_slot")
            if list(self.block_tables[slot, : len(bl)]) != bl:
                raise AssertionError(f"block table row {slot} != slot_blocks")
        if self.prefix is not None:
            self.prefix.check_consistency()

    def tables_device(self) -> torch.Tensor:
        """Device copy of the block tables, re-uploaded only after an
        admission or release."""
        if self._tables_device is None:
            self._tables_device = torch.as_tensor(self.block_tables, device=self.k.device)
        return self._tables_device
