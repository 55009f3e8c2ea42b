"""Host-offloaded PMQ expert buckets with router-stats prefetch (port of
``repro/serving/offload.py``).

PMQ's bit buckets shrink expert storage; this module shrinks expert device
residency: a device that holds only the hot slice of each bit bucket (plus
the paged KV pool) serves a model whose full expert set it need not hold.
Cold rows live in a host backing store and cross the host↔device boundary
as whole packed rows (codes plus scale/zero), a fraction of the bf16 bytes.

Residency is managed per ``(layer, bucket, expert slot)``:

* **Device**: per bucket, one ``[L, R_i, ...]`` tensor per packed leaf and
  an ``[L, count_i]`` int32 map from bucket slot to resident row. Each
  layer's :class:`CompressedExperts` (``params["layers"][l]["moe_ce"]``)
  holds views ``[l]`` of them, so an upload written in place into the
  ``[L, R_i, ...]`` tensor is what every layer reads. Non-resident slots
  map to row 0.
* **Host**: numpy ``[L, count_i, ...]`` copies of every bucket leaf — the
  reference's layout, so upload bytes, row CRCs and the spill format are
  the reference's.
* **Prefetch**: an EMA over the per-(layer, slot) dispatch counts every
  program reports picks the top-``R_i`` slots per bucket; the controller
  plans their uploads at megastep boundaries (``upload_experts``).
* **Miss**: routing happens inside the program, so its working set is known
  only after it ran. The engine replays the program after a synchronous
  upload of the missing rows (:meth:`ensure_resident`) until a run finds
  its whole working set resident; only usage up to the first row with a
  miss is trusted, and the slots seen are pinned until the run is
  accepted, so the loop accepts within ``rows`` replays.
* **Overflow**: a step whose working set exceeds a bucket's budget grows
  that bucket's buffers (``grows`` counts it) instead of serving wrong
  tokens.
* **Async overlap** (:meth:`issue_async` / :meth:`commit_async`): the
  controller's prefetch is staged right after a program's dispatch —
  placement on copies of the tables, the rows gathered into pinned host
  memory and copied to device staging buffers on a side CUDA stream, with
  an event recorded — without touching the live buffers the running program
  reads. The next boundary either drops the batch (a miss upload or a grow
  changed a bucket since the issue) or makes the compute stream wait on the
  event and scatters the staged rows into the live buffers in place; stream
  order puts the scatter after the program that was running and before the
  next. On the CPU issue and commit run synchronously: the same tables and
  outputs.
* **Tiers** (:mod:`.tierstore`): with ``offload_dir`` the backing store
  becomes disk → host row cache → device.
* **Faults** (:mod:`.faults`): with a :class:`FaultPlan` every upload runs
  the recovery ladder — each payload is CRC-checked against the host row's
  checksum and re-fetched on mismatch; I/O failures retry (at once and
  bounded on the miss path, with logical-step backoff on the prefetch
  path); a row whose upload keeps failing is **degraded** to the next lower
  rung of the PMQ precision ladder (:func:`degrade_expert_row`, a
  ``degrade`` lifecycle event), or the manager fails closed with
  :class:`ExpertUploadFailed` when degradation is off or impossible.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.compressed_moe import CompressedExperts
from ..core.packing import pack_bits, unpack_bits
from ..core.tree import tree_map, tree_paths
from .faults import ExpertUploadFailed, FaultPlan, checksum_tree, corrupt_tree
from .tierstore import TieredExpertStore

__all__ = ["ExpertOffloadManager", "degrade_expert_row"]


def degrade_expert_row(row: Dict, bits: int, to_bits: int) -> Dict:
    """Snap one packed expert row's codes onto the ``2^to_bits`` grid,
    re-encoded in the same ``bits``-wide container (shapes unchanged, so the
    payload drops into the resident buffer like any other upload); scale and
    zero are kept. ``row`` is the ``{w_gate/w_up/w_down: {data | hi+lo,
    scale, zero}}`` numpy tree of one ``(layer, slot)`` row, packed along
    axis 0."""
    if not 1 <= to_bits < bits:
        raise ValueError(f"cannot degrade {bits}-bit codes to {to_bits}")
    maxq = (1 << bits) - 1
    maxt = (1 << to_bits) - 1

    def snap(q) -> np.ndarray:
        q = np.asarray(q, np.float64)
        q2 = np.rint(q * maxt / maxq)
        return np.rint(q2 * maxq / maxt).astype(np.uint8)

    def t(a):
        return torch.from_numpy(np.array(a))

    out: Dict = {}
    for wname, parts in row.items():
        new = dict(parts)
        if bits == 3:
            q = unpack_bits((t(parts["hi"]), t(parts["lo"])), 3, axis=0).numpy()
            hi, lo = pack_bits(t(snap(q)), 3, axis=0)
            new["hi"], new["lo"] = hi.numpy(), lo.numpy()
        elif bits == 8:
            new["data"] = snap(parts["data"])
        else:
            q = unpack_bits(t(parts["data"]), bits, axis=0).numpy()
            new["data"] = pack_bits(t(snap(q)), bits, axis=0).numpy()
        out[wname] = new
    return out


class ExpertOffloadManager:
    """Residency manager for one model's PMQ buckets.

    ``ces`` holds one :class:`CompressedExperts` per layer, all with the same
    buckets (the serving layout is layer-uniform). ``resident_slots`` is the
    per-layer device budget in expert slots, split across buckets in
    proportion to their counts (every bucket keeps ≥ 1 row); the resident
    partitions live on ``device`` (default: where ``ces`` are). The manager
    owns :attr:`ces`: new per-layer :class:`CompressedExperts` whose arrays
    are views of the resident partitions, which the caller splices into its
    parameter tree in place of the all-resident ones.
    """

    def __init__(self, ces: Sequence[CompressedExperts], *, resident_slots: int,
                 ema_decay: float = 0.8, tracer=None, faults: Optional[FaultPlan] = None,
                 degrade: bool = False, max_retries: int = 3,
                 offload_dir: Optional[str] = None, host_budget_bytes: Optional[int] = None,
                 device=None):
        if isinstance(ces, CompressedExperts) or not len(ces):
            raise ValueError("expert offload expects one CompressedExperts per layer")
        if any(ce.resident_map is not None for ce in ces):
            raise ValueError("CompressedExperts is already host-offloaded")
        if any(ce.meta != ces[0].meta for ce in ces):
            raise ValueError("expert offload expects the same buckets in every layer")
        if tracer is None:
            from .trace import NULL_TRACER

            tracer = NULL_TRACER
        self.tracer = tracer
        # the fault plane: with a plan attached every upload is checksum-
        # verified and runs the retry → re-fetch → degrade → fail-closed ladder
        self.faults = faults
        self.degrade_enabled = bool(degrade)
        self.max_retries = int(max_retries)
        self._host_crc: Dict[Tuple[str, int, int], int] = {}
        self._degraded_rows: Dict[Tuple[str, int, int], Dict] = {}
        # (layer, global slot) -> (from_bits, to_bits), for the engine's lifetime
        self.degraded: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._attempts: Dict[Tuple[str, int, int], int] = {}
        # prefetch backoff: key -> logical step before which no re-attempt
        self._retry_after: Dict[Tuple[str, int, int], int] = {}
        ce0 = ces[0]
        self.meta = ce0.meta
        self.num_slots = ce0.num_slots
        self.num_layers = len(ces)
        self.device = torch.device(device) if device is not None else ce0.slot_of_expert.device
        self.ema_decay = float(ema_decay)
        self._bkeys = [f"b{i}" for i in range(len(ce0.meta))]
        # the full host backing store, [L, count, ...] numpy per leaf
        self.host: Optional[Dict[str, Dict]] = {
            bk: tree_map(lambda *ls: torch.stack([t.detach() for t in ls]).cpu().numpy(),
                         *(ce.arrays[bk] for ce in ces))
            for bk in self._bkeys
        }
        self._budgets = self._split_budget(int(resident_slots))
        # residency tables on the host: slot -> row (-1 absent), row -> slot
        self.slot_row: Dict[str, np.ndarray] = {}
        self.row_slot: Dict[str, np.ndarray] = {}
        self.ema = np.zeros((self.num_layers, self.num_slots), np.float64)
        # upload counts and bytes go back to the caller per call (the metrics
        # aggregate them); the manager counts only budget growths
        self.grows = 0
        self._pinned: List[Dict[str, set]] = []
        # the one staged async batch in flight, checked at commit against
        # these per-bucket content versions: a miss upload or a grow between
        # issue and commit bumps the bucket's version and drops the batch
        self._bucket_version: Dict[str, int] = {}
        self._inflight: Optional[Dict] = None
        self._side_stream = None
        self.begin_step()
        # the resident partitions, [L, R_i, ...] per leaf, and the maps
        self.arrays: Dict[str, Dict] = {}
        self.maps: Dict[str, torch.Tensor] = {}
        for i, bk in enumerate(self._bkeys):
            r, cnt = self._budgets[i], self.meta[i].count
            # seed residency with each bucket's first r slots; the EMA
            # prefetcher re-ranks them after the first traffic
            sr = np.full((self.num_layers, cnt), -1, np.int32)
            sr[:, :r] = np.arange(r, dtype=np.int32)[None, :]
            self.slot_row[bk] = sr
            self.row_slot[bk] = np.tile(np.arange(r, dtype=np.int32), (self.num_layers, 1))
            self.arrays[bk] = tree_map(
                lambda a: torch.from_numpy(np.ascontiguousarray(a[:, :r])).to(self.device),
                self.host[bk])
            self.maps[bk] = torch.from_numpy(np.maximum(sr, 0)).to(self.device)
            self._bucket_version[bk] = 0
        self.ces = [dataclasses.replace(ce) for ce in ces]
        self._repoint()
        # three tiers: spill the packed buckets to mmap'd disk images and drop
        # the full host copies; cold rows then come disk → host cache → device
        self.store: Optional[TieredExpertStore] = None
        if offload_dir is not None:
            self.store = TieredExpertStore(self.host, offload_dir=offload_dir,
                                           host_budget_bytes=host_budget_bytes, tracer=tracer)
            self.host = None

    def _repoint(self) -> None:
        """Point every layer's :class:`CompressedExperts` at its ``[l]`` views
        of the resident partitions and maps (after construction and grows)."""
        for l, ce in enumerate(self.ces):
            ce.arrays = {bk: tree_map(lambda a: a[l], self.arrays[bk]) for bk in self._bkeys}
            ce.resident_map = {bk: self.maps[bk][l] for bk in self._bkeys}

    # ---------------------------------------------------------- budgeting
    def _split_budget(self, resident_slots: int) -> List[int]:
        counts = [m.count for m in self.meta]
        nb = len(counts)
        total = min(self.num_slots, max(nb, resident_slots))
        if total != resident_slots:
            warnings.warn(
                f"resident_slots={resident_slots} clamped to {total} (floor: one row per "
                f"bucket = {nb}; ceiling: num_slots = {self.num_slots})",
                RuntimeWarning, stacklevel=3)
        r = [max(1, min(c, int(round(resident_slots * c / self.num_slots)))) for c in counts]
        while sum(r) > total:
            i = max(range(nb), key=lambda j: r[j])
            if r[i] <= 1:
                break
            r[i] -= 1
        while sum(r) < total:
            cands = [j for j in range(nb) if r[j] < counts[j]]
            if not cands:
                break
            i = max(cands, key=lambda j: counts[j] - r[j])
            r[i] += 1
        return r

    @property
    def budgets(self) -> Tuple[int, ...]:
        return tuple(self._budgets)

    @property
    def resident_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for bk in self._bkeys for _, a in tree_paths(self.arrays[bk]))

    @property
    def host_bytes(self) -> int:
        """Bytes of the full backing store: the host copies, or the mmap'd
        disk images when tiered (the host then holds only the row cache)."""
        if self.store is not None:
            return self.store.disk_bytes
        return sum(a.nbytes for bk in self._bkeys for _, a in tree_paths(self.host[bk]))

    def resident_slots_of(self, layer: int) -> Dict[str, set]:
        """Bucket-local resident slot sets of one layer."""
        return {bk: {int(s) for s in np.nonzero(self.slot_row[bk][layer] >= 0)[0]}
                for bk in self._bkeys}

    # ----------------------------------------------------------- plumbing
    def _row_tree(self, bk: str, layer: int, slot: int) -> Dict:
        """The pristine host payload of one ``(layer, bucket-local slot)``
        row: numpy views of the backing store, or, tiered, the row fetched
        through the disk → host-cache ladder at its routing heat."""
        if self.store is not None:
            gslot = self.meta[self._bkeys.index(bk)].start + int(slot)
            return self.store.row(bk, layer, slot, heat=float(self.ema[int(layer), gslot]))
        return tree_map(lambda a: a[layer, slot], self.host[bk])

    def _row_crc(self, bk: str, layer: int, slot: int) -> int:
        """Checksum of the pristine host row (cached), which every staged
        payload is verified against; a tiered store carries its manifest's."""
        if self.store is not None:
            return self.store.crc(bk, layer, slot)
        key = (bk, int(layer), int(slot))
        crc = self._host_crc.get(key)
        if crc is None:
            crc = checksum_tree(self._row_tree(bk, layer, slot))
            self._host_crc[key] = crc
        return crc

    def _degrade_target_bits(self, i: int) -> Optional[int]:
        """The next lower rung below bucket ``i``'s width: the largest smaller
        bucket width, else half the width; None at the 1-bit floor."""
        bits = self.meta[i].bits
        lower = [m.bits for m in self.meta if m.bits < bits]
        if lower:
            return max(lower)
        return bits // 2 if bits // 2 >= 1 else None

    def _degrade_or_raise(self, i: int, layer: int, slot: int) -> Dict:
        """A row's upload failed past the retry budget: build (and keep) its
        degraded payload, or fail closed with :class:`ExpertUploadFailed`."""
        bk = self._bkeys[i]
        m = self.meta[i]
        gslot = int(m.start + slot)
        to_bits = self._degrade_target_bits(i) if self.degrade_enabled else None
        if to_bits is None:
            raise ExpertUploadFailed(
                f"expert row (layer {layer}, slot {gslot}) upload failed past "
                f"{self.max_retries} retries and degradation is "
                + ("impossible at the 1-bit floor" if self.degrade_enabled else "disabled"))
        key = (bk, int(layer), int(slot))
        if key not in self._degraded_rows:
            self._degraded_rows[key] = degrade_expert_row(
                self._row_tree(bk, layer, slot), m.bits, to_bits)
            self.degraded[(int(layer), gslot)] = (int(m.bits), int(to_bits))
        return self._degraded_rows[key]

    def _clear_for_upload(self, i: int, layer: int, slots, kind: str):
        """Run the recovery ladder over bucket-local ``slots`` of one layer
        before placement. Returns ``(cleared, payloads)``; ``payloads`` is
        None on the fault-free two-tier path (the caller gathers from the
        backing store), else one verified host row per cleared slot. On the
        ``miss`` path every slot is cleared (bounded retries, then degrade or
        raise); on the ``prefetch`` path a failing slot is deferred with
        logical-step backoff and left out of this boundary's placement."""
        bk = self._bkeys[i]
        m = self.meta[i]
        if self.faults is None and not self._degraded_rows and self.store is None:
            return list(slots), None
        cleared: List[int] = []
        payloads: List[Dict] = []
        for s in slots:
            s = int(s)
            key = (bk, int(layer), s)
            gslot = int(m.start + s)
            degraded = self._degraded_rows.get(key)
            if degraded is not None:
                # permanently degraded: the lower-bit copy is a different
                # payload from the one the fault models, so no injection
                fb, tb = self.degraded[(int(layer), gslot)]
                self.tracer.lifecycle("degrade", track="experts", layer=int(layer),
                                      slot=gslot, from_bits=fb, to_bits=tb)
                cleared.append(s)
                payloads.append(degraded)
                continue
            if self.faults is None:
                cleared.append(s)
                payloads.append(self._row_tree(bk, layer, s))
                continue
            if kind == "prefetch" and key in self._retry_after:
                if self.faults.step < self._retry_after[key]:
                    continue  # still backing off
                del self._retry_after[key]
                self.tracer.lifecycle("retry", track="experts", path="prefetch",
                                      layer=int(layer), slot=gslot,
                                      attempt=int(self._attempts.get(key, 0)))
            attempts = int(self._attempts.get(key, 0))
            while True:
                spec = self.faults.fire("upload", (int(layer), gslot))
                if spec is not None:
                    self.tracer.lifecycle("fault", track="experts", site="upload",
                                          mode=spec.mode, layer=int(layer), slot=gslot,
                                          path=kind)
                if spec is None or spec.mode == "corrupt":
                    row = self._row_tree(bk, layer, s)
                    if spec is not None:
                        row = corrupt_tree(row)
                    if checksum_tree(row) != self._row_crc(bk, layer, s):
                        # the integrity check caught it: re-fetch the pristine row
                        self.tracer.lifecycle("retry", track="experts", path="refetch",
                                              layer=int(layer), slot=gslot,
                                              attempt=attempts + 1)
                        row = self._row_tree(bk, layer, s)
                    cleared.append(s)
                    payloads.append(row)
                    self._attempts.pop(key, None)
                    break
                # mode == "fail": an I/O failure
                attempts += 1
                self._attempts[key] = attempts
                if attempts > self.max_retries:
                    row = self._degrade_or_raise(i, layer, s)
                    fb, tb = self.degraded[(int(layer), gslot)]
                    self.tracer.lifecycle("degrade", track="experts", layer=int(layer),
                                          slot=gslot, from_bits=fb, to_bits=tb)
                    cleared.append(s)
                    payloads.append(row)
                    break
                if kind == "prefetch":
                    # backoff in logical steps, never seconds: replay-identical
                    self._retry_after[key] = self.faults.step + (1 << attempts)
                    break
                self.tracer.lifecycle("retry", track="experts", path="miss", layer=int(layer),
                                      slot=gslot, attempt=attempts)
        return cleared, payloads

    def _gather(self, bk: str, triples, payloads=None, pin: bool = False):
        """The host rows of ``(layer, row, slot)`` placements, one ``[n, ...]``
        tensor per leaf (pinned with ``pin``), from the backing store or from
        ``payloads`` (one verified row tree per placement). Returns ``(rows,
        nbytes)``."""
        if payloads is None:
            per_leaf = tree_map(lambda a: [a[l, s] for l, _, s in triples], self.host[bk])
        else:
            per_leaf = tree_map(lambda *rows: list(rows), *payloads)

        def stack(rows):
            first = np.asarray(rows[0])
            dtype = torch.from_numpy(first[:0].copy()).dtype
            buf = torch.empty((len(rows),) + first.shape, dtype=dtype, pin_memory=pin)
            view = buf.numpy()
            for j, r in enumerate(rows):
                view[j] = r
            return buf

        rows = tree_map(stack, per_leaf, is_leaf=lambda n: isinstance(n, list))
        return rows, sum(a.numel() * a.element_size() for _, a in tree_paths(rows))

    @staticmethod
    def _indices(triples, pin: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The placements' layer and row indices (pinned with ``pin``)."""
        li, ri = (torch.tensor([t[j] for t in triples], dtype=torch.long) for j in (0, 1))
        return (li.pin_memory(), ri.pin_memory()) if pin else (li, ri)

    def _scatter(self, bk: str, li: torch.Tensor, ri: torch.Tensor, rows: Dict) -> None:
        """Write staged rows into bucket ``bk``'s resident partitions in place
        (one ``index_put_`` per leaf, on the current stream)."""
        tree_map(lambda dev, src: dev.index_put_((li, ri), src), self.arrays[bk], rows)

    def _upload_batch(self, bk: str, triples, payloads=None) -> int:
        """Synchronous host→device upload of placements into the live
        buffers; bumps the bucket's version (an async batch staged before it
        lacks these rows). Returns the bytes copied."""
        if not triples:
            return 0
        rows, nbytes = self._gather(bk, triples, payloads)
        li, ri = self._indices(triples)
        dev = self.device
        self._scatter(bk, li.to(dev), ri.to(dev), tree_map(lambda a: a.to(dev), rows))
        self._bucket_version[bk] += 1
        return nbytes

    def _refresh_map(self, bk: str) -> None:
        self.maps[bk].copy_(torch.from_numpy(np.maximum(self.slot_row[bk], 0).astype(np.int32)))

    def _grow(self, i: int, need: int) -> None:
        """Enlarge bucket ``i``'s resident partitions to ``need`` rows (every
        layer) and re-point the layers' views. Taken only when a step's
        working set cannot fit the budget: correctness beats the budget."""
        bk = self._bkeys[i]
        old = self._budgets[i]
        new_r = min(self.meta[i].count, int(need))
        if new_r <= old:
            return
        pad = new_r - old
        self.row_slot[bk] = np.concatenate(
            [self.row_slot[bk], np.full((self.num_layers, pad), -1, np.int32)], axis=1)
        self.arrays[bk] = tree_map(
            lambda a: torch.cat([a, a.new_zeros((a.shape[0], pad) + tuple(a.shape[2:]))], dim=1),
            self.arrays[bk])
        self._budgets[i] = new_r
        self._bucket_version[bk] += 1  # a staged async batch is now stale
        self.grows += 1
        self._repoint()
        self.tracer.instant("expert_budget_grow", track="experts", cat="offload", bucket=i,
                            rows_before=old, rows_after=new_r)

    def _place(self, i: int, layer: int, want, protected, score_fn):
        """Install bucket-local slots ``want`` into bucket ``i``'s rows of one
        layer: free rows first, then the lowest-``score_fn`` rows whose slot
        is not ``protected``. Updates the host tables; returns the ``(layer,
        row, slot)`` placements for the caller to upload."""
        bk = self._bkeys[i]
        sr = self.slot_row[bk]
        rows = self.row_slot[bk]
        r_i = self._budgets[i]
        free = [j for j in range(r_i) if rows[layer, j] < 0]
        evictable = sorted(
            (j for j in range(r_i) if rows[layer, j] >= 0 and int(rows[layer, j]) not in protected),
            key=lambda j: (score_fn(int(rows[layer, j])), int(rows[layer, j])))
        targets = (free + evictable)[:len(want)]
        placed = []
        for s, j in zip(want, targets):
            old = int(rows[layer, j])
            if old >= 0:
                sr[layer, old] = -1
            rows[layer, j] = s
            sr[layer, s] = j
            placed.append((layer, j, s))
        return placed

    # ------------------------------------------------------ step protocol
    def begin_step(self) -> None:
        """Reset the pin sets; the engine calls this before each program's
        replay loop."""
        self._pinned = [{bk: set() for bk in self._bkeys} for _ in range(self.num_layers)]

    def ensure_resident(self, counts: np.ndarray) -> Tuple[int, int]:
        """Make the last run's authentic working set resident.

        ``counts`` are the run's dispatch counts in computation order:
        ``[L, num_slots]`` for a prefill chunk, ``[H, L, num_slots]`` (row
        ``k`` of the flattened rows is layer ``k % L`` of step ``k // L``)
        for a decode megastep. Returns ``(uploads, bytes)``; ``uploads == 0``
        accepts the run (its outputs are the all-resident engine's), else the
        caller replays the whole program after this synchronous upload. Usage
        is trusted up to the first row with a miss (later rows routed on
        garbage activations); every slot seen stays pinned until the run is
        accepted, and only unpinned rows are evicted, coldest EMA first.
        """
        rows = counts.reshape(-1, self.num_slots)
        resident = np.concatenate([self.slot_row[bk] >= 0 for bk in self._bkeys], axis=1)
        layer_of = np.arange(rows.shape[0]) % self.num_layers
        if not np.any((rows > 0) & ~resident[layer_of]):
            return 0, 0
        t0 = self.tracer.now_us()
        ups = 0
        nbytes = 0
        pending = {bk: [] for bk in self._bkeys}
        pend_rows = {bk: [] for bk in self._bkeys}
        for k in range(rows.shape[0]):
            l = int(layer_of[k])
            row_missed = False
            for i, bk in enumerate(self._bkeys):
                m = self.meta[i]
                used = np.nonzero(rows[k, m.start:m.start + m.count] > 0)[0]
                pin = self._pinned[l][bk]
                pin.update(int(u) for u in used)
                missing = [s for s in sorted(pin) if self.slot_row[bk][l, s] < 0]
                if not missing:
                    continue
                row_missed = True
                if len(pin) > self._budgets[i]:
                    self._grow(i, len(pin))
                missing, rows_pay = self._clear_for_upload(i, l, missing, "miss")
                placed = self._place(i, l, missing, pin,
                                     lambda s, l=l, m=m: self.ema[l, m.start + s])
                assert len(placed) == len(missing), "pin set exceeds budget"
                pending[bk].extend(placed)
                if rows_pay is not None:
                    pend_rows[bk].extend(rows_pay)
                ups += len(placed)
            if row_missed:
                break  # later rows routed on garbage: replay first
        for bk in self._bkeys:  # one batched upload + map per bucket
            if pending[bk]:
                nbytes += self._upload_batch(bk, pending[bk], pend_rows[bk] or None)
                self._refresh_map(bk)
        if ups:
            self.tracer.complete("expert_upload", track="experts", cat="offload", start_us=t0,
                                 args={"kind": "miss", "uploads": ups, "bytes": nbytes})
        return ups, nbytes

    def update_stats(self, counts: np.ndarray) -> None:
        """Fold an accepted run's dispatch counts (``[L, S]``, ``[H·L, S]`` or
        ``[H, L, S]``; horizon steps summed) into the routing EMA."""
        counts = counts.reshape(-1, self.num_layers, self.num_slots).sum(0)
        d = self.ema_decay
        self.ema = d * self.ema + (1.0 - d) * counts.astype(np.float64)

    def residency_targets(self) -> Tuple[Tuple[int, int, Tuple[int, ...]], ...]:
        """Per (layer, bucket), the top-``R_i`` slots by EMA (stable: score
        descending, slot ascending) are the desired resident set; returns
        ``(bucket, layer, desired)`` for each one not fully resident. Reads,
        never mutates (the controller plans from it)."""
        targets = []
        for l in range(self.num_layers):
            for i, bk in enumerate(self._bkeys):
                m = self.meta[i]
                r_i = self._budgets[i]
                if r_i >= m.count:
                    continue
                scores = self.ema[l, m.start:m.start + m.count]
                desired = tuple(int(s) for s in np.argsort(-scores, kind="stable")[:r_i])
                if any(self.slot_row[bk][l, s] < 0 for s in desired):
                    targets.append((i, l, desired))
        return tuple(targets)

    def _plan_targets(self, targets):
        """Place the desired slots of ``targets`` over the coldest undesired
        residents, after the prefetch ladder; returns ``(pending, pend_rows,
        uploads)`` per bucket."""
        ups = 0
        pending = {bk: [] for bk in self._bkeys}
        pend_rows = {bk: [] for bk in self._bkeys}
        for i, l, desired in targets:
            bk = self._bkeys[i]
            m = self.meta[i]
            scores = self.ema[l, m.start:m.start + m.count]
            want = sorted(s for s in desired if self.slot_row[bk][l, s] < 0)
            if not want:
                continue
            want, rows_pay = self._clear_for_upload(i, l, want, "prefetch")
            if not want:
                continue
            placed = self._place(i, l, want, set(desired), lambda s, scores=scores: scores[s])
            pending[bk].extend(placed)
            if rows_pay is not None:
                pend_rows[bk].extend(rows_pay)
            ups += len(placed)
        return pending, pend_rows, ups

    def apply_residency(self, targets) -> Tuple[int, int]:
        """Converge residency toward :meth:`residency_targets`' output, with
        one batched upload and map refresh per bucket. Returns ``(uploads,
        bytes)``."""
        if not targets:
            return 0, 0
        t0 = self.tracer.now_us()
        pending, pend_rows, ups = self._plan_targets(targets)
        nbytes = 0
        for bk in self._bkeys:
            if pending[bk]:
                nbytes += self._upload_batch(bk, pending[bk], pend_rows[bk] or None)
                self._refresh_map(bk)
        if ups:
            self.tracer.complete("expert_upload", track="experts", cat="offload", start_us=t0,
                                 args={"kind": "prefetch", "uploads": ups, "bytes": nbytes})
        return ups, nbytes

    def prefetch(self) -> Tuple[int, int]:
        """:meth:`residency_targets` then :meth:`apply_residency` in one call
        (the engine goes through the controller's plan instead)."""
        return self.apply_residency(self.residency_targets())

    # ------------------------------------------------ async double-buffering
    def issue_async(self, targets) -> Tuple[int, int]:
        """Stage one boundary's prefetch uploads without touching the live
        residency state. The ladder and the placement run at once, on copies
        of the tables; each bucket's rows are gathered into pinned host
        memory and copied to device staging buffers with ``non_blocking=True``
        on a side stream, which then records an event. Nothing here waits on
        the device or reads from it. At most one batch is in flight; a second
        issue before the commit is a no-op. Returns ``(uploads, bytes)``
        staged."""
        if not targets or self._inflight is not None:
            return 0, 0
        t0_us = self.tracer.now_us()
        live_sr, live_rs = self.slot_row, self.row_slot
        self.slot_row = {bk: a.copy() for bk, a in live_sr.items()}
        self.row_slot = {bk: a.copy() for bk, a in live_rs.items()}
        versions = dict(self._bucket_version)
        budgets = tuple(self._budgets)
        try:
            pending, pend_rows, ups = self._plan_targets(targets)
        finally:
            staged_sr, staged_rs = self.slot_row, self.row_slot
            self.slot_row, self.row_slot = live_sr, live_rs
        if ups == 0:
            return 0, 0
        cuda = self.device.type == "cuda"
        staged, nbytes, event = {}, 0, None
        for bk in self._bkeys:
            if pending[bk]:
                rows, nb = self._gather(bk, pending[bk], pend_rows[bk] or None, pin=cuda)
                staged[bk] = (*self._indices(pending[bk], pin=cuda), rows)
                nbytes += nb
        if cuda:
            if self._side_stream is None:
                self._side_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._side_stream):
                # allocated on the side stream, so no buffer the running
                # program may still use is handed out here
                staged = {bk: (li.to(self.device, non_blocking=True),
                               ri.to(self.device, non_blocking=True),
                               tree_map(lambda a: a.to(self.device, non_blocking=True), rows))
                          for bk, (li, ri, rows) in staged.items()}
                event = torch.cuda.Event()
                event.record(self._side_stream)
        self._inflight = {"staged": staged, "event": event, "slot_row": staged_sr,
                          "row_slot": staged_rs, "versions": versions, "budgets": budgets,
                          "uploads": ups, "nbytes": nbytes, "t0_us": t0_us}
        return ups, nbytes

    def commit_async(self) -> Tuple[int, int, int, float]:
        """Flip the staged batch in at a megastep boundary — unless a bucket's
        version moved since the issue (a miss upload or a grow landed), in
        which case the whole batch is dropped. Otherwise the host waits on the
        staging event (``wait_s``, the part of the copy the megastep did not
        hide), the compute stream waits on it too, the staged rows are
        scattered into the live buffers on the compute stream, and tables and
        maps are swapped in. Returns ``(committed, dropped, bytes, wait_s)``."""
        inf, self._inflight = self._inflight, None
        if inf is None:
            return 0, 0, 0, 0.0
        if tuple(self._budgets) != inf["budgets"] or any(
                self._bucket_version[bk] != v for bk, v in inf["versions"].items()):
            self.tracer.instant("expert_upload_dropped", track="experts", cat="offload",
                                uploads=inf["uploads"])
            return 0, inf["uploads"], 0, 0.0
        t0 = time.time()
        event = inf["event"]
        if event is not None:
            event.synchronize()
        wait_s = time.time() - t0
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for li, ri, rows in inf["staged"].values():
                for t in (li, ri, *(a for _, a in tree_paths(rows))):
                    t.record_stream(compute)  # freed only after the scatter ran
        for bk, (li, ri, rows) in inf["staged"].items():
            self._scatter(bk, li, ri, rows)
            self._bucket_version[bk] += 1
        self.slot_row = inf["slot_row"]
        self.row_slot = inf["row_slot"]
        for bk in inf["staged"]:
            self._refresh_map(bk)
        self.tracer.complete("expert_upload", track="experts", cat="offload",
                             start_us=inf["t0_us"],
                             args={"kind": "async", "uploads": inf["uploads"],
                                   "bytes": inf["nbytes"]})
        return inf["uploads"], 0, inf["nbytes"], wait_s

    # -------------------------------------------------------- housekeeping
    def prune_backoff(self) -> int:
        """Drop prefetch-backoff entries that can never be consumed: rows
        that were degraded (their target-bit upload is never re-attempted)
        and rows that became resident another way. The controller calls this
        at every plan boundary. Returns the entries pruned."""
        stale = [key for key in self._retry_after
                 if key in self._degraded_rows or self.slot_row[key[0]][key[1], key[2]] >= 0]
        for key in stale:
            del self._retry_after[key]
            if key in self._degraded_rows:
                self._attempts.pop(key, None)
        return len(stale)
