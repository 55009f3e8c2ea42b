"""Three-tier expert backing store: mmap'd disk → host cache → device (port
of ``repro/serving/tierstore.py``).

The offload manager's two-tier store keeps every packed PMQ bucket leaf as
a full numpy copy in host memory, which costs as much RAM as the model's
expert bytes. This store adds the bottom rung: the pristine packed buckets
are spilled once to ``offload_dir`` and reopened memory-mapped
(``np.load(mmap_mode="r")``), so the OS page cache owns cold expert bytes,
and a byte-budgeted host cache of hot rows sits between the disk images and
the device partitions:

* **Disk** (coldest): one ``.npy`` per leaf, named ``b<i>__<path>.npy``,
  ``[L, count, ...]`` in sorted key order; ``manifest.json`` holds
  ``buckets`` (each leaf's path and file) and one CRC32 per
  ``b<i>/<layer>/<slot>`` row (:func:`~.faults.checksum_tree` of the row),
  recorded from the in-memory tree at spill time. Every disk fetch is
  verified against it and fails closed with
  :class:`~.faults.ExpertUploadFailed`. The format is the reference's, so
  either package reopens the other's directory.
* **Host** (warm): a row cache bounded by ``host_budget_bytes``. At equal
  routing heat it evicts the row that frees the most bytes first, so
  wide-bit rows earn their host residency with traffic while 1-bit rows
  are cheap to keep. A disk read installs the row at its current heat (the
  offload manager's routing EMA); eviction is the only demotion.
* **Device** (hottest): the resident partitions of
  :class:`~.offload.ExpertOffloadManager`.

The disk tier always serves the pristine target-bit payload, so a row
fetched through any rung is bitwise the two-tier host copy. Fetches are
counted through the tracer's ``tier_fetch`` lifecycle events, which keeps
the counters deterministic per trace. Every expert leaf is uint8 or f32,
so the ``.npy`` files need no bf16 dtype.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.tree import tree_map, tree_paths
from .faults import ExpertUploadFailed, checksum_tree

__all__ = ["TieredExpertStore"]

_MANIFEST = "manifest.json"


def _leaf_name(bk: str, path: Tuple[str, ...]) -> str:
    return bk + "__" + "__".join(path) + ".npy"


def _set_path(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _null_tracer(tracer):
    if tracer is None:
        from .trace import NULL_TRACER

        return NULL_TRACER
    return tracer


class TieredExpertStore:
    """Disk-backed expert row store with a byte-budgeted host cache.

    ``host`` maps bucket key → nested dict of ``[L, count, ...]`` numpy
    leaves (the offload manager's backing store). The constructor spills
    every leaf to ``offload_dir``, writes the CRC manifest and reopens the
    files memory-mapped; the caller then drops ``host``.
    ``host_budget_bytes=None`` means an unbounded host cache, ``0`` no host
    caching (every fetch reads and verifies the mmap).
    """

    def __init__(self, host: Dict[str, Dict], *, offload_dir: str,
                 host_budget_bytes: Optional[int] = None, tracer=None):
        self.tracer = _null_tracer(tracer)
        self.dir = str(offload_dir)
        self.host_budget_bytes = None if host_budget_bytes is None else int(host_budget_bytes)
        os.makedirs(self.dir, exist_ok=True)
        manifest = {"buckets": {}, "crc": {}}
        for bk in sorted(host):
            files = []
            for path, leaf in tree_paths(host[bk]):
                fname = _leaf_name(bk, path)
                np.save(os.path.join(self.dir, fname), leaf)
                files.append({"path": list(path), "file": fname})
            manifest["buckets"][bk] = files
            # per-row CRCs from the in-memory tree, before the mmap reopen: a
            # spill that tore is caught at its first fetch
            first = tree_paths(host[bk])[0][1]
            for layer in range(first.shape[0]):
                for slot in range(first.shape[1]):
                    row = tree_map(lambda a: a[layer, slot], host[bk])
                    manifest["crc"][f"{bk}/{layer}/{slot}"] = checksum_tree(row)
        with open(os.path.join(self.dir, _MANIFEST), "w") as f:
            json.dump(manifest, f, sort_keys=True)
        self._load_manifest(manifest)

    @classmethod
    def reopen(cls, offload_dir: str, tracer=None) -> "TieredExpertStore":
        """Reattach to a spill directory without rewriting it: mmap every
        leaf the manifest lists, start with a cold, unbounded host cache, and
        verify rows against the original spill's CRCs."""
        self = cls.__new__(cls)
        self.tracer = _null_tracer(tracer)
        self.dir = str(offload_dir)
        self.host_budget_bytes = None
        with open(os.path.join(self.dir, _MANIFEST)) as f:
            self._load_manifest(json.load(f))
        return self

    def _load_manifest(self, manifest: Dict) -> None:
        self._crc = {tuple(k.split("/")): v for k, v in manifest["crc"].items()}
        self.disk: Dict[str, Dict] = {}
        for bk, files in manifest["buckets"].items():
            tree: Dict = {}
            for ent in files:
                leaf = np.load(os.path.join(self.dir, ent["file"]), mmap_mode="r")
                _set_path(tree, tuple(ent["path"]), leaf)
            self.disk[bk] = tree
        # host cache: key -> (row tree, nbytes, heat)
        self._cache: Dict[Tuple[str, int, int], Tuple[Dict, int, float]] = {}
        self._cache_bytes = 0

    # ------------------------------------------------------------- sizing
    @property
    def disk_bytes(self) -> int:
        return sum(a.nbytes for bk in self.disk for _, a in tree_paths(self.disk[bk]))

    @property
    def host_cached_bytes(self) -> int:
        return self._cache_bytes

    # -------------------------------------------------------------- fetch
    def crc(self, bk: str, layer: int, slot: int) -> int:
        return self._crc[(bk, str(int(layer)), str(int(slot)))]

    def row(self, bk: str, layer: int, slot: int, heat: float = 0.0) -> Dict:
        """The ``(layer, slot)`` row tree of bucket ``bk`` from the warmest
        tier that holds it. A host hit refreshes the row's heat; a disk fetch
        copies the row out of the mmap, checks its CRC against the manifest
        (raising :class:`ExpertUploadFailed` on a mismatch) and promotes it
        into the host cache at ``heat``."""
        key = (bk, int(layer), int(slot))
        hit = self._cache.get(key)
        if hit is not None:
            row, nbytes, _ = hit
            self._cache[key] = (row, nbytes, float(heat))
            self.tracer.lifecycle("tier_fetch", track="experts", tier="host", nbytes=0)
            return row
        row = tree_map(lambda a: np.array(a[int(layer), int(slot)]), self.disk[bk])
        if checksum_tree(row) != self.crc(bk, layer, slot):
            raise ExpertUploadFailed(
                f"disk-tier row ({bk}, layer {layer}, slot {slot}) failed CRC against the "
                f"spill manifest — refusing to serve corrupt expert bytes")
        nbytes = sum(a.nbytes for _, a in tree_paths(row))
        self.tracer.lifecycle("tier_fetch", track="experts", tier="disk", nbytes=int(nbytes))
        self._promote(key, row, nbytes, float(heat))
        return row

    def _promote(self, key, row: Dict, nbytes: int, heat: float) -> None:
        budget = self.host_budget_bytes
        if budget is not None and nbytes > budget:
            return  # the row alone exceeds the cache: served disk-direct
        self._cache[key] = (row, int(nbytes), heat)
        self._cache_bytes += int(nbytes)
        if budget is None:
            return
        while self._cache_bytes > budget and len(self._cache) > 1:
            # coldest first, widest (most bytes) first on equal heat
            victim = min((k for k in self._cache if k != key),
                         key=lambda k: (self._cache[k][2], -self._cache[k][1], k))
            self._cache_bytes -= self._cache[victim][1]
            del self._cache[victim]
