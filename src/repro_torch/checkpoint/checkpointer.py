"""Checkpointing: async, atomic, keep-last-k (port of
``repro/checkpoint/checkpointer.py``, in its on-disk format).

* ``save`` copies the tree's tensors to host numpy synchronously, then a
  writer thread serializes them to ``step_XXXXXXXX.tmp/arrays.npz`` and
  renames the directory to ``step_XXXXXXXX`` — training never blocks on
  disk.
* ``manifest.json`` is written last inside the directory; a checkpoint
  without one is invisible to :meth:`Checkpointer.latest_step`.
* ``restore(step, like)`` rebuilds the tree of ``like`` (its shapes,
  dtypes and devices); with ``shardings=`` (a matching tree of
  :class:`~repro_torch.parallel.sharding.NamedSharding`, on a mesh other
  than the one that saved, as after :func:`~repro_torch.runtime.elastic.shrink_mesh`)
  each rank gets its slices of the arrays.
* ``keep`` bounds disk use (keep-last-k).

Arrays are keyed by ``/``-joined tree paths, as the reference keys them:
dict keys, list indices, and ``.name`` for a NamedTuple field (the 8-bit
AdamW moments' ``.q`` and ``.scale``). bf16 tensors are stored as 2-byte
void arrays, which is how numpy writes the reference's bf16 arrays, and
read back by their bits. So a checkpoint the reference wrote opens here
(:func:`repro_torch.interop.params_from_checkpoint` carries its params
into the port's layout).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.tree import tree_paths
from ..parallel.sharding import shard_tensor

__all__ = ["Checkpointer", "flatten_with_paths"]


def flatten_with_paths(tree) -> Dict[str, Any]:
    """``{path: leaf}`` of a tree of dicts, lists, tuples and NamedTuples,
    its :func:`~repro_torch.core.tree.tree_paths` joined by ``/``."""
    return {"/".join(map(str, path)): leaf for path, leaf in tree_paths(tree)}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like):
    if not isinstance(like, torch.Tensor):
        return arr
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint array {tuple(t.shape)} does not fit {tuple(like.shape)}")
    return t.to(like.device)


def _rebuild(like, values: Dict[str, Any], prefix: str = ""):
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(like, dict):
        return {k: _rebuild(v, values, join(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), values, join(f".{n}"))
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values, join(i)) for i, v in enumerate(like))
    return values[prefix]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._async = async_write
        self._errors: list = []
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- write
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        snapshot = {k: _to_numpy(v) for k, v in flatten_with_paths(tree).items()}
        if self._async and not blocking:
            self._q.put((step, snapshot))
        else:
            self._write(step, snapshot)

    def wait(self) -> None:
        """Block until every queued write has landed (and raise its errors)."""
        if self._async:
            self._q.join()
        if self._errors:
            raise RuntimeError(f"checkpoint writer failed: {self._errors}")

    def _worker(self):
        while True:
            step, snapshot = self._q.get()
            try:
                self._write(step, snapshot)
            except Exception as e:  # noqa: BLE001 - surfaced by wait()
                self._errors.append(repr(e))
            finally:
                self._q.task_done()

    def _write(self, step: int, snapshot: Dict[str, np.ndarray]):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **snapshot)
        manifest = {"step": step, "time": time.time(), "keys": sorted(snapshot)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -------------------------------------------------------------- read
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def arrays(self, step: int) -> Dict[str, np.ndarray]:
        """Every array of checkpoint ``step``, by path (numpy, as stored)."""
        with np.load(os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")) as data:
            return {k: data[k] for k in data.files}

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """The tree of ``like`` (shape, dtype and device template of the
        whole arrays) with the values of checkpoint ``step``; a leaf with a
        sharding in ``shardings`` comes back as this rank's slice of it."""
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        named = flatten_with_paths(like)
        shard_named = {} if shardings is None else flatten_with_paths(shardings)
        values = {}
        with np.load(path) as data:
            for k, leaf in named.items():
                v = _from_numpy(data[k], leaf)
                if k in shard_named and isinstance(v, torch.Tensor):
                    sh = shard_named[k]
                    v = shard_tensor(v, sh.spec, sh.mesh).clone()
                values[k] = v
        return _rebuild(like, values)
