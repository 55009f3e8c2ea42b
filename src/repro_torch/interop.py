"""Carry the JAX package's serving parameters into the port, byte for byte.

Input is plain numpy — the port never imports ``jax``; the flattening of
the reference tree into numpy lives with the tests:

* ``flat``: ``{path: np.ndarray}`` over the reference's stacked serving
  tree (``compress_for_serving`` layout), with ``/``-joined paths:
  ``embed``, ``final_norm``, ``unembed``, ``blocks/<...>`` leaves stacked
  over layers on axis 0. A ``PackedTensor`` at ``P`` contributes ``P/data``
  (or ``P/hi`` and ``P/lo``), ``P/scale`` and ``P/zero``; the
  ``CompressedExperts`` at ``blocks/moe_ce`` contributes
  ``blocks/moe_ce/slot_of_expert`` and ``blocks/moe_ce/b<i>/<name>/<key>``.
* ``meta``: the static metadata — ``{"num_layers": L, "packed": {P:
  {"bits", "shape", "group"}}, "moe_ce": {"buckets": [[bits, start,
  count], ...], "num_slots", "group", "d_model", "d_ff"}}``.

bf16 arrays may arrive as numpy's ``bfloat16`` extension dtype; their bits
are reinterpreted, never converted.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.compressed_moe import BucketMeta, CompressedExperts
from .core.packing import PackedTensor

__all__ = ["params_from_reference"]

_BLOCKS = "blocks/"


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _nest(flat: Dict[str, object]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _packed(node: Dict, m: Dict) -> PackedTensor:
    data = (node["hi"], node["lo"]) if m["bits"] == 3 else node["data"]
    return PackedTensor(data=data, scale=node["scale"], zero=node["zero"], bits=m["bits"],
                        shape=tuple(m["shape"]), group=m["group"])


def params_from_reference(flat: Dict[str, np.ndarray], meta: Dict, *, device="cuda") -> Dict:
    """Build the port's per-layer params (see :mod:`repro_torch.models.transformer`)."""
    top = {p: _tensor(a, device) for p, a in flat.items() if not p.startswith(_BLOCKS)}
    params = dict(top, layers=[])
    ce_meta = meta["moe_ce"]
    buckets = tuple(BucketMeta(*map(int, b)) for b in ce_meta["buckets"])
    for l in range(meta["num_layers"]):
        layer_flat = {
            p[len(_BLOCKS):]: _tensor(a[l], device)
            for p, a in flat.items() if p.startswith(_BLOCKS)
        }
        packed_here = {
            p[len(_BLOCKS):]: m for p, m in meta["packed"].items() if p.startswith(_BLOCKS)
        }
        for path, m in packed_here.items():
            sub = {key: layer_flat.pop(f"{path}/{key}")
                   for key in ("data", "hi", "lo", "scale", "zero")
                   if f"{path}/{key}" in layer_flat}
            layer_flat[path] = _packed(sub, m)
        ce = {p[len("moe_ce/"):]: layer_flat.pop(p)
              for p in [p for p in layer_flat if p.startswith("moe_ce/")]}
        layer = _nest(layer_flat)
        slot_of_expert = ce.pop("slot_of_expert").long()
        layer["moe_ce"] = CompressedExperts(
            meta=buckets, slot_of_expert=slot_of_expert, arrays=_nest(ce),
            num_slots=int(ce_meta["num_slots"]), group=int(ce_meta["group"]),
            d_model=int(ce_meta["d_model"]), d_ff=int(ce_meta["d_ff"]),
        )
        params["layers"].append(layer)
    return params
