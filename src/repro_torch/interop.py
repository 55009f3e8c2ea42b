"""Carry the JAX package's serving parameters into the port, byte for byte.

Input is plain numpy — the port never imports ``jax``; the flattening of
the reference tree into numpy lives with the tests:

* ``flat``: ``{path: np.ndarray}`` over the reference's stacked tree — the
  compressed serving layout (``compress_for_serving``) or the uncompressed
  ``init_lm`` one (``blocks/mlp/w_*/w``; ``blocks/moe/router/w``,
  ``blocks/moe/experts/{w_gate,w_up,w_down}`` ``[L, E, ·, ·]``,
  ``blocks/moe/shared/...``) — with ``/``-joined paths:
  ``embed``, ``final_norm``, ``unembed``, ``blocks/<...>`` leaves stacked
  over layers on axis 0. A ``PackedTensor`` at ``P`` contributes ``P/data``
  (or ``P/hi`` and ``P/lo``), ``P/scale`` and ``P/zero``; the
  ``CompressedExperts`` at ``blocks/moe_ce`` contributes
  ``blocks/moe_ce/slot_of_expert`` and ``blocks/moe_ce/b<i>/<name>/<key>``.
* ``meta``: the static metadata — ``{"num_layers": L, "packed": {P:
  {"bits", "shape", "group"}}, "moe_ce"?: {"buckets": [[bits, start,
  count], ...], "num_slots", "group", "d_model", "d_ff"}}`` (``moe_ce``
  only for a compressed MoE).

bf16 arrays may arrive as numpy's ``bfloat16`` extension dtype, or as the
2-byte void arrays numpy reads such an array back from a checkpoint as;
their bits are reinterpreted, never converted.

The ``encdec``, ``hybrid`` and ``ssm`` families (a tree without
``blocks/``; ``meta`` unused) take their plain tree: leaves under
``enc_blocks/``, ``dec_blocks/`` and ``groups/`` are stacked over blocks on
axis 0 and become lists of per-block dicts (``groups/<rg1|rg2|attn|m|s>/
...``); a list in the reference's tree (recurrentgemma's ``tail/<i>/...``)
stays a list, and an empty one, which leaves no key, comes back as ``[]``.

:func:`params_from_checkpoint` carries the ``params`` of a checkpoint the
reference's trainer wrote (``repro.launch.train``, the examples) through the
same mapping: that is how a model trained by the reference reaches the port.

The step builders' other arguments (``repro_torch.launch.steps``): the
stacked OTP routers ``{"fc1": [L, D, k], "fc2": [L, 2k, k]}`` become one
router per layer (:func:`otp_from_reference`), and an ``adamw_init`` /
``adamw_update`` state keeps the reference's stacked tree, which the port's
steps use too (:func:`opt_state_from_reference`; an 8-bit moment's ``q`` and
``scale`` become a :class:`~repro_torch.optim.adamw.Q8`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.compressed_moe import BucketMeta, CompressedExperts
from .core.packing import PackedTensor
from .optim.adamw import Q8

__all__ = ["opt_state_from_reference", "otp_from_reference", "params_from_checkpoint",
           "params_from_reference"]

_BLOCKS = "blocks/"
#: the stacked roots of the non-transformer families' trees
_STACKED = ("enc_blocks", "dec_blocks", "groups")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
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


def _listify(node):
    """Dicts whose keys are all list indices become lists, bottom up."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def _is_family_tree(flat: Dict[str, np.ndarray]) -> bool:
    """A whisper, recurrentgemma or xlstm tree: stacked roots, no ``blocks/``."""
    roots = {p.partition("/")[0] for p in flat}
    return "blocks" not in roots and bool(roots & set(_STACKED))


def _family_params(flat: Dict[str, np.ndarray], device) -> Dict:
    """The plain tree of an ``encdec``, ``hybrid`` or ``ssm`` model, its
    stacked roots unstacked into lists of per-block dicts."""
    out = {}
    for path, a in flat.items():
        root, _, rest = path.partition("/")
        if root in _STACKED:
            for i in range(a.shape[0]):
                out[f"{root}/{i}/{rest}"] = _tensor(a[i], device)
        else:
            out[path] = _tensor(a, device)
    tree = _listify(_nest(out))
    if tree.get("groups") and "rg1" in tree["groups"][0]:
        # a flat tree has no key for recurrentgemma's empty ``tail`` list
        tree.setdefault("tail", [])
    return tree


def _packed(node: Dict, m: Dict) -> PackedTensor:
    data = (node["hi"], node["lo"]) if m["bits"] == 3 else node["data"]
    return PackedTensor(data=data, scale=node["scale"], zero=node["zero"], bits=m["bits"],
                        shape=tuple(m["shape"]), group=m["group"])


def params_from_reference(flat: Dict[str, np.ndarray], meta: Dict, *, device="cuda") -> Dict:
    """Build the port's per-layer params (see :mod:`repro_torch.models.transformer`;
    for the other families the modules named in the module docstring)."""
    if _is_family_tree(flat):
        return _family_params(flat, device)
    top = {p: _tensor(a, device) for p, a in flat.items() if not p.startswith(_BLOCKS)}
    params = dict(top, layers=[])
    ce_meta = meta.get("moe_ce")
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
        if ce_meta is not None:
            layer["moe_ce"] = CompressedExperts(
                meta=tuple(BucketMeta(*map(int, b)) for b in ce_meta["buckets"]),
                slot_of_expert=ce.pop("slot_of_expert").long(), arrays=_nest(ce),
                num_slots=int(ce_meta["num_slots"]), group=int(ce_meta["group"]),
                d_model=int(ce_meta["d_model"]), d_ff=int(ce_meta["d_ff"]),
            )
        params["layers"].append(layer)
    return params


def params_from_checkpoint(ckpt, step: int, *, device="cuda") -> Dict:
    """The uncompressed ``params`` of checkpoint ``step`` of ``ckpt`` (a
    :class:`~repro_torch.checkpoint.checkpointer.Checkpointer`) in the port's
    per-layer layout; the checkpoint holds the reference's stacked tree
    (``params/blocks/...`` with layers on axis 0, or a ``hybrid`` or ``ssm``
    model's ``params/groups/...``)."""
    head = "params/"
    flat = {k[len(head):]: a for k, a in ckpt.arrays(step).items() if k.startswith(head)}
    if _is_family_tree(flat):
        return _family_params(flat, device)
    layers = {a.shape[0] for k, a in flat.items() if k.startswith(_BLOCKS)}
    if len(layers) != 1:
        raise ValueError(f"checkpoint {step}: no stacked blocks under {head!r}")
    return params_from_reference(flat, {"num_layers": layers.pop(), "packed": {}},
                                 device=device)


def otp_from_reference(flat: Dict[str, np.ndarray], *, device="cuda"):
    """The reference's stacked OTP routers (``{"fc1": [L, D, k], "fc2":
    [L, 2k, k]}`` as numpy) as one ``{"fc1", "fc2"}`` per layer."""
    return [{k: _tensor(a[l], device) for k, a in flat.items()}
            for l in range(flat["fc1"].shape[0])]


def opt_state_from_reference(flat: Dict[str, np.ndarray], *, device="cuda") -> Dict:
    """An AdamW state of the reference (``step`` and ``per_param/<path>/<m
    | v | master>``, an 8-bit moment's ``/q`` and ``/scale``; stacked leaves
    stay stacked) as the port's steps hold it."""
    def q8(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {"q", "scale"}:
            return Q8(q=node["q"], scale=node["scale"])
        return {k: q8(v) for k, v in node.items()}

    return q8(_nest({k: _tensor(a, device) for k, a in flat.items()}))
