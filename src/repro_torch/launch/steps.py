"""Step-function builders (port of ``repro/launch/steps.py``).

``build_step(cfg, shape, mesh)`` returns a :class:`StepArtifacts` as the
reference's does — ``(name, fn, arg_specs, in_shardings, donate_argnums,
meta)`` — for the four step kinds:

* ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
  full training, ``value_and_grad`` and AdamW, with ``accum`` microbatches;
  ``params`` and ``opt_state`` are donated, as the reference's are: the
  step writes its results into them and returns them (the OTP step its
  routers and state likewise);
* ``otp_train_step(otp, opt_state, frozen, batch, draws) -> (otp,
  opt_state, loss, kl)``: the paper's Eq. 14 on the frozen PMQ-compressed
  backbone (kimi-k2's default);
* ``prefill_step(params, batch) -> (cache, logits)`` and ``decode_step(params,
  cache, token, pos) -> (cache, logits)``, bf16 or PMQ (``precision``).

JAX lowers ``fn`` once for all devices; here ``fn`` runs eagerly on each
rank of ``mesh`` (one process per rank over ``torch.distributed``, or
``mesh=None`` for one process) on that rank's blocks of its arguments.
``arg_specs`` are tensors on the ``meta`` device in the port's layouts, and
``in_shardings`` the trees of :class:`~repro_torch.parallel.sharding.NamedSharding`
that say which block of each argument a rank holds; :func:`shard_args` cuts
whole arguments into them.

Layouts:

* parameters are the port's per-layer trees, cut by
  :func:`~repro_torch.parallel.ep_shardmap.shard_params` with the config:
  expert buckets by expert parallelism, attention and the dense and
  shared-expert MLPs by tensor parallelism where the pair splits;
* the optimizer state is the reference's: :func:`adamw_init`'s tree over the
  stacked parameters (``blocks/...`` stacked over layers on axis 0, the OTP
  routers' ``fc1``/``fc2`` likewise), so its 8-bit codes are the reference's
  byte for byte. Each rank holds its ZeRO-1 block (:func:`_opt_shardings`,
  the reference's): the parameter's spec plus ``data`` on the first free
  axis that divides. An 8-bit moment is cut into whole 128-element blocks
  of the stacked leaf's flatten order over ``(data, model)``, ``data`` or
  ``model`` where the rank holds the whole leaf and the blocks divide, and
  stays whole on every rank otherwise (logged);
* with ``accum > 1`` a rank's block of a batch leaf is its share of each
  microbatch where the microbatch divides over the batch axes (the spec
  applies to the microbatch view ``[accum, B / accum, ...]``); otherwise it
  is the rank's rows of the whole batch, and each microbatch — the
  reference's rows ``[m·B/accum, (m+1)·B/accum)`` — runs on the ranks that
  hold its rows, empty on the others (:func:`_micro_rows`).

Under a mesh, gradients reach each rank as its contribution to the global
loss (the losses sum over the batch axes); the step sums them over the batch
axes with one reduce-scatter onto the state's layout per stacked leaf, runs
AdamW on its block and all-gathers the parameters back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.compressed_moe import CompressedExperts
from ..core.packing import PackedTensor
from ..models.registry import get_model, on_meta
from ..optim.adamw import Q8, AdamWConfig, adamw_init, adamw_update
from ..parallel import sharding as shd
from ..parallel.ep_shardmap import BLOCK_LISTS, etp_ok, expert_spec, shard_params, tp_plan
from ..parallel.sharding import NamedSharding, batch_axes
from . import specs as spec_mod

__all__ = ["ACCUM", "OTP_ADAMW", "StepArtifacts", "build_step", "init_opt_blocks", "otp_gradients",
           "shard_args", "stack_tree", "stacked_paths", "tree_gradients", "unstack_tree"]

_log = logging.getLogger(__name__)

#: microbatches per train step where ``accum=0`` asks for the reference's
#: table (token-scaled buffers must fit per microbatch)
ACCUM = {"moonshot-v1-16b-a3b": 4, "kimi-k2-1t-a32b": 8, "command-r-35b": 16, "gemma3-27b": 8,
         "qwen3-14b": 2, "recurrentgemma-2b": 2}
_BLOCK = 128
#: the OTP step's optimizer (the reference's ``_build_otp_train``)
OTP_ADAMW = AdamWConfig(lr=2e-3, weight_decay=0.0)


@dataclasses.dataclass
class StepArtifacts:
    name: str
    fn: Any
    arg_specs: Tuple
    in_shardings: Any
    donate_argnums: Tuple[int, ...]
    meta: Dict
    out_shardings: Any = None
    #: full training only: ``grads(params, batch) -> (loss, {path: gradient})``,
    #: the step's gradients on this rank's optimizer-state blocks (summed over
    #: the batch axes, averaged over the microbatches) before its update
    grads: Any = None


def _names(entry) -> Tuple[str, ...]:
    """The axis names of a spec entry (none for a replicated dim)."""
    return () if entry is None else shd._names(entry)


def _ranks(mesh) -> int:
    return 1 if mesh is None else math.prod(mesh.shape.values())


def _one_rank():
    """The mesh of one process (``data = model = 1``)."""
    return shd.Mesh(("data", "model"), (1, 1), coord=(0, 0))


def _rules(mesh):
    """The mesh's ``sharding_rules`` on a mesh of several ranks; one rank
    runs the plain path, as the reference's step on a 1 × 1 mesh does."""
    return shd.sharding_rules(mesh) if _ranks(mesh) > 1 else contextlib.nullcontext()


# --------------------------------------------------------- stacked trees
#: the per-block lists of a port tree that the reference stacks on axis 0,
#: by the reference's root name for each (``tail`` stays a list of blocks,
#: ``tail/<i>/...``, as the reference keeps it)
STACKED_ROOTS = {"layers": "blocks", "enc_blocks": "enc_blocks", "dec_blocks": "dec_blocks",
                 "groups": "groups"}


def _walk(node, prefix: str, out: Dict):
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], f"{prefix}/{k}" if prefix else k, out)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _walk(v, f"{prefix}/{i}" if prefix else str(i), out)
    else:
        out[prefix] = node


def _flatten_order(path: str) -> Tuple:
    """A path's place in the reference's flatten order (dict keys sorted, a
    list's items by index, level by level)."""
    return tuple((0, int(k), "") if k.isdigit() else (1, 0, k) for k in path.split("/"))


def stack_tree(params) -> Dict[str, List]:
    """``{reference path: [leaf of each block]}`` of a port tree — a model's
    (each list of :data:`STACKED_ROOTS` stacked under the reference's root:
    a transformer's ``layers`` as ``blocks/...``, ``groups/...``,
    ``enc_blocks/...``, ``dec_blocks/...``; every other key, ``tail/<i>/...``
    too, one leaf) or a list of per-layer OTP routers (``fc1``/``fc2``) — in
    the reference's flatten order. The lists hold the port's leaves (no
    copy)."""
    out: Dict[str, List] = {}
    if isinstance(params, list):
        for layer in params:
            flat: Dict = {}
            _walk(layer, "", flat)
            for path, leaf in flat.items():
                out.setdefault(path, []).append(leaf)
        return out
    for key in params:
        flat = {}
        if key in STACKED_ROOTS:
            for layer in params[key]:
                flat = {}
                _walk(layer, STACKED_ROOTS[key], flat)
                for path, leaf in flat.items():
                    out.setdefault(path, []).append(leaf)
        else:
            _walk(params[key], key, flat)
            out.update({p: [leaf] for p, leaf in flat.items()})
    return {p: out[p] for p in sorted(out, key=_flatten_order)}


def stacked_paths(params) -> set:
    """The paths of :func:`stack_tree` that stack blocks (all of a list of
    routers; those under a root of :data:`STACKED_ROOTS` of a model)."""
    flat = stack_tree(params)
    if isinstance(params, list):
        return set(flat)
    return {p for p in flat if p.split("/")[0] in STACKED_ROOTS.values()}


def unstack_tree(template, flat: Dict[str, List]):
    """``template``'s structure with the leaves of ``flat`` (as
    :func:`stack_tree` gives it)."""
    it = {p: iter(v) for p, v in flat.items()}

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(node)]
        return next(it[prefix])

    if isinstance(template, list):
        return [rebuild(layer, "") for layer in template]
    out = {}
    for key, node in template.items():
        if key in STACKED_ROOTS:
            out[key] = [rebuild(layer, STACKED_ROOTS[key]) for layer in node]
        else:
            out[key] = rebuild(node, key)
    return out


def _stack(leaves: List, stacked: bool) -> torch.Tensor:
    return torch.stack(leaves) if stacked else leaves[0]


def _set_path(tree: Dict, path: str, value) -> None:
    *parents, name = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[name] = value


def _get_path(tree: Dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _stacked_meta(flat: Dict[str, List], stacked: set) -> Dict:
    """The reference's stacked tree of meta tensors from :func:`stack_tree`'s
    lists of meta leaves."""
    tree: Dict = {}
    for path, leaves in flat.items():
        t = leaves[0]
        shape = ((len(leaves),) if path in stacked else ()) + tuple(t.shape)
        _set_path(tree, path, torch.empty(shape, dtype=t.dtype, device="meta"))
    return tree


# ------------------------------------------------------------- shardings
def _split_leaves(params, mesh, cfg) -> Dict[str, int]:
    """The ``/``-joined paths (to the ``{"w"}`` node) of every leaf that
    :func:`~repro_torch.parallel.ep_shardmap.shard_params` cuts — each
    block's pairs that :func:`~repro_torch.parallel.ep_shardmap.tp_plan`
    splits, and ``embed``/``unembed`` where the vocabulary splits — with the
    number of parts its columns are cut in (2 for a halves leaf, else 1)."""
    out: Dict[str, int] = {}
    for key in BLOCK_LISTS:
        for i, block in enumerate(params.get(key, [])):
            plan = tp_plan(block, mesh, cfg)
            for path, kind, _ in shd.tp_pairs(block):
                if plan[path]:
                    pair = shd.TP_PAIRS[kind]
                    for leaf in pair.cols + ((pair.row,) if pair.row else ()):
                        out["/".join(p for p in (key, str(i), path, leaf) if p)] = \
                            2 if leaf in pair.halves else 1
    if shd.vocab_split(cfg.vocab_size, mesh.shape.get("model", 1)):
        out.update({k: 1 for k in ("embed", "unembed") if k in params})
    return out


def _leaf_sharding(mesh, path: str, shape, split: Dict[str, int]) -> NamedSharding:
    """The port's sharding of one tensor of a per-layer tree
    (``<blocks>/<i>/...`` or a top-level key): a leaf of :func:`_split_leaves`
    by ``_PARAM_RULES`` (a halves leaf's share has the same extent as the
    spec's block, cut part by part), bf16 experts by their rows over
    ``model`` (expert parallelism), all else replicated."""
    nd = len(shape)
    if path in split:
        return NamedSharding(mesh, shd.param_spec_for_path(path, nd, False), split[path])
    if mesh.shape.get("model", 1) > 1 and re.search(r"/moe/experts/w_(gate|up|down)$", path):
        return NamedSharding(mesh, ("model", None, None))  # bf16 experts: the rank's rows
    m = re.match(r"(.+)/w(/\d+)*$", path)
    if m and m.group(1) in split:
        return NamedSharding(mesh, shd.param_spec_for_path(path.split("/", 2)[2], nd, False),
                             split[m.group(1)])
    return NamedSharding(mesh, (None,) * nd)


def _param_shardings(params, mesh, cfg):
    """The tree of :class:`NamedSharding` of a per-layer parameter tree as
    :func:`~repro_torch.parallel.ep_shardmap.shard_params` cuts it (a
    PackedTensor or CompressedExperts node as the tuple of its children's)."""
    split = _split_leaves(params, mesh, cfg)

    def one(node, path):
        if isinstance(node, CompressedExperts):
            etp = etp_ok(node, mesh.shape.get("data", 1))
            arrays = {bn: {wn: {key: NamedSharding(mesh, expert_spec(wn, a.dim(), etp))
                                for key, a in entry.items()}
                           for wn, entry in bucket.items()}
                      for bn, bucket in node.arrays.items()}
            return (NamedSharding(mesh, (None,) * node.slot_of_expert.dim()), arrays)
        if isinstance(node, PackedTensor):
            data = node.data if isinstance(node.data, tuple) else (node.data,)
            kids = [one(t, f"{path}/{i}") for i, t in enumerate((*data, node.scale, node.zero))]
            return (tuple(kids[:len(data)]) if len(data) > 1 else kids[0], kids[-2], kids[-1])
        if isinstance(node, dict):
            return {k: one(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if isinstance(node, list):
            return [one(v, f"{path}/{i}") for i, v in enumerate(node)]
        return _leaf_sharding(mesh, path, tuple(node.shape), split)

    return one(params, "")


def _replicated(mesh, tree):
    """Every tensor of ``tree`` replicated on ``mesh``."""
    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(one(v) for v in node)
        return NamedSharding(mesh, (None,) * getattr(node, "dim", lambda: 0)())
    return one(tree)


def _batch_shardings(mesh, batch_spec):
    """Each batch leaf over the batch axes on dim 0, replicated where they
    do not divide it (the reference's); with ``accum > 1`` the rows a rank
    holds are :func:`_micro_rows`'."""
    ba = shd._entry(batch_axes(mesh))

    def one(leaf):
        nd = leaf.dim()
        spec = (ba,) + (None,) * (nd - 1) if nd >= 1 else ()
        if not shd._divides(tuple(leaf.shape), spec, mesh):
            spec = (None,) * nd
        return NamedSharding(mesh, spec)

    return {k: one(v) for k, v in batch_spec.items()}


def _micro_major(rows: int, accum: int, mesh) -> bool:
    """Whether a batch of ``rows`` rows is cut microbatch by microbatch: each
    of its ``accum`` microbatches divides over the batch axes, and a rank
    holds its share of each, in order."""
    return accum > 1 and (rows // accum) % mesh.extent(batch_axes(mesh)) == 0


def _micro_rows(rows: int, accum: int, mesh) -> List[slice]:
    """This rank's rows of each microbatch in its block of a ``rows``-row
    batch. Microbatch ``m`` is the reference's rows ``[m·rows/accum,
    (m+1)·rows/accum)``. Cut microbatch by microbatch (:func:`_micro_major`),
    the block holds the rank's share of each in turn; otherwise the block is
    the rank's contiguous rows of the whole batch (all of them where the
    batch axes do not divide it), and a microbatch is the rows it shares
    with them — none on a rank whose block it misses."""
    mb = rows // accum
    nb = mesh.extent(batch_axes(mesh))
    if _micro_major(rows, accum, mesh):
        per = mb // nb
        return [slice(m * per, (m + 1) * per) for m in range(accum)]
    lo, hi = 0, rows
    if rows % nb == 0:
        lo = mesh.index(batch_axes(mesh)) * (rows // nb)
        hi = lo + rows // nb
    return [slice(min(max(m * mb, lo), hi) - lo, min(max((m + 1) * mb, lo), hi) - lo)
            for m in range(accum)]


def _cache_model_axes(params, mesh, cfg) -> Dict[str, int]:
    """The axis over ``model`` of each dense-cache entry whose layer splits
    (:func:`~repro_torch.parallel.ep_shardmap.tp_plan` of each block list's
    first block): K/V ``[L, B, S, Hkv, dh]`` by heads where the attention
    (whisper's ``cross`` for ``cross_k``/``cross_v``) splits; the RG-LRU's
    convolution tails and states by width; the mLSTM's states by heads and
    its convolution tail by width, the sLSTM's states by channel."""
    def plan(key):
        return tp_plan(params[key][0], mesh, cfg) if params.get(key) else {}

    def on(split, axis, *keys):
        return {k: axis for k in keys} if split else {}

    if cfg.family == "hybrid":
        g, t = plan("groups"), plan("tail")
        return {**on(g.get("attn/attn"), 3, "k", "v"), **on(g.get("rg1"), -1, "conv1", "h1"),
                **on(g.get("rg2"), -1, "conv2", "h2"), **on(t.get(""), -1, "tail_conv",
                                                             "tail_h")}
    if cfg.family == "ssm":
        g = plan("groups")
        return {**on(g.get("m"), 2, "m"), **on(g.get("m"), -1, "mconv"),
                **on(g.get("s"), 2, "s")}
    if cfg.family == "encdec":
        d = plan("dec_blocks")
        return {**on(d.get("attn"), 3, "k", "v"), **on(d.get("cross"), 3, "cross_k", "cross_v")}
    return on(plan("layers").get("attn"), 3, "k", "v")


def _cache_shardings(mesh, cache_spec, model_axes: Dict[str, int]):
    """The dense cache: every ``[L, B, ...]`` leaf batch over the batch axes
    and, where :func:`_cache_model_axes` names its entry, that axis over
    ``model`` (a tuple entry's leaves alike); scalars replicated. (The
    reference's ``cache_pspec`` may put the sequence over ``model`` instead;
    the port's layers keep their cache at their share of heads or width,
    never the sequence.)"""
    ba = shd._entry(batch_axes(mesh))

    def one(leaf, axis):
        nd = leaf.dim() if isinstance(leaf, torch.Tensor) else 0
        if nd < 2:
            return NamedSharding(mesh, (None,) * nd)
        spec = [None, ba] + [None] * (nd - 2)
        if axis is not None:
            spec[axis] = "model"
        if not shd._divides(tuple(leaf.shape), tuple(spec), mesh):
            spec[1] = None  # a batch that does not divide: whole, the heads still split
        spec = tuple(spec)
        if not shd._divides(tuple(leaf.shape), spec, mesh):
            spec = (None,) * nd
        return NamedSharding(mesh, spec)

    return {k: (tuple(one(t, model_axes.get(k)) for t in v) if isinstance(v, tuple)
                else one(v, model_axes.get(k)))
            for k, v in cache_spec.items()}


@dataclasses.dataclass
class _Leaf:
    """How one stacked leaf's optimizer state is laid out on this rank."""

    path: str
    stacked: bool
    shape: Tuple[int, ...]  # the whole stacked leaf's
    param_spec: Tuple  # the rank's parameter block, stacked form
    state_spec: Tuple  # its 32-bit state (and gradient) block
    flat: Optional[Tuple[str, ...]]  # 8-bit: the axes of its blocks' chunk, () whole
    halves: int = 1  # the parts of its model-split dim, each cut alike (NamedSharding)


def _zero1_spec(shape, spec, mesh) -> Tuple:
    """The reference's ZeRO-1 layout: ``spec`` plus ``data`` on the first
    free axis that divides (``spec`` itself where none does)."""
    data = mesh.shape.get("data", 1)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if data > 1:
        for ax, n in enumerate(shape):
            if parts[ax] is None and n % data == 0:
                parts[ax] = "data"
                break
    out = tuple(parts)
    return out if shd._divides(shape, out, mesh) else tuple(spec)


def _leaf_plans(param_flat_meta: Dict[str, List], stacked_set: set,
                port_sh: Dict[str, NamedSharding], mesh, state_bits: int) -> Dict[str, _Leaf]:
    """Per stacked leaf: the rank's parameter block (the port's sharding)
    and the reference's optimizer layout (``_opt_shardings``): the
    reference's parameter spec where it divides, plus ZeRO-1's ``data``
    (a halves leaf's 32-bit state follows its parameter's block, part by
    part); 8-bit moments in whole blocks over the first of ``(data,
    model)``, ``data``, ``model`` that divides them, where the rank holds
    the whole leaf, else whole on every rank."""
    plans = {}
    whole8 = []
    for path, leaves in param_flat_meta.items():
        stacked = path in stacked_set
        shape = ((len(leaves),) if stacked else ()) + tuple(leaves[0].shape)
        nd = len(shape)
        ref = shd.param_spec_for_path(path, nd, stacked and path.split("/")[0] in shd.STACKED_PREFIXES)
        if not shd._divides(shape, ref, mesh):
            ref = (None,) * nd
        mine = port_sh[path].spec
        mine = ((None,) + tuple(mine)) if stacked else tuple(mine)
        state = _zero1_spec(shape, ref, mesh)
        flat = None
        if state_bits == 8:
            nb = -(-math.prod(shape) // _BLOCK)
            flat = ()
            if all(e is None for e in mine):
                for axes in (("data", "model"), ("data",), ("model",)):
                    if all(a in mesh.shape for a in axes) and nb % mesh.extent(axes) == 0 \
                            and mesh.extent(axes) > 1:
                        flat = axes
                        break
            if not flat and _ranks(mesh) > 1:
                whole8.append(path)
        plans[path] = _Leaf(path, stacked, shape, mine, state, flat, port_sh[path].halves)
    if whole8:
        _log.info("8-bit AdamW state kept whole on every rank: %s", ", ".join(whole8))
    return plans


def _opt_shardings(mesh, opt_spec, plans: Dict[str, _Leaf]):
    """The tree of :class:`NamedSharding` of the optimizer state (the
    reference's ``_opt_shardings``, with :func:`_leaf_plans`' 8-bit rule)."""
    out: Dict = {"step": NamedSharding(mesh, ())}
    per: Dict = {}
    for path, plan in plans.items():
        st = _get_path(opt_spec["per_param"], path)
        node = {}
        for key, v in st.items():
            if isinstance(v, Q8):
                axes = plan.flat or None
                spec = (shd._entry(axes),) if axes else (None,)
                node[key] = Q8(NamedSharding(mesh, spec), NamedSharding(mesh, spec))
            elif plan.flat is not None:  # the 8-bit path's f32 master: whole
                node[key] = NamedSharding(mesh, (None,) * len(plan.shape))
            else:
                node[key] = NamedSharding(mesh, plan.state_spec, plan.halves)
        _set_path(per, path, node)
    out["per_param"] = per
    return out


# ------------------------------------------------------ ZeRO-1 optimizer
def _model_only(plan: _Leaf) -> List[int]:
    """Axes the state splits over ``model`` where the rank's parameter is
    whole."""
    return [ax for ax, (p, s) in enumerate(zip(plan.param_spec, plan.state_spec))
            if "model" in _names(s) and "model" not in _names(p)]


def _data_axis(plan: _Leaf) -> Optional[int]:
    axes = [ax for ax, s in enumerate(plan.state_spec) if "data" in _names(s)]
    return axes[0] if axes else None


def _narrow(t: torch.Tensor, ax: int, mesh, names) -> torch.Tensor:
    step = t.shape[ax] // mesh.extent(names)
    return t.narrow(ax, mesh.index(names) * step, step)


def _cut_axis(plan: _Leaf) -> Optional[int]:
    """The axis the rank's parameter block is cut on over ``model``."""
    axes = [ax for ax, p in enumerate(plan.param_spec) if "model" in _names(p)]
    return axes[0] if axes else None


def _gather_model(t: torch.Tensor, plan: _Leaf, mesh) -> torch.Tensor:
    """The whole leaf from the ranks' parameter blocks over ``model`` (a
    halves leaf's parts put back in order: ``[a_0 .. a_m | b_0 .. b_m]``)."""
    cut = _cut_axis(plan)
    if cut is None:
        return t
    t = shd.all_gather(t, mesh, "model", cut)
    if plan.halves > 1:
        m, n = mesh.extent("model"), t.shape[cut]
        t = t.unflatten(cut, (m, plan.halves, n // (m * plan.halves))).transpose(cut, cut + 1)
        t = t.flatten(cut, cut + 2)
    return t


def _narrow_model(t: torch.Tensor, plan: _Leaf, mesh) -> torch.Tensor:
    """The rank's parameter block over ``model`` of the whole leaf ``t``."""
    cut = _cut_axis(plan)
    if cut is None:
        return t
    return shd.shard_tensor(t, tuple("model" if ax == cut else None for ax in range(t.dim())),
                            mesh, plan.halves).contiguous()


def _reduce(g: torch.Tensor, plan: _Leaf, mesh) -> torch.Tensor:
    """The sum over the batch axes of the rank's gradient block, on the
    optimizer state's layout."""
    ba = batch_axes(mesh)
    if plan.flat is not None:  # 8-bit: the whole leaf's sum, then its chunk
        g = _gather_model(shd.all_reduce(g, mesh, ba), plan, mesh)
        return _chunk(g.reshape(-1), plan, mesh)
    for ax in _model_only(plan):
        g = _narrow(g, ax, mesh, "model")
    if "pod" in mesh.axis_names:
        g = shd.all_reduce(g, mesh, "pod")
    ax = _data_axis(plan)
    if ax is not None:
        return shd.reduce_scatter(g, mesh, "data", ax)
    return shd.all_reduce(g, mesh, ba) if "pod" not in mesh.axis_names else \
        shd.all_reduce(g, mesh, "data")


def _chunk_range(plan: _Leaf, mesh) -> Tuple[int, int]:
    n = math.prod(plan.shape)
    if not plan.flat:
        return 0, n
    nb = -(-n // _BLOCK)
    per = nb // mesh.extent(plan.flat) * _BLOCK
    lo = mesh.index(plan.flat) * per
    return lo, min(lo + per, n)


def _chunk(flat: torch.Tensor, plan: _Leaf, mesh) -> torch.Tensor:
    lo, hi = _chunk_range(plan, mesh)
    return flat[lo:hi]


def _state_block(leaves: List[torch.Tensor], plan: _Leaf, mesh) -> torch.Tensor:
    """The rank's optimizer-state block of the stacked leaf of ``leaves``
    (its parameter block), copying no more than that block."""
    if plan.flat is not None:
        p = _gather_model(_stack(leaves, plan.stacked), plan, mesh)
        return _chunk(p.reshape(-1), plan, mesh)
    data_ax = _data_axis(plan)
    if plan.stacked and data_ax == 0:  # ZeRO-1 over layers: this rank's layers alone
        n = len(leaves) // mesh.extent("data")
        leaves, data_ax = leaves[mesh.index("data") * n:][:n], None
    off = 1 if plan.stacked else 0

    def cut(t):
        for ax in _model_only(plan):
            t = _narrow(t, ax - off, mesh, "model")
        return t if data_ax is None else _narrow(t, data_ax - off, mesh, "data")

    return _stack([cut(t) for t in leaves], plan.stacked)


def _whole(u: torch.Tensor, plan: _Leaf, mesh) -> torch.Tensor:
    """The whole stacked leaf from the ranks' 8-bit chunks of it."""
    n = math.prod(plan.shape)
    if plan.flat:
        lo, hi = _chunk_range(plan, mesh)
        per = -(-n // _BLOCK) // mesh.extent(plan.flat) * _BLOCK
        u = shd.all_gather(torch.cat([u, u.new_zeros(per - (hi - lo))]), mesh, plan.flat, 0)
    return u[:n].reshape(plan.shape)


def _param_block(u: torch.Tensor, plan: _Leaf, mesh) -> torch.Tensor:
    """The rank's parameter block again from its updated state block."""
    if plan.flat is not None:
        return _narrow_model(_whole(u, plan, mesh), plan, mesh)
    ax = _data_axis(plan)
    if ax is not None:
        u = shd.all_gather(u, mesh, "data", ax)
    for ax in _model_only(plan):
        u = shd.all_gather(u, mesh, "model", ax)
    return u


def _master_block(st: Dict, plan: _Leaf, mesh):
    """8-bit moments keep a whole master (see :func:`_opt_shardings`): its
    chunk."""
    if plan.flat is None or "master" not in st:
        return st
    st = dict(st)
    st["master"] = _chunk(st["master"].reshape(-1), plan, mesh)
    return st


def _zero1_update(plans: Dict[str, _Leaf], params_flat: Dict[str, List],
                  grads: Dict[str, torch.Tensor], opt_state, ocfg: AdamWConfig, mesh):
    """AdamW on the rank's ZeRO-1 blocks, one stacked leaf at a time,
    written into the leaves of ``params_flat`` and into ``opt_state``: both
    are donated, as the reference's step donates them, so a step holds one
    copy of the parameters and of the state. Returns ``(params_flat,
    opt_state)``."""
    step = opt_state["step"]
    new_step = None
    for path, plan in plans.items():
        st = _get_path(opt_state["per_param"], path)
        new_block, new = adamw_update(
            {"p": _state_block(params_flat[path], plan, mesh)}, {"p": grads[path]},
            {"step": step, "per_param": {"p": _master_block(st, plan, mesh)}}, ocfg)
        new_step = new["step"]
        full = _param_block(new_block["p"], plan, mesh)
        for leaf, value in zip(params_flat[path], full.unbind(0) if plan.stacked else [full]):
            leaf.copy_(value)
        for key, value in new["per_param"]["p"].items():
            if key == "master" and plan.flat is not None:
                value = _whole(value, plan, mesh)
            for dst, src in (zip(st[key], value) if isinstance(value, Q8) else
                             [(st[key], value)]):
                dst.copy_(src)
        del new_block, new, full
    if new_step is not None:
        step.copy_(new_step)
    return params_flat, opt_state


def _rows_of_micros(cfg, mesh, batch_spec: Dict, accum: int) -> List[slice]:
    """:func:`_micro_rows` of a train step's batch. An MoE model whose
    batch divides over the batch axes but whose microbatch does not is
    refused: there the reference's layer leaves its EP region for GSPMD's
    global path."""
    rows = next(iter(batch_spec.values())).shape[0]
    nb = mesh.extent(batch_axes(mesh))
    if cfg.is_moe and rows % nb == 0 and accum > 1 and not _micro_major(rows, accum, mesh):
        raise shd.EPRegionError(f"{cfg.name}: a microbatch of {rows // accum} rows does not "
                                f"divide over the batch axes ({nb} ranks)")
    return _micro_rows(rows, accum, mesh)


def _micro(batch: Dict, rows: List[slice]) -> List[Dict]:
    """The rank's microbatches: its block's rows ``rows[m]`` of microbatch
    ``m`` (:func:`_micro_rows`)."""
    return [{k: v[sl] for k, v in batch.items()} for sl in rows]


def _grad_step(loss_fn: Callable, params_flat: Dict[str, List], plans: Dict[str, _Leaf],
               micros: List, mesh):
    """Loss and gradients over the microbatches, each microbatch's
    gradients reduced onto the state layout (f32 sum when ``accum > 1``,
    then averaged, as the reference's scan)."""
    leaves = [t for path in plans for t in params_flat[path]]
    acc, total, extra = None, None, None
    for mb in micros:
        loss, aux = loss_fn(mb)
        gl = torch.autograd.grad(loss, leaves)
        it = iter(gl)
        red = {}
        for path, plan in plans.items():
            g = _stack([next(it) for _ in params_flat[path]], plan.stacked)
            red[path] = _reduce(g, plan, mesh)
        del gl
        loss = loss.detach()
        if len(micros) == 1:
            return red, loss, aux
        red = {k: v.float() for k, v in red.items()}
        acc = red if acc is None else {k: acc[k] + red[k] for k in red}
        total = loss if total is None else total + loss
        extra = aux if extra is None else {k: extra[k] + v for k, v in aux.items()}
    n = len(micros)
    return ({k: v / n for k, v in acc.items()}, total / n,
            {k: v / n for k, v in extra.items()})


def tree_gradients(cfg, params, batch: Dict, mesh=None):
    """``(loss, grads)``: the bundle's ``train_loss`` of ``batch`` at
    ``params`` (any family's tree; under ``mesh`` this rank's blocks of both)
    and its gradients in ``params``' structure — under a mesh this rank's
    contributions to the global loss's, each parameter's on the rank's
    share of it."""
    from ..core.tree import tree_leaves, tree_map, tree_unflatten

    def trained(t):
        return isinstance(t, torch.Tensor) and t.is_floating_point()

    live = tree_map(lambda t: t.detach().requires_grad_() if trained(t) else t, params)
    with _rules(mesh):
        loss, _ = get_model(cfg).train_loss(live, batch)
    leaves = tree_leaves(live)
    gs = iter(torch.autograd.grad(loss, [t for t in leaves if trained(t)], allow_unused=True))
    grads = []
    for t in leaves:
        g = next(gs) if trained(t) else t
        grads.append(torch.zeros_like(t) if g is None else g)
    return loss.detach(), tree_unflatten(live, grads)


def _requires_grad(flat: Dict[str, List]) -> Dict[str, List]:
    return {p: [t.detach().requires_grad_() for t in leaves] for p, leaves in flat.items()}


# -------------------------------------------------------------- builders
def build_step(cfg, shape, mesh=None, *, train_mode: str = "auto", precision: str = "auto",
               avg_bits: float = 2.25, accum: int = 1, state_bits: int = 32) -> StepArtifacts:
    """The reference's ``build_step``: the step of ``shape``'s kind for
    ``cfg`` on ``mesh`` (None: one process)."""
    if mesh is None:
        mesh = _one_rank()
    bundle = get_model(cfg)
    step_kind, kwargs = bundle.input_specs(shape)
    meta: Dict = {"arch": cfg.name, "shape": shape.name, "kind": step_kind}
    if step_kind == "train":
        if train_mode == "auto":
            train_mode = "otp" if cfg.name.startswith("kimi") else "full"
        if accum == 0:
            accum = ACCUM.get(cfg.name, 1)
        meta["train_mode"] = train_mode
        if train_mode == "otp":
            return _build_otp_train(cfg, mesh, bundle, kwargs, meta, avg_bits, accum)
        return _build_full_train(cfg, mesh, bundle, kwargs, meta, accum, state_bits)
    if precision == "auto":
        precision = "quant" if cfg.is_moe else "bf16"
    meta["precision"] = precision
    if step_kind == "prefill":
        return _build_prefill(cfg, mesh, bundle, kwargs, meta, precision, avg_bits)
    return _build_decode(cfg, mesh, bundle, kwargs, meta, precision, avg_bits)


def _train_layout(params_spec, mesh, cfg, state_bits: int):
    """``(plans, param shardings)`` of a trained tree."""
    p_sh = _param_shardings(params_spec, mesh, cfg) if isinstance(params_spec, dict) else \
        _replicated(mesh, params_spec)
    port_sh = {path: specs[0] for path, specs in stack_tree(p_sh).items()}
    return _leaf_plans(stack_tree(params_spec), stacked_paths(params_spec), port_sh, mesh,
                       state_bits), p_sh


def _opt_spec(params_spec, ocfg: AdamWConfig):
    return adamw_init(_stacked_meta(stack_tree(params_spec), stacked_paths(params_spec)), ocfg)


def _build_full_train(cfg, mesh, bundle, kwargs, meta, accum, state_bits):
    params_spec = bundle.param_shapes()
    ocfg = AdamWConfig(state_bits=state_bits, master=(cfg.dtype == "bfloat16"))
    opt_spec = _opt_spec(params_spec, ocfg)
    batch_spec = kwargs["batch"]
    meta["accum"] = accum
    rows = _rows_of_micros(cfg, mesh, batch_spec, accum)
    plans, p_sh = _train_layout(params_spec, mesh, cfg, state_bits)

    def gradients(params, batch):
        flat = _requires_grad(stack_tree(params))
        live = unstack_tree(params, flat)

        def loss_fn(mb):
            with _rules(mesh):
                return bundle.train_loss(live, mb)

        micros = _micro(batch, rows)
        grads, loss, _ = _grad_step(loss_fn, flat, plans, micros, mesh)
        return loss, grads, flat

    def train_step(params, opt_state, batch):
        loss, grads, flat = gradients(params, batch)
        with torch.no_grad():
            _zero1_update(plans, flat, grads, opt_state, ocfg, mesh)
        return params, opt_state, loss

    return StepArtifacts(name="train_step", fn=train_step,
                         arg_specs=(params_spec, opt_spec, batch_spec),
                         in_shardings=(p_sh, _opt_shardings(mesh, opt_spec, plans),
                                       _batch_shardings(mesh, batch_spec)),
                         donate_argnums=(0, 1), meta=meta,
                         grads=lambda params, batch: gradients(params, batch)[:2])


def _otp_loss_fn(cfg, mesh, student, frozen, draws, lam: float = 1.0) -> Callable:
    """Eq. 14 on a microbatch: ``KL(teacher ‖ student)`` over the global
    batch plus ``λ · mask_l1 / L``, the student sampling its masks from this
    rank's rows of ``draws`` (the microbatch's uniforms ``[T, k]``, the same
    for every layer, as the reference's one key)."""
    from ..models import layers as L
    from ..models import transformer as tf

    ba = batch_axes(mesh)
    emb = frozen.get("unembed", frozen["embed"])

    def loss_fn(tokens):
        b, s = tokens["tokens"].shape
        u = draws
        if _ranks(mesh) > 1:  # this rank's tokens' rows of the microbatch's draws
            u = draws.reshape(-1, s, draws.shape[-1]).narrow(
                0, mesh.index(ba) * b, b).reshape(-1, draws.shape[-1])
        with _rules(mesh):
            hs, mask_l1, _ = tf.forward_hidden(student, tokens["tokens"], cfg, otp_rng=u,
                                               otp_tau=1.0)
            with torch.no_grad():
                ht, _, _ = tf.forward_hidden(frozen, tokens["tokens"], cfg, use_otp=False)
            kl = L.chunked_kl(hs, ht, emb, cfg.logits_chunk, cfg.vocab_size)
        loss = kl + lam * mask_l1 / cfg.num_layers
        return loss, {"kl": kl.detach(), "mask_l1": mask_l1.detach()}

    return loss_fn


def otp_gradients(cfg, mesh, otp_params, frozen, batch: Dict, draws: torch.Tensor):
    """``(loss, kl, grads)`` of the OTP step on one microbatch: the routers'
    gradients (a list like ``otp_params``) summed over the batch axes, whole
    on every rank (``mesh=None``: one process)."""
    mesh = mesh or _one_rank()
    live = [{k: v.detach().requires_grad_() for k, v in o.items()} for o in otp_params]
    student = dict(frozen, layers=[dict(p, otp=o) for p, o in zip(frozen["layers"], live)])
    loss, aux = _otp_loss_fn(cfg, mesh, student, frozen, draws)(batch)
    leaves = [t for o in live for t in o.values()]
    gs = iter(torch.autograd.grad(loss, leaves))
    ba = batch_axes(mesh)
    grads = [{k: shd.all_reduce(next(gs), mesh, ba) for k in o} for o in live]
    return loss.detach(), aux["kl"], grads


def _build_otp_train(cfg, mesh, bundle, kwargs, meta, avg_bits, accum=1):
    """OTP distillation on the frozen compressed backbone (paper Eq. 14)."""
    frozen_spec = spec_mod.make_compressed_moe_params(cfg, avg_bits)
    otp_spec = spec_mod.make_otp_stacked(cfg, concrete=False)
    ocfg = OTP_ADAMW
    opt_spec = _opt_spec(otp_spec, ocfg)
    batch_spec = {"tokens": kwargs["batch"]["tokens"]}
    meta["accum"] = accum
    rows = _rows_of_micros(cfg, mesh, batch_spec, accum)
    plans, p_sh = _train_layout(otp_spec, mesh, cfg, 32)

    def otp_train_step(otp_params, opt_state, frozen, batch, draws):
        flat = _requires_grad(stack_tree(otp_params))
        live = unstack_tree(otp_params, flat)
        student = dict(frozen, layers=[dict(p, otp=o) for p, o in zip(frozen["layers"], live)])
        loss_fn = _otp_loss_fn(cfg, mesh, student, frozen, draws)
        micros = _micro(batch, rows)
        grads, loss, aux = _grad_step(loss_fn, flat, plans, micros, mesh)
        with torch.no_grad():
            _zero1_update(plans, flat, grads, opt_state, ocfg, mesh)
        return otp_params, opt_state, loss, aux["kl"]

    f_sh = _param_shardings(frozen_spec, mesh, cfg)
    return StepArtifacts(name="otp_train_step", fn=otp_train_step,
                         arg_specs=(otp_spec, opt_spec, frozen_spec, batch_spec,
                                    torch.empty((batch_spec["tokens"].shape[0] // accum
                                                 * batch_spec["tokens"].shape[1], cfg.top_k),
                                                device="meta")),
                         in_shardings=(p_sh, _opt_shardings(mesh, opt_spec, plans), f_sh,
                                       _batch_shardings(mesh, batch_spec),
                                       NamedSharding(mesh, (None, None))),
                         donate_argnums=(0, 1), meta=meta)


def _serve_params_spec(cfg, bundle, precision, avg_bits):
    if precision == "bf16":
        return bundle.param_shapes()
    if cfg.is_moe:
        return spec_mod.make_compressed_moe_params(cfg, avg_bits)
    return spec_mod.quantize_dense_param_tree(bundle.param_shapes(), cfg)


def _build_prefill(cfg, mesh, bundle, kwargs, meta, precision, avg_bits):
    params_spec = _serve_params_spec(cfg, bundle, precision, avg_bits)
    batch_spec = kwargs["batch"]

    def prefill_step(params, batch):
        with torch.no_grad(), _rules(mesh):
            return bundle.prefill(params, batch)

    with torch.no_grad():
        cache_spec, logits_spec = bundle.prefill(bundle.param_shapes(), batch_spec)
    cache_sh = _cache_shardings(mesh, on_meta(cache_spec),
                                _cache_model_axes(params_spec, mesh, cfg))
    return StepArtifacts(name="prefill_step", fn=prefill_step,
                         arg_specs=(params_spec, batch_spec),
                         in_shardings=(_param_shardings(params_spec, mesh, cfg),
                                       _batch_shardings(mesh, batch_spec)),
                         donate_argnums=(), meta=meta,
                         out_shardings=(cache_sh, NamedSharding(mesh, (None,) * logits_spec.dim())))


def _position(pos, cache) -> int:
    """A decode position as the host int the port's layers index with: the
    tensor's value, or, on ``meta`` (the dry run: shapes, no values), the
    cache's last row — the reference's spec is a traced scalar that its
    step writes at, so the work does not depend on it."""
    if isinstance(pos, torch.Tensor) and pos.device.type == "meta":
        return int(cache["k"].shape[2]) - 1 if "k" in cache else 0
    return int(pos)


def _build_decode(cfg, mesh, bundle, kwargs, meta, precision, avg_bits):
    params_spec = _serve_params_spec(cfg, bundle, precision, avg_bits)
    cache_spec = kwargs["cache"]  # its shapes do not depend on the precision
    token_spec, pos_spec = kwargs["token"], kwargs["pos"]

    def decode_fn(params, cache, token, pos):
        with torch.no_grad(), _rules(mesh):
            return bundle.decode_step(params, dict(cache, pos=_position(cache["pos"], cache)),
                                      token, _position(pos, cache))

    c_sh = _cache_shardings(mesh, cache_spec, _cache_model_axes(params_spec, mesh, cfg))
    return StepArtifacts(name="decode_step", fn=decode_fn,
                         arg_specs=(params_spec, cache_spec, token_spec, pos_spec),
                         in_shardings=(_param_shardings(params_spec, mesh, cfg), c_sh,
                                       _batch_shardings(mesh, {"token": token_spec})["token"],
                                       NamedSharding(mesh, ())),
                         donate_argnums=(1,), meta=meta, out_shardings=(c_sh, None))


# ------------------------------------------------------------ arguments
def _cut(node, sh):
    """``node`` cut by its tree of :class:`NamedSharding` (Q8 and tuple
    nodes field by field)."""
    if isinstance(sh, NamedSharding):
        if not isinstance(node, torch.Tensor):
            return node
        return shd.shard_tensor(node, sh.spec, sh.mesh, sh.halves).contiguous()
    if isinstance(node, dict):
        return {k: _cut(v, sh[k]) for k, v in node.items()}
    if isinstance(node, Q8):
        return Q8(*(_cut(v, s) for v, s in zip(node, sh)))
    if isinstance(node, (list, tuple)):
        return type(node)(_cut(v, s) for v, s in zip(node, sh))
    return node


def _cut_batch(batch: Dict, sh: Dict, accum: int) -> Dict:
    out = {}
    for k, v in batch.items():
        spec = sh[k].spec
        if spec and spec[0] is not None and _micro_major(v.shape[0], accum, sh[k].mesh):
            view = v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
            cut = shd.shard_tensor(view, (None,) + tuple(spec), sh[k].mesh)
            out[k] = cut.reshape(-1, *v.shape[1:]).contiguous()
        else:
            out[k] = _cut(v, sh[k])
    return out


def _own(node):
    """A copy of a tree's tensors: the blocks a step's donated arguments
    are written into (never the caller's whole tensors)."""
    if isinstance(node, torch.Tensor):
        return node.clone()
    if isinstance(node, dict):
        return {k: _own(v) for k, v in node.items()}
    if isinstance(node, Q8):
        return Q8(*map(_own, node))
    if isinstance(node, list):
        return [_own(v) for v in node]
    return node


def shard_args(art: StepArtifacts, args: Tuple, mesh, cfg) -> Tuple:
    """This rank's blocks of ``art.fn``'s whole arguments ``args``:
    parameter trees by ``shard_params(..., cfg)`` (expert and tensor
    parallelism), every other argument by ``art.in_shardings`` — a batch
    with ``accum > 1`` by microbatch; the donated ones (``donate_argnums``)
    as copies of their own."""
    accum = art.meta.get("accum", 1)
    if art.name == "train_step":
        params, opt, batch = args
        return (_own(shard_params(params, mesh, cfg)), _own(_cut(opt, art.in_shardings[1])),
                _cut_batch(batch, art.in_shardings[2], accum))
    if art.name == "otp_train_step":
        otp, opt, frozen, batch, draws = args
        return (_own(otp), _own(_cut(opt, art.in_shardings[1])), shard_params(frozen, mesh, cfg),
                _cut_batch(batch, art.in_shardings[3], accum), draws)
    if art.name == "prefill_step":
        params, batch = args
        return shard_params(params, mesh, cfg), _cut(batch, art.in_shardings[1])
    params, cache, token, pos = args
    return (shard_params(params, mesh, cfg), _cut(cache, art.in_shardings[1]),
            _cut(token, art.in_shardings[2]), pos)



def init_opt_blocks(art: StepArtifacts, device) -> Dict:
    """This rank's blocks of ``art``'s initial optimizer state, made on
    ``device`` without the whole state: zero moments (an f32 model's; a
    master copy holds the parameters and is refused here)."""
    spec, sh = art.arg_specs[1], art.in_shardings[1]

    def make(node, s):
        if isinstance(node, dict):
            if "master" in node:
                raise ValueError("init_opt_blocks: a master copy is the parameters, not zeros")
            return {k: make(v, s[k]) for k, v in node.items()}
        if isinstance(node, Q8):
            return Q8(*(make(v, t) for v, t in zip(node, s)))
        block = shd.shard_tensor(node, s.spec, s.mesh)
        return torch.zeros(block.shape, dtype=node.dtype, device=device)

    return make(spec, sh)
