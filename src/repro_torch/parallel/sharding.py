"""Sharding rules and the mesh of ranks (port of ``repro/parallel/sharding.py``).

JAX runs a mesh as SPMD in one process; the port runs one process per rank.
A :class:`Mesh` holds the axis names (``("data", "model")`` or ``("pod",
"data", "model")``), their extents, this rank's coordinate on each axis and
one process group per axis (and one over the batch axes together). Inside a
mesh:

* activations are this rank's block of the batch axes (what the reference's
  shard_map regions receive through ``in_specs=P(batch_axes, ...)``),
  replicated over ``model``;
* each rank holds, of the expert buckets, only its rows and, where
  :func:`tp_split` splits them, its share of each tensor-parallel pair of
  :data:`TP_PAIRS` (heads of attention and cross-attention, columns / rows
  of the MLPs and of the recurrent and xLSTM blocks) and, where
  :func:`vocab_split` splits them, its vocabulary rows of the embeddings
  (:func:`repro_torch.parallel.ep_shardmap.shard_params`); every other
  parameter whole;
* :func:`shard` is an identity: torch has no GSPMD to pass a constraint to.
  The rules (:func:`activation_rules`, :data:`_PARAM_RULES`) are kept as
  data. A spec is a tuple with one entry per dim — an axis name, a tuple of
  names or None, normalized as ``PartitionSpec`` does (a lone name for a
  one-name tuple) — and compares equal to ``tuple(PartitionSpec(...))``.

:func:`all_reduce` (the reference's ``psum``), :func:`all_gather` (its
tiled ``all_gather``) and :func:`reduce_scatter` (its ``psum_scatter``) run
over the group of the named axes, and differentiate with Megatron's
pairing: an ``all_reduce`` at a region's exit passes its gradient through,
:func:`enter` (an identity) sums the gradients of a replicated tensor that
feeds rank-partial work, ``all_gather`` and ``reduce_scatter`` are each
other's backward. A collective the group's backend lacks
(:data:`COLLECTIVES`) is composed of those it has; one it does not take on
CUDA tensors (:data:`DEVICE_COLLECTIVES`) goes through host memory — both
chosen by the backend before the call, never on a failure; :data:`ROUTES`
records each route taken. Under ``torch.no_grad`` nothing is recorded and
the forward values are those of the plain collectives.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.packing import PackedTensor
from ..launch.counting import trips

__all__ = [
    "DEVICE_COLLECTIVES",
    "EPRegionError",
    "Mesh",
    "NamedSharding",
    "ROUTES",
    "activation_rules",
    "COLLECTIVES",
    "CollectiveLedger",
    "all_gather",
    "all_reduce",
    "batch_axes",
    "build_mesh",
    "cache_pspec",
    "counting",
    "current_mesh",
    "enter",
    "make_param_shardings",
    "manual_region",
    "model_axis_size",
    "param_spec_for_path",
    "reduce_scatter",
    "shard",
    "shard_tensor",
    "shard_tree",
    "sharding_rules",
    "TP_PAIRS",
    "TPPair",
    "tp_kind",
    "tp_pairs",
    "tp_share",
    "tp_split",
    "tp_width",
    "vocab_share",
    "vocab_split",
]

class EPRegionError(ValueError):
    """An MoE layer under a mesh that the expert-parallel region cannot
    take. The reference leaves the region for GSPMD's global path there; a
    rank of the port holds only its share of the experts and cannot compute
    the global layout, so it raises, naming the condition that failed."""


_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx", default=None)

Spec = Tuple


class Mesh:
    """Axis names and extents, the global ranks in row-major order over the
    axes (``ranks``, the reference mesh's ``devices``), this rank's
    coordinate (``coord``, None on a rank outside the mesh or on a mesh made
    for its shape only) and the process groups (:meth:`group`)."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int], *,
                 ranks: Optional[np.ndarray] = None, coord: Optional[Sequence[int]] = None,
                 groups: Optional[Dict] = None):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in axis_sizes)
        self.shape = dict(zip(self.axis_names, sizes))
        self.ranks = (np.arange(int(np.prod(sizes))) if ranks is None
                      else np.asarray(ranks)).reshape(sizes)
        self.coord = None if coord is None else dict(zip(self.axis_names, map(int, coord)))
        self._groups = groups or {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coord={self.coord})"

    def index(self, names) -> int:
        """This rank's coordinate over ``names`` (a name or a tuple of
        names, the first the most significant), as a shard index."""
        idx = 0
        for n in _names(names):
            idx = idx * self.shape[n] + self.coord[n]
        return idx

    def extent(self, names) -> int:
        return int(np.prod([self.shape[n] for n in _names(names)]))

    def group(self, names):
        """The process group of this rank's line along ``names``."""
        key = _names(names)
        if key not in self._groups:
            raise KeyError(f"mesh {self.shape}: no process group over {key}")
        return self._groups[key]


def _names(names) -> Tuple[str, ...]:
    return (names,) if isinstance(names, str) else tuple(names)


def build_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int],
               blocks: Optional[Sequence[np.ndarray]] = None) -> Mesh:
    """A mesh over the initialised default process group. ``blocks`` are
    the global ranks of each mesh of this shape (default: one mesh over
    ranks ``0 .. prod(sizes) - 1``); the caller gets the one holding its
    rank, or, outside all of them, a mesh with ``coord`` None. Every rank of
    the default group calls this, in the same order (``new_group`` is
    collective), and gets groups over each axis, over the batch axes and
    over ``(data, model)``."""
    import torch.distributed as dist

    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(axis_names)
    if blocks is None:
        blocks = [np.arange(int(np.prod(sizes)))]
    blocks = [np.asarray(b).reshape(sizes) for b in blocks]
    if any(b.max() >= dist.get_world_size() for b in blocks):
        raise ValueError(f"mesh {dict(zip(names, sizes))}: ranks beyond the world size "
                         f"{dist.get_world_size()}")
    me = dist.get_rank()
    axis_sets = [(n,) for n in names]
    ba = batch_axes_of(names)
    if len(ba) > 1:
        axis_sets.append(ba)
    if "data" in names and "model" in names:  # ZeRO-1's 8-bit state chunks
        axis_sets.append(("data", "model"))
    mine, groups, coord = None, {}, None
    for b in blocks:
        for axes in axis_sets:
            pos = [names.index(n) for n in axes]
            rest = [i for i in range(len(names)) if i not in pos]
            lines = np.transpose(b, rest + pos).reshape(-1, int(np.prod([sizes[i] for i in pos])))
            for line in lines:
                g = dist.new_group(ranks=[int(r) for r in line])
                if me in line:
                    groups[axes] = g
        if me in b:
            mine = b
            coord = [int(c[0]) for c in np.nonzero(b == me)]
    return Mesh(names, sizes, ranks=mine if mine is not None else blocks[0], coord=coord,
                groups=groups if mine is not None else None)


def batch_axes_of(axis_names) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names else ("data",)


def batch_axes(mesh) -> Tuple[str, ...]:
    return batch_axes_of(mesh.axis_names)


def _entry(names):
    """A spec entry as ``PartitionSpec`` normalizes it: one name alone."""
    return names[0] if isinstance(names, tuple) and len(names) == 1 else names


def activation_rules(mesh, sequence_parallel: bool = True) -> Dict[str, Spec]:
    """The reference's Megatron-SP activation specs (kept as data: the port
    places no activation by them)."""
    ba = _entry(batch_axes(mesh))
    seq = "model" if sequence_parallel else None
    return {
        "act_btd": (ba, seq, None),
        "act_full": (ba, None, None),
        "moe_ed": ("model", None),
        "moe_ecd": ("model", "data", None),
        "moe_elcd": ("model", None, "data", None),
        "moe_tke": (ba, None),
        "logits_btv": (ba, None, "model"),
    }


@contextlib.contextmanager
def sharding_rules(mesh: Mesh, rules: Optional[Dict[str, Spec]] = None):
    """Make ``mesh`` the current mesh: the MoE layers route into the
    expert-parallel regions while it is set."""
    token = _CTX.set({"mesh": mesh, "rules": rules or activation_rules(mesh)})
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def manual_region():
    """Inside a region's body: no current mesh (the body's tensors are
    this rank's own)."""
    token = _CTX.set(None)
    try:
        yield
    finally:
        _CTX.reset(token)


def _divides(shape, spec: Spec, mesh) -> bool:
    for dim, names in zip(shape, spec):
        if names is None:
            continue
        size = int(np.prod([mesh.shape[n] for n in _names(names)]))
        if dim % size != 0:
            return False
    return True


def model_axis_size() -> int:
    """Model-axis extent of the current mesh (1 outside one)."""
    ctx = _CTX.get()
    if ctx is None:
        return 1
    return int(ctx["mesh"].shape.get("model", 1))


def current_mesh() -> Optional[Mesh]:
    ctx = _CTX.get()
    return None if ctx is None else ctx["mesh"]


def shard(x, name: str):
    """The reference's sharding constraint: an identity in the port."""
    return x


# ------------------------------------------------------------ param specs
_IDX = r"(?:/\d+)*$"
_PARAM_RULES = [
    (r"attn/w[qkv]/w" + _IDX, (None, "model")),
    (r"attn/wo/w" + _IDX, ("model", None)),
    (r"cross/w[qkv]/w" + _IDX, (None, "model")),
    (r"cross/wo/w" + _IDX, ("model", None)),
    (r"(mlp|shared|ffn)/w_(gate|up)/w" + _IDX, (None, "model")),
    (r"(mlp|shared|ffn)/w_down/w" + _IDX, ("model", None)),
    (r"experts/w_(gate|up|down)$", ("model", None, None)),
    (r"moe_ce/.*", ("model", None, None)),
    (r"router/w$", (None, None)),
    (r"^(embed|unembed)$", ("model", None)),
    (r"(proj_in|gate_in|wq|wk|wv|wa|wx|w_z|w_o|w_if)/w" + _IDX, (None, "model")),
    (r"(proj_out|out)/w" + _IDX, ("model", None)),
    (r"ffn/proj_in/w" + _IDX, (None, "model")),
    (r"ffn/proj_out/w" + _IDX, ("model", None)),
]


def param_spec_for_path(path: str, ndim: int, stacked: bool) -> Spec:
    """The spec of the leaf at ``path`` (``/``-joined; packed children end
    in ``/<index>``), a leading None for a stacked layer dim, padded or cut
    to ``ndim``; replicated where no rule matches."""
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            parts = list(spec)
            if stacked:
                parts = [None] + parts
            while len(parts) < ndim:
                parts.append(None)
            return tuple(parts[:ndim])
    return (None,) * ndim


STACKED_PREFIXES = ("blocks", "groups", "enc_blocks", "dec_blocks")


# ------------------------------------------------------ tensor parallelism
@dataclasses.dataclass(frozen=True)
class TPPair:
    """A tensor-parallel pair of a block: its column-parallel leaves, its
    row-parallel leaf (None: the block gathers its columns itself), the
    column leaves made of two halves ``[a | b]`` (each half cut alike, so a
    rank holds its columns of ``a`` and the matching ones of ``b``) and the
    probe ``(leaf, axis)`` whose extent on a whole node is the pair's
    width — the dim split over ``model``. ``unit`` says what a share must
    hold whole: ``"heads"`` (``cfg``'s query and KV heads both divide;
    ``"query_heads"``: the query heads) or ``"columns"``."""

    cols: Tuple[str, ...]
    row: Optional[str]
    probe: Tuple[str, int]
    unit: str = "columns"
    halves: Tuple[str, ...] = ()


#: every tensor-parallel pair kind of the port's blocks, in the order a node
#: is matched (a node holding every column and row leaf of a kind is one):
#: attention and whisper's ``cross`` by heads; the SwiGLU MLPs (dense,
#: shared experts) by F; recurrentgemma's RG-LRU by its width (``conv`` and
#: ``lam`` stay whole, read at the rank's columns); the mLSTM by heads
#: (``[u | z]`` and ``[ĩ | f̃]`` halves); the sLSTM by channel (``[ĩ | f̃]``
#: halves; its states all-gathered); xLSTM's gated FFN by F (``[u | v]``)
TP_PAIRS: Dict[str, TPPair] = {
    "attn": TPPair(("wq", "wk", "wv"), "wo", ("wq", 1), unit="heads"),
    "mlp": TPPair(("w_gate", "w_up"), "w_down", ("w_down", 0)),
    "rglru": TPPair(("gate_in", "proj_in", "wa", "wx"), "proj_out", ("proj_out", 0)),
    "mlstm": TPPair(("proj_in", "wq", "wk", "wv", "w_if"), "proj_out", ("proj_out", 0),
                    unit="query_heads", halves=("proj_in", "w_if")),
    "slstm": TPPair(("w_z", "w_o", "w_if"), None, ("w_z", 1), halves=("w_if",)),
    "ffn": TPPair(("proj_in",), "proj_out", ("proj_out", 0), halves=("proj_in",)),
}


def tp_kind(node) -> Optional[str]:
    """The :data:`TP_PAIRS` kind a block's node is (it holds every leaf of
    the pair, each as ``{"w": ...}``), or None."""
    if not isinstance(node, dict):
        return None
    for kind, pair in TP_PAIRS.items():
        leaves = pair.cols + ((pair.row,) if pair.row else ())
        if all(isinstance(node.get(n), dict) and "w" in node[n] for n in leaves):
            return kind
    return None


def tp_pairs(block, prefix: str = ""):
    """``(path, kind, node)`` of every tensor-parallel pair in a block (a
    layer's dict; ``path`` relative to it, ``""`` the block itself), found
    by :func:`tp_kind` — the same walk for every family's blocks."""
    out = []
    if not isinstance(block, dict):
        return out
    kind = tp_kind(block)
    if kind is not None:
        out.append((prefix, kind, block))
    pair = TP_PAIRS.get(kind)
    own = set(pair.cols) | {pair.row} if pair else set()
    for key, child in block.items():
        if key not in own and isinstance(child, dict):
            out += tp_pairs(child, f"{prefix}/{key}" if prefix else key)
    return out


def tp_width(node, kind: str) -> int:
    """The width of a whole node of ``kind`` (its probe's extent)."""
    leaf, axis = TP_PAIRS[kind].probe
    return int(node[leaf]["w"].shape[axis])


def tp_split(node: Dict, kind: str, model: int, cfg, width: int) -> bool:
    """Whether a pair of ``kind`` and ``width`` splits over ``model`` ranks:
    the one rule that :func:`~repro_torch.parallel.ep_shardmap.shard_params`
    cuts by, the step builders' specs follow and the layers hold their
    shares to. The width must divide, and with it ``cfg``'s heads where the
    unit is heads; a PackedTensor row leaf only where the share falls on its
    quant-group and packed-byte boundaries; halves only on float leaves.
    ``node`` may be whole or a rank's share: the rule reads ``width`` and
    ``cfg``, and of ``node`` only its leaves' types."""
    pair = TP_PAIRS[kind]
    if model <= 1 or width % model:
        return False
    if pair.unit in ("heads", "query_heads") and cfg.num_heads % model:
        return False
    if pair.unit == "heads" and cfg.num_kv_heads % model:
        return False
    if any(isinstance(node[n]["w"], PackedTensor) for n in pair.halves):
        return False
    row = node[pair.row]["w"] if pair.row else None
    if isinstance(row, PackedTensor):
        share = width // model
        return share % row.group == 0 and share % row.pack_rows == 0
    return True


def vocab_split(vocab: int, model: int) -> bool:
    """Whether the embeddings split their vocabulary rows over ``model``
    (the reference's ``^(embed|unembed)$`` → ``P("model", None)`` where it
    divides)."""
    return model > 1 and vocab % model == 0


def _share_of(mesh: Optional["Mesh"], have: int, whole: int, what: str) -> Optional["Mesh"]:
    if mesh is None or have == whole:
        return None
    model = mesh.shape.get("model", 1)
    if have * model != whole:
        raise ValueError(f"{what} holds {have} of {whole} on model={model}, not the share "
                         f"shard_params cuts")
    return mesh


def tp_share(node: Dict, kind: str, width: int, cfg=None) -> Optional["Mesh"]:
    """The current mesh where ``node`` (a pair of ``kind`` whose whole width
    is ``width``) holds this rank's share under :func:`tp_split` — 1/model
    of its width, as ``shard_params`` cuts it —; None where it runs whole:
    no mesh, or whole weights (a pair that does not split). Raises for any
    other cut."""
    mesh = current_mesh()
    if mesh is None:
        return None
    leaf, axis = TP_PAIRS[kind].probe
    mesh = _share_of(mesh, int(node[leaf]["w"].shape[axis]), width, f"a {kind} node")
    if mesh is not None and not tp_split(node, kind, mesh.shape["model"], cfg, width):
        raise ValueError(f"a {kind} node is cut on model={mesh.shape['model']} where "
                         f"tp_split keeps it whole")
    return mesh


def vocab_share(emb: torch.Tensor, vocab: Optional[int]) -> Optional["Mesh"]:
    """The current mesh where ``emb`` holds this rank's rows of a
    ``vocab``-row embedding (:func:`vocab_split`); None where it is whole."""
    if vocab is None:
        return None
    return _share_of(current_mesh(), int(emb.shape[0]), vocab, "an embedding")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``). ``halves`` > 1
    marks a leaf whose ``model``-split dim is that many equal parts ``[a |
    b]``, each cut alike (:data:`TP_PAIRS`' halves): a rank's block holds its
    slice of every part, the same extent as the spec's contiguous block."""

    mesh: Mesh
    spec: Spec
    halves: int = 1


def _children(node):
    """``(key, child)`` pairs of an inner node of a parameter tree, in the
    reference's child order (a PackedTensor's ``data, scale, zero``, a
    CompressedExperts' ``slot_of_expert, arrays[, resident_map]``), or None
    for a leaf."""
    from ..core.compressed_moe import CompressedExperts  # it imports this module

    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if isinstance(node, PackedTensor):
        return list(enumerate((node.data, node.scale, node.zero)))
    if isinstance(node, CompressedExperts):
        kids = [node.slot_of_expert, node.arrays]
        if node.resident_map is not None:
            kids.append(node.resident_map)
        return list(enumerate(kids))
    return None


def make_param_shardings(mesh, params, stacked_prefixes=STACKED_PREFIXES):
    """The tree of :class:`NamedSharding` of ``params`` (dicts, lists and
    tuples as they are; a PackedTensor or CompressedExperts becomes the
    tuple of its children's): each leaf's :func:`param_spec_for_path`,
    replicated where a spec does not divide the dim. The port's per-layer
    trees (``layers/<l>/...``) have no stacked dim: pass
    ``stacked_prefixes=()``."""

    def one(node, path):
        kids = _children(node)
        if kids is not None:
            out = [one(v, f"{path}/{k}" if path else str(k)) for k, v in kids]
            if isinstance(node, dict):
                return dict(zip([k for k, _ in kids], out))
            return list(out) if isinstance(node, list) else tuple(out)
        stacked = any(path.startswith(pref) for pref in stacked_prefixes)
        shape = tuple(getattr(node, "shape", ()))
        nd = len(shape)
        spec = param_spec_for_path(path, nd, stacked)
        if not _divides(shape, spec, mesh):
            spec = (None,) * nd
        return NamedSharding(mesh, spec)

    return one(params, "")


def cache_pspec(mesh, cache_shape, prefer: str = "batch") -> Spec:
    """KV cache ``[L, B, S, Hkv, dh]`` spec: (batch → data, heads → model),
    heads that do not divide fall back to (batch → data, seq → model);
    long context (or a batch that does not divide) puts the sequence first."""
    bsz = int(np.prod([mesh.shape[a] for a in batch_axes(mesh)]))
    ba = _entry(batch_axes(mesh))
    model = mesh.shape.get("model", 1)
    data = mesh.shape.get("data", 1)
    l, b, s, h = cache_shape[:4]
    if prefer == "batch" and b % bsz == 0:
        if h % model == 0:
            return (None, ba, None, "model", None)
        if s % model == 0:
            return (None, ba, "model", None, None)
        return (None, ba, None, None, None)
    if s % data == 0 and h % model == 0:
        return (None, None, "data", "model", None)
    if s % (data * model) == 0:
        return (None, None, ("data", "model"), None, None)
    if s % data == 0:
        return (None, None, "data", None, None)
    return (None,) * len(cache_shape)


# ------------------------------------------------------ this rank's slices
def shard_tensor(x: torch.Tensor, spec: Spec, mesh: Mesh, halves: int = 1) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a view;
    a dim whose axes do not divide it raises); with ``halves`` > 1 the dim
    over ``model`` is cut part by part (:class:`NamedSharding`), a copy."""
    for dim, names in enumerate(spec):
        if names is None:
            continue
        n = mesh.extent(names)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {names} ({n})")
        if halves > 1 and "model" in _names(names):
            x = torch.cat([shard_tensor(part, tuple(names if d == dim else None
                                                    for d in range(x.dim())), mesh)
                           for part in x.chunk(halves, dim)], dim)
            continue
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(names) * step, step)
    return x


def shard_tree(tree, shardings):
    """This rank's blocks of a tree of whole tensors, cut by the matching
    tree of :class:`NamedSharding` (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s) for v, s in zip(tree, shardings))
    return shard_tensor(tree, shardings.spec, shardings.mesh)


# ------------------------------------------------------------ collectives
#: the collectives each backend has; any other is composed of those it has
#: (``reduce_scatter`` as an ``all_reduce`` and the rank's block of the sum)
COLLECTIVES = {"gloo": ("all_reduce", "all_gather"),
               "nccl": ("all_reduce", "all_gather", "reduce_scatter")}
#: the collectives each backend takes on CUDA tensors; any other goes
#: through host memory
DEVICE_COLLECTIVES = {"gloo": ("all_reduce",),
                      "nccl": ("all_reduce", "all_gather", "reduce_scatter")}
#: ``{(collective, backend, tensor device type): "direct" | "host" |
#: "composed"}`` of every call so far
ROUTES: Dict[Tuple[str, str, str], str] = {}


def _route(op: str, x: torch.Tensor, group) -> str:
    import torch.distributed as dist

    backend = str(dist.get_backend(group))
    if op not in COLLECTIVES.get(backend, ()):
        route = "composed"
    elif x.is_cuda and op not in DEVICE_COLLECTIVES.get(backend, ()):
        route = "host"
    else:
        route = "direct"
    ROUTES[(op, backend, x.device.type)] = route
    return route


class CollectiveLedger:
    """The collectives a step asks for, each ``(kind, operand bytes, axes,
    calls)`` as the reference's ``hlo_analysis`` counts an HLO collective:
    the kind by its name there (``all-reduce``, ``all-gather``,
    ``reduce-scatter`` — a reduce-scatter that gloo composes of an
    all-reduce is still one reduce-scatter) and the bytes of the operand
    this rank sends in (an all-gather its block, a reduce-scatter the whole
    tensor it reduces)."""

    def __init__(self):
        self.events = []

    def record(self, kind: str, nbytes: int, axes: Tuple[str, ...], calls: int = 1) -> None:
        self.events.append((kind, int(nbytes), axes, calls))

    @property
    def bytes(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for kind, nbytes, _, calls in self.events:
            out[kind] = out.get(kind, 0.0) + nbytes * calls
        return out

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kind, _, _, calls in self.events:
            out[kind] = out.get(kind, 0) + calls
        return out


_LEDGER: contextvars.ContextVar = contextvars.ContextVar("collective_ledger", default=None)


@contextlib.contextmanager
def counting(ledger: CollectiveLedger):
    """Record every collective of :func:`all_reduce`, :func:`all_gather`,
    :func:`reduce_scatter` and their backwards into ``ledger``. On a mesh
    without process groups (one rank's view, :func:`~repro_torch.launch.mesh.production_view`)
    nothing is sent: each returns a tensor of its result's shape on the
    input's device (its values are not the collective's). On a mesh with
    groups the collectives run as they do outside."""
    token = _LEDGER.set(ledger)
    try:
        yield ledger
    finally:
        _LEDGER.reset(token)


def _counted(kind: Optional[str], x: torch.Tensor, mesh: Mesh, axes) -> bool:
    """Records ``kind`` on ``x`` in the current ledger; True where nothing
    is to be sent (counting on a mesh without process groups)."""
    ledger = _LEDGER.get()
    if ledger is None:
        return False
    if kind is not None:
        ledger.record(kind, x.numel() * x.element_size(), _names(axes), trips())
    return not mesh._groups


def _sum(x: torch.Tensor, mesh: Mesh, axes, kind: Optional[str] = "all-reduce") -> torch.Tensor:
    import torch.distributed as dist

    if _counted(kind, x, mesh, axes):
        return x.detach().clone(memory_format=torch.contiguous_format)
    group = mesh.group(axes)
    if _route("all_reduce", x, group) == "host":
        y = x.detach().to("cpu", copy=True)
        dist.all_reduce(y, group=group)
        return y.to(x.device)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


def _gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    if _counted("all-gather", x, mesh, axes):
        shape = list(x.shape)
        shape[dim] *= mesh.extent(axes)
        return x.new_zeros(shape)
    group = mesh.group(axes)
    src = x.detach().contiguous()
    if _route("all_gather", x, group) == "host":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.extent(axes))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    n = mesh.extent(axes)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide over "
                         f"{axes} ({n})")
    step = x.shape[dim] // n
    if _counted("reduce-scatter", x, mesh, axes):
        return x.detach().narrow(dim, mesh.index(axes) * step, step).contiguous()
    group = mesh.group(axes)
    route = _route("reduce_scatter", x, group)
    if route == "composed":
        return _sum(x, mesh, axes, kind=None).narrow(dim, mesh.index(axes) * step,
                                                     step).contiguous()
    src = x.detach().movedim(dim, 0).contiguous()
    if route == "host":
        src = src.cpu()
    out = src.new_empty((step,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous().to(x.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, backward):
        ctx.mesh, ctx.axes, ctx.backward = mesh, axes, backward
        return _sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "all_reduce":
            return _sum(g, ctx.mesh, ctx.axes), None, None, None
        return g, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, backward):
        ctx.mesh, ctx.axes, ctx.dim, ctx.backward = mesh, axes, dim, backward
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "split":
            step = g.shape[ctx.dim] // ctx.mesh.extent(ctx.axes)
            g = g.narrow(ctx.dim, ctx.mesh.index(ctx.axes) * step, step).contiguous()
            return g, None, None, None, None
        return _scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, *, backward: str = "identity") -> torch.Tensor:
    """The sum of ``x`` over the ranks of this rank's line along ``axes``
    (a new tensor; ``x`` is left as it is). Where a graph is recorded, its
    backward is Megatron's for a region's exit: the identity, the cotangent
    being the same on every rank of the line; ``backward="all_reduce"``
    sums the cotangents instead (jax's transpose of ``psum``), for a sum
    whose consumers differ by rank."""
    if mesh.extent(axes) == 1:
        return x
    if backward not in ("identity", "all_reduce"):
        raise ValueError(f"all_reduce backward {backward!r}")
    return _AllReduce.apply(x, mesh, axes, backward)


def enter(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``x`` as it is, where a tensor replicated over ``axes`` feeds work
    that each rank does a part of: the backward sums the ranks' partial
    gradients over ``axes`` (Megatron's ``f``)."""
    if mesh.extent(axes) == 1:
        return x
    return _Enter.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int, *,
               backward: str = "reduce_scatter") -> torch.Tensor:
    """The blocks of ``x`` of the ranks along ``axes``, concatenated along
    ``dim`` in their order on the axis. The backward gives this rank its
    block of the summed gradient (a reduce-scatter), the gathered tensor
    feeding work that each rank does a part of; ``backward="split"`` gives
    it its block of its own gradient, where what the gathered tensor feeds
    is replicated over ``axes`` (Megatron's ``g``), so every rank's
    cotangent is the same."""
    if mesh.extent(axes) == 1:
        return x
    if backward not in ("reduce_scatter", "split"):
        raise ValueError(f"all_gather backward {backward!r}")
    return _AllGather.apply(x, mesh, axes, dim, backward)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    along ``axes`` (ZeRO-1's gradient reduction). The backward all-gathers
    the blocks' gradients."""
    if mesh.extent(axes) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim)
