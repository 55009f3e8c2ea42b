"""Count one step's work on ``meta`` tensors (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference compiles a step and parses the optimized HLO text: dot FLOPs,
HBM traffic at fusion granularity, collective operand bytes, with while-loop
bodies multiplied by their trip counts. PyTorch has no HLO and no compiler
between the step and the card: eager PyTorch runs the step op by op, each
op a kernel that reads its operands from HBM and writes its result there.
So :func:`analyze_step` runs the step itself, on ``meta`` tensors (shapes
and dtypes, no values, no memory) under a ``TorchDispatchMode`` that sees
every ATen op the card would run, and counts:

* FLOPs of each op from ``torch.utils.flop_counter``'s registry (the
  matmuls, attention and convolutions; ``2·M·K·N`` a product), plus each
  hand-written kernel's own work (a wrapper on ``meta`` records its launch
  and its :class:`~repro_torch.launch.counting.Work`), by op and by dtype.
  Loops run in Python, every iteration, so no trip count is recovered;
* HBM bytes op by op: a non-view op reads its inputs and writes its
  outputs once; views, reshapes, ``expand`` and metadata ops are free; a
  ``copy_`` or ``.contiguous()`` costs its bytes. An indexing op (a gather
  or an embedding lookup) reads as many bytes of its source as it writes,
  and an indexed write reads and writes the rows it touches. This differs
  from the reference's ``_NO_TRAFFIC_OPS``, which treats copies,
  transposes and converts as free because XLA fuses them into their
  neighbours on a TPU: here each is a kernel of its own;
* collective operand bytes by kind
  (:class:`~repro_torch.parallel.sharding.CollectiveLedger`), under the
  reference's names. On a mesh without process groups nothing is sent; the
  stand-in's copy of the operand counts as the collective's HBM traffic,
  as the reference counts a collective's operand and result;
* ``peak_bytes``: the highest sum of live storages made during the step
  (views share their base's storage; a storage that autograd saves for the
  backward stays live until the graph lets it go).

A loop that would run its body thousands of times on ``meta`` (the
attention's chunk sweep, the xLSTM recurrences) is a
:func:`~repro_torch.launch.counting.scan`, which runs two iterations there
and charges what the others would count and hold, forward and backward:
on the reduced families a train step counts on ``meta`` what it counts on
CPU tensors, where every iteration runs (FLOPs equal, peak and bytes within
1.2 %, ``tests/test_torch_op_analysis.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..parallel import sharding as shd
from . import counting

__all__ = ["OpSummary", "analyze_step"]

aten = torch.ops.aten

#: ops that only allocate or relabel (no HBM traffic of their own)
_FREE = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
         aten.new_empty.default, aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.set_.source_Storage_storage_offset,
         aten.resize_.default, aten.detach.default, aten.alias.default}
#: indexing reads: the source rows they gather, as many bytes as they write
_GATHERS = {aten.index.Tensor, aten.gather.default, aten.embedding.default,
            aten.index_select.default}
#: indexed writes: read-modify-write of the rows they touch
_SCATTERS = {aten.index_put_.default, aten.index_put.default, aten.scatter_.src,
             aten.scatter.src, aten.scatter_add_.default, aten.scatter_add.default,
             aten.index_add_.default, aten.index_add.default, aten.scatter_.value,
             aten.scatter.value, aten.index_copy_.default, aten.index_fill_.int_Scalar}


@dataclasses.dataclass
class OpSummary:
    """One step's counts on one rank (the shapes of ``meta`` are the rank's
    blocks), with :class:`~repro.launch.hlo_analysis.HloSummary`'s fields
    where the quantity is the same."""

    flops: float
    hbm_bytes: float
    collective_bytes: Dict[str, float]
    num_collectives: Dict[str, int]
    dot_flops_by_comp: Dict[str, float]  # FLOPs by op (ATen op or kernel)
    flops_by_dtype: Dict[str, float]
    launches: Dict[str, int]  # hand-written kernel launches by kernel
    peak_bytes: int
    #: ``(kind, operand bytes, axes, calls)`` of each collective asked for
    collective_events: list = dataclasses.field(default_factory=list, repr=False)
    result: Any = dataclasses.field(default=None, repr=False)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops: Dict[str, float] = {}
        self.by_dtype: Dict[str, float] = {}
        self.hbm = 0.0
        self.live = 0
        self.peak = 0
        self.seen: set = set()  # storages made in the step, alive
        self.args: set = set()  # storages the step was given, alive

    def add_flops(self, name: str, dtype: torch.dtype, flops: float) -> None:
        flops *= counting.trips()
        if flops:
            self.flops[name] = self.flops.get(name, 0.0) + flops
            key = str(dtype).replace("torch.", "")
            self.by_dtype[key] = self.by_dtype.get(key, 0.0) + flops

    def hold(self, n: int) -> None:
        """Bytes a scan's iterations not run would keep alive."""
        self.live += n
        self.peak = max(self.peak, self.live)

    def release(self, n: int) -> None:
        self.live -= n

    def traffic(self, n: float) -> None:
        """HBM bytes of ops a scan's iterations not run would dispatch."""
        self.hbm += n

    def work(self):
        """What is counted so far: ``(FLOPs by op, FLOPs by dtype, HBM
        bytes)``, a copy."""
        return dict(self.flops), dict(self.by_dtype), self.hbm

    def charge(self, before, after, scale: float) -> None:
        """Add ``scale`` times the work counted between two :meth:`work`
        readings (a recomputation's iterations not run)."""
        for mine, a, b in zip((self.flops, self.by_dtype), before, after):
            for key, v in b.items():
                mine[key] = mine.get(key, 0.0) + scale * (v - a.get(key, 0.0))
        self.hbm += scale * (after[2] - before[2])

    def _freed(self, key: int, n: int) -> None:
        self.seen.discard(key)
        self.live -= n

    def _track(self, ins, outs) -> None:
        """Storages first met as an op's input are the step's arguments
        (not counted); those first met as an output are made in the step."""
        for t in ins:
            st = t.untyped_storage()
            key = id(st)
            if key not in self.seen and key not in self.args:
                self.args.add(key)
                weakref.finalize(st, self.args.discard, key)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self.seen or key in self.args:
                continue
            n = st.nbytes()
            self.seen.add(key)
            self.live += n
            weakref.finalize(st, self._freed, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        hbm = self.hbm
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func._overloadpacket
        if packet in self.registry:
            dtype = ins[0].dtype if ins else torch.float32
            self.add_flops(str(packet).replace("aten.", ""), dtype,
                           float(self.registry[packet](*args, **kwargs, out_val=out)))
        if func in _FREE or func.is_view:
            pass
        elif func in _GATHERS:
            self.hbm += 2 * sum(map(_bytes, outs)) + sum(_bytes(t) for t in ins[1:])
        elif func in _SCATTERS:
            self.hbm += 2 * sum(_bytes(t) for t in ins[1:])
        elif func is aten.copy_.default:
            self.hbm += _bytes(args[0]) + _bytes(args[1])
        else:  # an in-place op reads and writes its destination
            self.hbm += sum(_bytes(t) for t in {id(t): t for t in ins}.values())
            self.hbm += sum(_bytes(t) for t in {id(t): t for t in outs}.values())
        self.hbm = hbm + (self.hbm - hbm) * counting.trips()
        self._track(ins, outs)
        return out


def analyze_step(fn, args, kwargs: Optional[Dict] = None) -> OpSummary:
    """Run ``fn(*args, **kwargs)`` (``meta`` tensors: the rank's blocks)
    and count its FLOPs, HBM bytes, collectives, kernel launches and peak
    live bytes; ``result`` holds what it returned. Each call counts from 1×
    (:func:`~repro_torch.launch.counting.accounting`), whatever an earlier
    one left, and raises if ``fn`` leaves a scan's multiplier open."""
    counter = _Counter()
    ledger = shd.CollectiveLedger()
    sink: list = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(shd.counting(ledger))
        stack.enter_context(counting.recording(sink))
        stack.enter_context(counting.accounting(counter))
        stack.enter_context(counter)
        result = fn(*args, **(kwargs or {}))
    launches: Dict[str, int] = {}
    for name, work, n in sink:
        launches[name] = launches.get(name, 0) + n
        counter.add_flops(name, work.dtype, work.flops * n)
        counter.hbm += work.bytes * n
    return OpSummary(
        flops=sum(counter.flops.values()), hbm_bytes=counter.hbm,
        collective_bytes=ledger.bytes, num_collectives=ledger.counts,
        dot_flops_by_comp=dict(counter.flops), flops_by_dtype=dict(counter.by_dtype),
        launches=launches, peak_bytes=counter.peak, collective_events=list(ledger.events),
        result=result)
