"""How a step run on ``meta`` tensors stands for the work the card would do.

The dry run (:mod:`repro_torch.launch.op_analysis`) runs a step on ``meta``
tensors: shapes and dtypes, no values, nothing launched. Two things of a
real run are then missing, and this module supplies them:

* **kernel launches.** A kernel wrapper given a ``meta`` tensor launches
  nothing: it returns its output's shape and dtype on ``meta`` and hands one
  launch's :class:`Work` (from the count function beside the wrapper, which
  ``chip_smoke.py``'s bounds read too) to :func:`count_meta`, which the op
  counter collects (:func:`recording`);
* **loop trips.** A loop that would run its body thousands of times (the
  attention's chunk sweep, the xLSTM recurrences) runs it once inside
  :func:`repeated`, which multiplies the counts of its ops (:func:`trips`)
  in the forward and in the backward, and charges the bytes the runs not
  made would keep for the backward (:func:`accounting`).

The models, the kernel wrappers and ``parallel.sharding``'s collectives
read this module; on any other device than ``meta`` nothing here acts.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, NamedTuple

import torch

__all__ = ["Work", "accounting", "count_meta", "nbytes", "recording", "repeated", "trips"]


class Work(NamedTuple):
    """One kernel launch's work: the bytes it must move (each operand read
    once, the result written once), its arithmetic (a product and a sum
    count two) and the dtype of its products."""

    bytes: float
    flops: float
    dtype: torch.dtype


def nbytes(*ts) -> int:
    """Bytes of tensors (a tuple: its tensors; None: nothing)."""
    out = 0
    for t in ts:
        for x in (t if isinstance(t, tuple) else (t,)):
            if x is not None:
                out += x.numel() * x.element_size()
    return out


_SINK: contextvars.ContextVar = contextvars.ContextVar("kernel_work", default=None)


@contextlib.contextmanager
def recording(sink: List):
    """Collect ``(kernel, Work, launches)`` of every launch counted on
    ``meta`` into ``sink``."""
    token = _SINK.set(sink)
    try:
        yield sink
    finally:
        _SINK.reset(token)


def count_meta(name: str, work: Work) -> None:
    """A wrapper's launch on ``meta`` tensors: no kernel runs; its work goes
    to the sink of :func:`recording`, if one is open, with the launches it
    stands for (:func:`trips`)."""
    sink = _SINK.get()
    if sink is not None:
        sink.append((name, work, trips()))


# The multiplier and the account are plain module state, not context
# variables: the autograd engine runs a region's backward nodes, which push
# and pop them, outside the context of the forward that made them.
#: the op counter's multiplier: ops run on ``meta`` inside :func:`repeated`
#: stand for that many runs
_TRIPS: List[int] = [1]
#: the op counter's account of live bytes while a dry run counts (``live``,
#: ``hold(n)``, ``release(n)``), else None
_ACCOUNT: List = [None]


def trips() -> int:
    """How many runs each op dispatched now stands for (1 outside
    :func:`repeated`)."""
    return _TRIPS[-1]


@contextlib.contextmanager
def accounting(account):
    """One dry run's count: the multiplier starts at 1 and :func:`repeated`
    regions charge the bytes their ``n`` runs would keep for the backward to
    ``account``. Both are put back as they were on the way out, whatever
    happened inside; a run that ends with a region's multiplier still open
    (its backward ran the region's exit but not its entry) raises, so that
    it cannot multiply what is counted after it."""
    saved = _TRIPS[:], _ACCOUNT[:]
    _TRIPS[:], _ACCOUNT[:] = [1], [account]
    try:
        yield account
        if _TRIPS != [1]:
            raise RuntimeError(f"a repeated region's multiplier is still open ({_TRIPS}): "
                               "its backward ran its exit but not its entry")
    finally:
        _TRIPS[:], _ACCOUNT[:] = saved


class _TripsEnter(torch.autograd.Function):
    """A repeated region's inputs: its backward closes the region's
    multiplier (the engine runs the region's nodes, all created after this
    one and before :class:`_TripsExit`, between the two) and lets go of the
    bytes charged for the runs not made."""

    @staticmethod
    def forward(ctx, held, *xs):
        ctx.held = held
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        _TRIPS.pop()
        account = _ACCOUNT[-1]
        if account is not None and ctx.held[0]:
            account.release(ctx.held[0])
        return (None,) + gs


class _TripsExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, *ys):
        ctx.n = n
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *gs):
        _TRIPS.append(_TRIPS[-1] * ctx.n)
        return (None,) + gs


def repeated(n: int, fn, *xs: torch.Tensor):
    """``fn(*xs)`` (tensors in, a tuple of tensors out) run once on ``meta``
    tensors for a loop that runs it ``n`` times: the dry run's op counter
    counts each of its ops ``n`` times, in the forward and, where a graph is
    recorded, in the backward, and holds ``n`` times the bytes one run keeps
    for the backward until the region's backward is done. The reference's
    analyzer recovers such multipliers as while-loop trip counts; an eager
    step on ``meta`` runs a loop's body once instead of ``n`` times over (a
    32k-token attention sweep is ~4096 chunk pairs a layer)."""
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in xs)
    held = [0]
    account = _ACCOUNT[-1]
    if grad:
        xs = _TripsEnter.apply(held, *xs)
    before = account.live if account is not None else 0
    _TRIPS.append(_TRIPS[-1] * n)
    try:
        ys = fn(*xs)
    finally:
        _TRIPS.pop()
    if grad:
        if account is not None and n > 1:
            kept = account.live - before - nbytes(*ys)
            if kept > 0:
                held[0] = kept * (n - 1)
                account.hold(held[0])
        ys = _TripsExit.apply(n, *ys)
    return ys
