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
  attention's chunk sweep, the xLSTM recurrences) is written as a
  :func:`scan`. On any other device it is the plain loop. On ``meta`` it
  runs two iterations, the second standing for all but the first
  (:func:`trips` multiplies its ops' counts, in the forward and in the
  backward), and the op counter's account (:func:`accounting`) is charged
  what the iterations not run would hold: their outputs, the bytes they
  keep for the backward, their share of the summed gradients of the loop's
  shared inputs. A checkpointed region (:func:`recompute`) recomputes its
  forward inside its own backward, so its loops' bytes are charged and let
  go there, as the real recomputation holds them.

The models, the kernel wrappers and ``parallel.sharding``'s collectives
read this module; on any other device than ``meta`` nothing here acts.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

__all__ = ["Work", "accounting", "count_meta", "nbytes", "recompute", "recording", "scan",
           "trips"]


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
#: the op counter's multiplier: ops run on ``meta`` inside a :func:`scan`'s
#: second iteration stand for that many runs
_TRIPS: List[int] = [1]
#: the op counter's account while a dry run counts, else None: ``live`` and
#: ``peak`` bytes, ``hold(n)`` / ``release(n)`` of bytes no storage stands
#: for, ``traffic(n)`` HBM bytes of ops not dispatched
_ACCOUNT: List = [None]


def trips() -> int:
    """How many runs each op dispatched now stands for (1 outside a
    :func:`scan`)."""
    return _TRIPS[-1]


@contextlib.contextmanager
def accounting(account):
    """One dry run's count: the multiplier starts at 1 and :func:`scan`
    charges ``account`` the bytes of the iterations it does not run. Both
    are put back as they were on the way out, whatever happened inside; a
    run that ends with a scan's multiplier still open (its backward ran the
    scan's exit but not its entry) raises, so that it cannot multiply what
    is counted after it."""
    saved = _TRIPS[:], _ACCOUNT[:]
    _TRIPS[:], _ACCOUNT[:] = [1], [account]
    try:
        yield account
        if _TRIPS != [1]:
            raise RuntimeError(f"a scan's multiplier is still open ({_TRIPS}): "
                               "its backward ran its exit but not its entry")
    finally:
        _TRIPS[:], _ACCOUNT[:] = saved


class _Begin(torch.autograd.Function):
    """A scan's inputs: its backward runs after every node of the scan (all
    made after this one), when the real loop's backward has let go of what
    the iterations kept; the bytes held for the iterations not run go then."""

    @staticmethod
    def forward(ctx, held, *xs):
        ctx.held = held
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        account = _ACCOUNT[-1]
        if account is not None and ctx.held[0]:
            account.release(ctx.held[0])
        return (None,) + gs


class _Enter(torch.autograd.Function):
    """The second iteration's inputs: its backward closes the iteration's
    multiplier ``n`` (the engine runs the iteration's nodes, all made after
    this one and before :class:`_Exit`, between the two). The gradient of a
    shared input that reaches it stands for ``n`` iterations' gradients,
    which the real loop adds up one by one: the traffic of those ``n - 1``
    additions is charged (the scan's first iteration makes the last one)."""

    @staticmethod
    def forward(ctx, n, n_carry, *xs):
        ctx.n, ctx.n_carry = n, n_carry
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        _TRIPS.pop()
        account = _ACCOUNT[-1]
        if account is not None and ctx.n > 1:
            shared = nbytes(*(g for g in gs[ctx.n_carry:] if g is not None))
            account.traffic(3 * shared * (ctx.n - 1) * trips())
        return (None, None) + gs


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, *ys):
        ctx.n = n
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *gs):
        _TRIPS.append(_TRIPS[-1] * ctx.n)
        return (None,) + gs


def scan(n: int, body: Callable, carry: Tuple = (), shared: Tuple = (),
         stack: Optional[int] = None) -> Tuple[Tuple, Optional[torch.Tensor]]:
    """``for i in range(n): carry, y = body(i, carry, *shared)``: the last
    carry (a tuple of tensors) and, with ``stack`` a dim, the ``n`` outputs
    ``y`` stacked on it (``torch.stack``; without it ``y`` is None). ``body``
    reads every tensor that needs a gradient through ``carry`` or
    ``shared``, never by closure.

    On ``meta`` tensors (the dry run's) with ``n > 2``, two iterations run:
    the first as itself, the second (``i = 1``) standing for the other
    ``n - 1`` — the op counter multiplies its ops, forward and backward.
    What the real loop would hold is charged to the counter's account:
    the peak of the last iteration above the ``n - 2`` iterations' growth
    not run, their outputs (one ``empty`` stand-in, which the stacking reads
    as it would read them), the bytes they keep for the backward until the
    scan's backward is done, and the traffic of summing their gradients of
    the shared inputs. The real loop's iterations must be alike."""
    xs = tuple(carry) + tuple(shared)
    if n <= 2 or not any(x.is_meta for x in xs):
        ys = []
        for i in range(n):
            carry, y = body(i, carry, *shared)
            ys.append(y)
        return carry, (None if stack is None else torch.stack(ys, stack))
    account = _ACCOUNT[-1]
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in xs)
    held = [0]
    nc = len(carry)
    if grad:
        xs = _Begin.apply(held, *xs)
        carry, shared = xs[:nc], xs[nc:]
    carry, y1 = body(0, carry, *shared)
    live1 = account.live if account is not None else 0
    if account is not None:
        outer_peak, account.peak = account.peak, live1
    xs = tuple(carry) + tuple(shared)
    if grad:
        xs = _Enter.apply(n - 1, nc, *xs)
    _TRIPS.append(_TRIPS[-1] * (n - 1))
    try:
        carry, y2 = body(1, xs[:nc], *xs[nc:])
    finally:
        _TRIPS.pop()
    del xs
    if grad:
        out = _Exit.apply(n - 1, *carry, *(() if y2 is None else (y2,)))
        carry, y2 = out[:nc], (None if y2 is None else out[nc])
    grow = account.live - live1 if account is not None else 0
    if account is not None:
        account.peak = max(outer_peak, account.peak + (n - 2) * max(grow, 0))
    if grad and grow > nbytes(y2):
        held[0] = (grow - nbytes(y2)) * (n - 2)
        account.hold(held[0])
    ys = None
    if stack is not None:
        rest = torch.empty((*y2.shape[:stack], n - 2, *y2.shape[stack:]), dtype=y2.dtype,
                           device=y2.device)
        ys = torch.cat([y1.unsqueeze(stack), y2.unsqueeze(stack), rest], dim=stack)
    return carry, ys


class _Recompute(torch.autograd.Function):
    """:func:`recompute`'s region: the forward without a graph, the inputs
    kept; the backward runs the forward again with one and differentiates
    through it (its scans charge and let go of their bytes there)."""

    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.save_for_backward(*args)
        with torch.no_grad():
            out = fn(*args)
        return out if isinstance(out, torch.Tensor) else tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        args = [a.detach().requires_grad_(a.requires_grad) for a in ctx.saved_tensors]
        with torch.enable_grad():
            outs = _outputs(ctx.fn(*args))
        pairs = [(o, g) for o, g in zip(outs, gs) if o.requires_grad]
        wrt = [a for a in args if a.requires_grad]
        if not (pairs and wrt):
            return (None,) * (len(args) + 1)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True))
        return (None,) + tuple(next(got) if a.requires_grad else None for a in args)


def _outputs(out) -> Tuple:
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def recompute(fn: Callable, *args: torch.Tensor):
    """``fn(*args)`` (a tuple of tensors out), its intermediates recomputed
    in the backward: on ``meta`` the dry run's stand-in for a non-reentrant
    ``torch.utils.checkpoint``, whose recomputation would run a
    :func:`scan`'s forward again outside any backward that could let go of
    its bytes. Returns what ``fn`` returns (a tensor or a tuple)."""
    return _Recompute.apply(fn, *args)
