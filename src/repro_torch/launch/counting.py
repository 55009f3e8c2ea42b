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
  shared inputs, the gradients of their rows of the loop's ``xs``. A
  checkpointed region (:func:`checkpoint`) recomputes its forward inside
  its own backward, so its loops' bytes are charged there and let go with
  their backward, as the real recomputation holds them.

The models, the kernel wrappers and ``parallel.sharding``'s collectives
read this module; on any other device than ``meta`` only :func:`scan`'s
plain loop and :func:`checkpoint`'s ``torch.utils.checkpoint`` act.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["Work", "accounting", "checkpoint", "count_meta", "nbytes", "recording", "scan",
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
#: for, ``traffic(n)`` HBM bytes of ops not dispatched, ``work()`` /
#: ``charge(before, after, scale)`` to repeat what was counted
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
    made after this one), when the real loop's backward has used the
    gradients of the iterations' rows; the bytes held for those of the
    iterations not run go then (``held``: what those iterations keep for the
    backward, if not let go yet, and their rows' gradients)."""

    @staticmethod
    def forward(ctx, held, *xs):
        ctx.held = held
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        account = _ACCOUNT[-1]
        if account is not None and sum(ctx.held):
            account.release(sum(ctx.held))
        return (None,) + gs


class _Enter(torch.autograd.Function):
    """The second iteration's inputs (``n_carry`` carries, ``n_rows`` rows of
    the ``xs``, the shared inputs): its backward closes the iteration's
    multiplier ``n`` (the engine runs the iteration's nodes, all made after
    this one and before :class:`_Exit`, between the two). The gradient of a
    shared input that reaches it stands for ``n`` iterations' gradients,
    which the real loop adds up one by one: the traffic of those ``n - 1``
    additions is charged (the scan's first iteration makes the last one).
    By now the real loop's backward has let go of what the iterations it
    stands for kept, and made their rows' gradients, which it keeps until
    the ``xs``' backward reads them: the first go now, the second are held
    until :class:`_Begin`'s backward."""

    @staticmethod
    def forward(ctx, n, n_carry, n_rows, held, *xs):
        ctx.n, ctx.n_carry, ctx.n_rows, ctx.held = n, n_carry, n_rows, held
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        _TRIPS.pop()
        account = _ACCOUNT[-1]
        rows = ctx.n_carry + ctx.n_rows
        shared = nbytes(*(g for g in gs[rows:] if g is not None))
        if account is not None and ctx.held[0]:
            # the real loop's first addition of shared gradients (the sum,
            # the addend and the result at once) ran while the n - 2
            # iterations before it held what they kept: here the n - 2 held
            # and the first iteration's
            kept = ctx.held[0] // (ctx.n - 1)
            account.peak = max(account.peak, account.live - kept + 2 * shared)
            account.release(ctx.held[0])
            ctx.held[0] = 0
        if account is not None and ctx.n > 1:
            account.traffic(3 * shared * (ctx.n - 1) * trips())
            ctx.held[1] = nbytes(*(g for g in gs[ctx.n_carry:rows] if g is not None)) * (ctx.n - 1)
            account.hold(ctx.held[1])
        return (None,) * 4 + gs


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, *ys):
        ctx.n = n
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *gs):
        _TRIPS.append(_TRIPS[-1] * ctx.n)
        return (None,) + gs


class _Rows(torch.autograd.Function):
    """Rows 0 and 1 of a scan's ``xs`` tensor on ``meta``, where the real
    loop unbinds all its rows: the backward makes the tensor's gradient from
    the rows' as ``unbind``'s does (one tensor written, every row's
    gradient read)."""

    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        return x[0], x[1]

    @staticmethod
    def backward(ctx, *gs):
        out = torch.zeros(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        account = _ACCOUNT[-1]
        if account is not None:
            account.traffic(nbytes(out) * trips())
        return out


def scan(n: int, body: Callable, carry: Tuple = (), shared: Tuple = (),
         stack: Optional[int] = None, xs: Tuple = (),
         remat: bool = False) -> Tuple[Tuple, Optional[torch.Tensor]]:
    """``for i in range(n): carry, y = body(i, carry, *(x[i] for x in xs),
    *shared)``: the last carry (a tuple of tensors) and, with ``stack`` a dim,
    the ``n`` outputs ``y`` stacked on it (``torch.stack``; without it ``y``
    is None). ``body`` reads every tensor that needs a gradient through
    ``carry``, ``xs`` or ``shared``, never by closure.

    ``xs`` are tensors of ``n`` rows (dim 0), unbound once: iteration ``i``
    reads its rows as tensors of their own, so the backward writes each
    row's gradient once (a body that indexed a shared tensor would write a
    gradient of the whole tensor every iteration: O(n²) bytes). With
    ``remat`` each iteration runs under :func:`checkpoint`: the loop keeps
    its iterations' inputs and outputs, and the backward recomputes one
    iteration's intermediates at a time.

    On ``meta`` tensors (the dry run's) with ``n > 2``, two iterations run:
    the first as itself, the second (``i = 1``) standing for the other
    ``n - 1`` — the op counter multiplies its ops, forward and backward.
    What the real loop would hold is charged to the counter's account:
    the peak of the last iteration above the ``n - 2`` iterations' growth
    not run, their outputs (one ``empty`` stand-in, which the stacking reads
    as it would read them), the bytes they keep for the backward until the
    scan's backward is done, the gradients of their rows of ``xs``, and the
    traffic of summing their gradients of the shared inputs. The real
    loop's iterations must be alike."""
    step = body
    if remat:
        def step(i, c, *rest):
            return checkpoint(body, i, c, *rest)
    xs = tuple(xs)
    if n <= 2 or not any(x.is_meta for x in (*carry, *xs, *shared)):
        rows = [x.unbind(0) for x in xs]
        ys = []
        for i in range(n):
            carry, y = step(i, carry, *(r[i] for r in rows), *shared)
            ys.append(y)
        return carry, (None if stack is None else torch.stack(ys, stack))
    account = _ACCOUNT[-1]
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (*carry, *xs, *shared))
    rows = [_Rows.apply(x) if grad and x.requires_grad else (x[0], x[1]) for x in xs]
    held = [0, 0]
    region = _REGIONS[-1] if _REGIONS and grad else None
    again = region is not None and not isinstance(region, list)
    if again:  # a recomputation: charge the first run's scan
        held = next(region)
    elif region is not None:
        region.append(held)
        if _DROPPED:
            _DROPPED[-1].append(held)
    nc, nr = len(carry), len(xs)
    first, second = tuple(r[0] for r in rows), tuple(r[1] for r in rows)
    if grad:
        ins = _Begin.apply(held, *carry, *first, *second, *shared)
        carry, first = ins[:nc], ins[nc:nc + nr]
        second, shared = ins[nc + nr:nc + 2 * nr], ins[nc + 2 * nr:]
    del rows
    live0 = account.live if account is not None else 0
    work0 = account.work() if account is not None and again else None
    carry, y1 = step(0, carry, *first, *shared)
    live1 = account.live if account is not None else 0
    work1 = account.work() if work0 is not None else None
    if account is not None:
        outer_peak, account.peak = account.peak, live1
    try:
        ins = (*carry, *second, *shared)
        if grad:
            ins = _Enter.apply(n - 1, nc, nr, held, *ins)
        _TRIPS.append(_TRIPS[-1] * (n - 1))
        try:
            carry, y2 = step(1, ins[:nc], *ins[nc:])
        finally:
            _TRIPS.pop()
        del ins
        if grad:
            out = _Exit.apply(n - 1, *carry, *(() if y2 is None else (y2,)))
            carry, y2 = out[:nc], (None if y2 is None else out[nc])
        grow = account.live - live1 if account is not None else 0
        last_peak = account.peak if account is not None else 0
    except Exception:
        # ``torch.utils.checkpoint`` stops a recomputation once the region's
        # last saved tensor is made again, here in the second iteration: the
        # real loop stops in its last one, having run n - 1 iterations whole
        # (here the first, and the second's part counted n - 1 times) and
        # holding what they keep
        if account is not None:
            kept = (n - 2) * max(live1 - live0, 0) if again else 0
            account.peak = max(outer_peak, account.peak + kept)
            held[0] += kept
            account.hold(kept)
            if again:
                work2 = account.work()
                account.charge(work0, work1, n - 2)
                account.charge(work1, work2, -(n - 2) / (n - 1))
        raise
    if account is not None:
        account.peak = max(outer_peak, last_peak + (n - 2) * max(grow, 0))
    if grad and grow > nbytes(y2):
        kept = (grow - nbytes(y2)) * (n - 2)
        held[0] += kept
        account.hold(kept)
    ys = None
    if stack is not None:
        rest = torch.empty((*y2.shape[:stack], n - 2, *y2.shape[stack:]), dtype=y2.dtype,
                           device=y2.device)
        ys = torch.cat([y1.unsqueeze(stack), y2.unsqueeze(stack), rest], dim=stack)
    return carry, ys


def checkpoint(fn: Callable, *args):
    """``fn(*args)`` with its intermediates recomputed in the backward (the
    reference's ``jax.checkpoint``): a non-reentrant
    ``torch.utils.checkpoint``, on ``meta`` as on the card, where a graph is
    recorded through a tensor of ``args`` (trees of tensors and other
    values), else ``fn(*args)`` as it is. No RNG state is kept: no region
    the port checkpoints draws from torch's default generators. The
    recomputation runs in the context variables of the first run (the
    mesh of ``parallel.sharding.sharding_rules``, the ledgers), wherever
    autograd runs it.

    On ``meta`` the region is counted as the card runs it: its
    recomputation (triggered in the backward by the first saved tensor read,
    stopped after the last one is made again) counts at the multiplier of
    its first run, and the bytes a recomputed :func:`scan` holds for its
    iterations not run go with the first run's scan's backward."""
    leaves, spec = tree_flatten(args)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return fn(*args)
    # the tensors go to torch's checkpoint one by one: an argument that holds
    # tensors (a tuple, a dict) would be kept whole, its tensors with it,
    # where a nested region keeps its tensors only as its outer one's holders
    is_tensor = [isinstance(t, torch.Tensor) for t in leaves]
    others = [None if k else t for t, k in zip(leaves, is_tensor)]

    def flat(*ts):
        it = iter(ts)
        return fn(*tree_unflatten([next(it) if k else o for o, k in zip(others, is_tensor)],
                                  spec))

    return ckpt.checkpoint(_region(flat, any(t.is_meta for t in tensors)), *tensors,
                           use_reentrant=False, preserve_rng_state=False)


#: the checkpointed regions running on ``meta``, innermost last: a region's
#: first run lists the ``held`` accounts of its scans (a list), a
#: recomputation takes them back in the same order (an iterator)
_REGIONS: List = []
#: for each recomputation running, the ``held`` accounts of the scans of the
#: regions it runs for the first time: their graph is the recomputation's,
#: which autograd drops when it is done, and their bytes go with it
_DROPPED: List = []


def _region(fn: Callable, meta: bool) -> Callable:
    """``fn`` as :func:`checkpoint` runs it: first in the forward, then in
    each recomputation, in the first run's context."""
    ctx = contextvars.copy_context()
    scans: List = []
    runs = [0]
    entry = trips()

    def counted(again: bool, *args):
        if not meta:
            return fn(*args)
        _REGIONS.append(iter(list(scans)) if again else scans)
        if again:
            _TRIPS.append(entry)
            _DROPPED.append([])
        try:
            return fn(*args)
        finally:
            _REGIONS.pop()
            if again:
                _TRIPS.pop()
                account = _ACCOUNT[-1]
                for held in _DROPPED.pop():
                    if account is not None and sum(held):
                        account.release(sum(held))
                    held[:] = [0, 0]

    def run(*args):
        runs[0] += 1
        if runs[0] == 1:
            return counted(False, *args)
        return ctx.run(counted, True, *args)

    return run
