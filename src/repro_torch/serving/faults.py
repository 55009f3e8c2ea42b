"""Deterministic fault injection and the typed serving-failure taxonomy
(port of ``repro/serving/faults.py``).

A seeded, replayable :class:`FaultPlan` injects failures at the engine's
seams, and the engine fails closed with a typed :class:`ServingFault`
where recovery is impossible: a request either completes bit-identical to
the fault-free run or ends with a subclass of it, never with silently
corrupted output.

Fault sites:

``upload``
    Host→device copy of a PMQ expert-bucket row. Key: ``(layer, slot)``.
``swap_out`` / ``swap_in``
    KV page traffic for preempted slots. Key: request id.
``pool``
    Transient page-pool exhaustion: the controller's ``Observation`` sees
    ``arg`` fewer free pages than exist (planning only; outputs stay
    unchanged by batch-composition independence). Key: ``None``.
``logits``
    A poisoned request: the final prefill logits row turns non-finite.
    Key: request id. The engine's finite guard ends exactly that request
    with :class:`PoisonedRequest` and a clean release.

The port's engine and controller fire ``pool`` and ``logits``;
:class:`~repro_torch.serving.kvcache.PagedKVCache` fires ``swap_out`` and
``swap_in`` itself, and :class:`~repro_torch.serving.offload.ExpertOffloadManager`
fires ``upload`` in its recovery ladder.

A plan is replayable: it is keyed on the logical step (the engine calls
:meth:`FaultPlan.at_step` at every megastep boundary, never a wall clock)
and on the sequence of ``fire(site, key)`` calls, itself a deterministic
function of the request trace and engine config.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FAULT_MODES",
    "FAULT_SITES",
    "DeadlineExceeded",
    "ExpertUploadFailed",
    "FaultPlan",
    "FaultSpec",
    "InvalidRequest",
    "LivelockDetected",
    "PoisonedRequest",
    "RequestCancelled",
    "ServingFault",
    "SwapFault",
    "WatchdogTimeout",
    "checksum_tree",
    "corrupt_tree",
]

FAULT_SITES = ("upload", "swap_out", "swap_in", "pool", "logits")
FAULT_MODES = ("fail", "corrupt")


# --------------------------------------------------------------- errors
class ServingFault(RuntimeError):
    """Base of every typed serving failure."""

    def __init__(self, msg: str, *, rid: Optional[int] = None):
        super().__init__(msg)
        self.rid = rid


class RequestCancelled(ServingFault):
    """Client called ``engine.cancel(rid)`` mid-flight."""


class DeadlineExceeded(ServingFault):
    """``Request.deadline_steps`` elapsed before completion."""


class PoisonedRequest(ServingFault):
    """Non-finite logits surfaced for this request (finite guard)."""


class ExpertUploadFailed(ServingFault):
    """An expert row's upload failed past the retry budget."""


class SwapFault(ServingFault):
    """KV swap payload failed its checksum or I/O."""


class WatchdogTimeout(ServingFault):
    """A megastep exceeded the wall-clock watchdog budget."""


class LivelockDetected(ServingFault):
    """The engine had work but made no progress for too many consecutive
    megastep boundaries."""


class InvalidRequest(ServingFault, ValueError):
    """Rejected at ``Scheduler.submit`` (empty prompt, non-positive
    ``max_new``, negative priority, duplicate live rid, non-positive
    deadline). Also a ``ValueError``."""


# ----------------------------------------------------------- fault plan
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. ``key=None`` is a wildcard (the first matching
    call fires it); ``count=-1`` never exhausts (persistent)."""

    site: str
    mode: str = "fail"
    key: Optional[Hashable] = None
    step: int = 0  # arms at logical step >= step
    until: Optional[int] = None  # disarms at logical step >= until
    count: int = 1  # max firings; -1 = persistent
    arg: int = 0  # site-specific magnitude (pool: pages hidden)

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"fault site {self.site!r} not in {FAULT_SITES}")
        if self.mode not in FAULT_MODES:
            raise ValueError(f"fault mode {self.mode!r} not in {FAULT_MODES}")


class FaultPlan:
    """A deterministic, replayable fault schedule: the engine advances
    :attr:`step` at every megastep boundary (:meth:`at_step`); injection
    sites call :meth:`fire` and act on the returned spec (or ``None``).
    Matching consumes the spec's ``count``, so the firings are a pure
    function of the call sequence."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: List[FaultSpec] = list(specs)
        self.step = 0
        self._fired = [0] * len(self.specs)
        self.injected = 0
        # (step, site, key, mode) per firing — the replay-checkable log
        self.log: List[Tuple[int, str, Optional[Hashable], str]] = []

    def at_step(self, step: int) -> None:
        self.step = int(step)

    def fire(self, site: str, key: Optional[Hashable] = None) -> Optional[FaultSpec]:
        """Consume and return the first armed spec matching ``(site, key)``
        at the current logical step, else ``None``."""
        for i, s in enumerate(self.specs):
            if s.site != site:
                continue
            if s.key is not None and s.key != key:
                continue
            if self.step < s.step:
                continue
            if s.until is not None and self.step >= s.until:
                continue
            if s.count >= 0 and self._fired[i] >= s.count:
                continue
            self._fired[i] += 1
            self.injected += 1
            self.log.append((self.step, site, key, s.mode))
            return s
        return None

    def replay(self) -> "FaultPlan":
        """A fresh plan with the same schedule (for replay runs)."""
        return FaultPlan(self.specs)

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n_faults: int = 4,
        max_step: int = 24,
        sites: Sequence[str] = FAULT_SITES,
        rids: Sequence[int] = (),
        expert_keys: Sequence[Tuple[int, int]] = (),
        persistent: bool = False,
        max_count: int = 2,
    ) -> "FaultPlan":
        """Seeded random schedule for fuzzing (the reference's draws, so
        one seed gives the same specs in both packages). ``rids`` feeds the
        swap/logits keys, ``expert_keys`` the ``(layer, slot)`` upload keys
        (empty = wildcard faults)."""
        rng = np.random.default_rng(seed)
        specs = []
        for _ in range(int(n_faults)):
            site = str(sites[int(rng.integers(len(sites)))])
            if site == "pool":
                mode = "fail"
            elif site == "logits":
                mode = "corrupt"
            else:
                mode = FAULT_MODES[int(rng.integers(2))]
            key: Optional[Hashable] = None
            if site == "upload" and expert_keys:
                key = tuple(expert_keys[int(rng.integers(len(expert_keys)))])
            elif site in ("swap_out", "swap_in", "logits") and rids:
                key = int(rids[int(rng.integers(len(rids)))])
            count = -1 if persistent else int(rng.integers(1, max_count + 1))
            specs.append(FaultSpec(
                site=site, mode=mode, key=key,
                step=int(rng.integers(0, max_step)), count=count,
                arg=int(rng.integers(1, 9)),
            ))
        return cls(specs)


# ------------------------------------------------------------ checksums
def _leaves(tree) -> List:
    """Leaves in ``jax.tree_util`` flatten order: dict values by sorted
    key, list and tuple items in order, ``None`` dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(item, leaves) for item in tree)
    return next(leaves)


def _host_bytes(leaf) -> bytes:
    """A leaf's raw bytes in C order. A bf16 tensor has no numpy dtype, so
    its bits go through ``uint16``: the same bytes as a bf16 numpy array of
    the same values."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


def checksum_tree(tree) -> int:
    """CRC32 folded over every array leaf of ``tree`` (nested dicts, lists
    and tuples of torch tensors or numpy arrays) in flatten order."""
    crc = 0
    for leaf in _leaves(tree):
        crc = zlib.crc32(_host_bytes(leaf), crc)
    return crc


def corrupt_tree(tree):
    """A structurally identical copy of ``tree`` with the first leaf's
    leading byte bit-flipped (guaranteed to break :func:`checksum_tree`).
    Tensors stay tensors on their device, arrays become numpy arrays."""
    out = []
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            a = leaf.detach().clone().contiguous()
            if i == 0 and a.numel():
                raw = a.view(-1).view(torch.uint8)
                raw[0] ^= 0xFF
        else:
            a = np.array(leaf, copy=True)
            if i == 0 and a.size:
                a.view(np.uint8).reshape(-1)[0] ^= 0xFF
        out.append(a)
    return _unflatten(tree, iter(out))
