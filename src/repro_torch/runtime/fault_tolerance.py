"""Fault-tolerance runtime (port of ``repro/runtime/fault_tolerance.py``):
failure detection, stragglers, restart-on-failure.

* :class:`HeartbeatTable` — deadline failure detector over an injectable
  clock. The serving engine's megastep watchdog is a table with one host,
  ``"megastep"``, beaten at each megastep's start and checked at its end.
* :class:`StragglerMonitor` — rolling median step times per host; a host
  whose median exceeds ``threshold ×`` the fleet median is flagged.
* :class:`ResilientLoop` — runs a step function with restore-and-retry
  semantics under a :class:`FailurePolicy`; every side effect is injected.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Hashable, List, Optional

__all__ = ["FailurePolicy", "HeartbeatTable", "ResilientLoop", "StragglerMonitor"]


class HeartbeatTable:
    """Deadline failure detector over an injectable clock.

    ``clock`` (default ``time.monotonic``) supplies the timestamps of every
    call that omits an explicit ``now``; the serving watchdog and the tests
    pass a fake clock, so expiry is deterministic and never sleeps."""

    def __init__(self, hosts: List[Hashable], timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self._last: Dict[Hashable, float] = {h: clock() for h in hosts}

    def beat(self, host: Hashable, now: Optional[float] = None) -> None:
        self._last[host] = now if now is not None else self.clock()

    def failed(self, now: Optional[float] = None) -> List[Hashable]:
        now = now if now is not None else self.clock()
        return [h for h, t in self._last.items() if now - t > self.timeout]

    def alive(self, now: Optional[float] = None) -> List[Hashable]:
        bad = set(self.failed(now))
        return [h for h in self._last if h not in bad]


class StragglerMonitor:
    """Rolling median step times per host; flags slow hosts. ``record``
    takes durations from the caller's clock of choice, so the monitor is
    deterministic by construction."""

    def __init__(self, window: int = 16, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self._times: Dict[Hashable, deque] = defaultdict(lambda: deque(maxlen=window))

    def record(self, host: Hashable, step_time: float) -> None:
        self._times[host].append(step_time)

    @staticmethod
    def _median(xs) -> float:
        s = sorted(xs)
        return s[len(s) // 2]

    def stragglers(self) -> List[Hashable]:
        meds = {h: self._median(ts) for h, ts in self._times.items() if len(ts) >= 4}
        if len(meds) < 2:
            return []
        fleet = self._median(list(meds.values()))
        return [h for h, m in meds.items() if m > self.threshold * fleet]


@dataclasses.dataclass
class FailurePolicy:
    max_restarts: int = 3
    restore_fn: Optional[Callable[[], None]] = None  # restore the latest checkpoint
    shrink_fn: Optional[Callable[[], None]] = None  # give up capacity
    shrink_after: int = 2  # restarts before shrinking


class ResilientLoop:
    """Run ``step_fn(step) -> metrics`` for ``steps`` steps; a step that
    raises is counted, the policy's ``shrink_fn`` runs from the
    ``shrink_after``-th restart on and its ``restore_fn`` after every
    failure, and the step is retried; past ``max_restarts`` the loop
    raises."""

    def __init__(self, policy: FailurePolicy):
        self.policy = policy
        self.restarts = 0
        self.events: List[Dict] = []

    def run(self, step_fn: Callable[[int], dict], start: int, steps: int):
        step = start
        metrics = None
        while step < start + steps:
            try:
                metrics = step_fn(step)
                step += 1
            except Exception as e:  # noqa: BLE001 - any step fault
                self.restarts += 1
                self.events.append({"step": step, "error": repr(e)})
                if self.restarts > self.policy.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.policy.max_restarts}") from e
                if self.restarts >= self.policy.shrink_after and self.policy.shrink_fn is not None:
                    self.policy.shrink_fn()
                    self.events.append({"step": step, "action": "shrink"})
                if self.policy.restore_fn is not None:
                    self.policy.restore_fn()
                    self.events.append({"step": step, "action": "restore"})
        return metrics
