"""Deadline failure detection (port of ``HeartbeatTable`` from
``repro/runtime/fault_tolerance.py``). The serving engine's megastep
watchdog is a table with one host, ``"megastep"``, beaten at each
megastep's start and checked at its end."""
from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, List, Optional

__all__ = ["HeartbeatTable"]


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
