"""Injectable clocks for the request lifecycle.

Every timestamp in the serving stack flows from one callable: the engine's
``clock`` (default ``time.perf_counter``). The scheduler measures assembly
and compute with it, ``submit`` stamps arrivals with it, and the open-loop
replay threads an explicit virtual ``now`` through ``Scheduler.step``
*alongside* it. Injecting ``ManualClock`` makes every one of those numbers
deterministic — wall-clock never leaks into a virtual-timeline assertion —
which is what lets the max-wait-window and shedding tests pin exact
dispatch/shed times. The reference package's clocks, copied: a replay
under ``TickClock`` follows the reference's trajectory read for read.
"""
from __future__ import annotations


class TickClock:
    """A clock that advances by a fixed ``dt`` on every read.

    With a ``TickClock`` injected into ``Engine(clock=...)``, every measured
    duration in the lifecycle (assembly, compute, queue wait) becomes a fixed
    number of ticks, so an open-loop replay — whose cursor advances by
    *measured* work — follows one exact trajectory regardless of host speed:
    the same arrivals coalesce into the same chunks, the same requests shed.
    That determinism makes shed, occupancy and queue-wait numbers exact,
    never-flaky metrics while wall-clock latencies stay advisory."""

    def __init__(self, dt: float = 1e-4, start: float = 0.0):
        if dt <= 0:
            raise ValueError(f"dt must be > 0, got {dt}")
        self._t = float(start)
        self._dt = float(dt)

    def __call__(self) -> float:
        self._t += self._dt
        return self._t


class ManualClock:
    """A clock that only moves when told to.

    Call it like ``time.perf_counter`` (returns the current virtual time in
    seconds); ``advance``/``set`` move it. With a ``ManualClock`` injected
    into ``Engine(clock=...)``, measured assembly/compute durations are
    exactly the amount the test advanced between calls — zero by default —
    so per-request breakdowns and shed timestamps are exact."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        """Move the clock forward by ``dt`` seconds and return the new time."""
        if dt < 0:
            raise ValueError(f"clock cannot move backwards (dt={dt})")
        self._t += float(dt)
        return self._t

    def set(self, t: float) -> float:
        """Jump the clock to absolute time ``t`` (monotonic: no rewinds)."""
        if t < self._t:
            raise ValueError(f"clock cannot move backwards ({t} < {self._t})")
        self._t = float(t)
        return self._t
