"""Injectable time source for the serving stack (DESIGN.md §14).

Every latency measurement, deadline comparison, and batching-window wait
in the serving path flows through a `Clock` instead of calling
`time.perf_counter()` directly.  The production `WallClock` is a thin
veneer over `perf_counter`; tests inject a fake clock
(`tests/clockwork.py`) that only moves when told to, which makes the
whole SLO control loop — EDF dispatch, expiry sweeps, EWMA updates,
governor hysteresis — drivable deterministically with zero real sleeps.

The one non-obvious member is `on_batch(key, span)`: `_execute_batch`
calls it between taking its start and end timestamps.  The wall clock
ignores it (real time already passed); a fake clock uses it to advance
virtual time by a scripted per-key latency, so "the batch took 3 ms"
becomes a test input instead of a machine-load artifact.
"""

from __future__ import annotations

import time


class Clock:
    """Time-source interface. Subclass and override for virtual time."""

    def now(self) -> float:
        """Current time in seconds (monotonic, arbitrary epoch)."""
        raise NotImplementedError

    def on_batch(self, key, span=None) -> None:
        """Hook invoked once per executed batch, between the dispatch
        timestamps.  `key` is the BatchKey; `span` is the measured wall
        span so far (None before execution finishes).  No-op by default.
        """

    def sleep(self, seconds: float) -> None:
        """Advance time by `seconds` (real for WallClock, virtual for fakes)."""
        raise NotImplementedError


class WallClock(Clock):
    """Production clock: `time.perf_counter` + real `time.sleep`."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


WALL = WallClock()
