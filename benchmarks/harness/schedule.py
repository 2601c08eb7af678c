"""The open-loop schedule: tick k is due at start + k / rate.

A tick's time is taken from when it was due, not from when it began, so a
stall delays every tick behind it and shows in their times; how late the
generator itself began each tick is kept apart (``late_ms``). Between
ticks the pacer polls the clock and never sleeps, as an engine's game
thread, busy with the rest of its frame, does not (a sleep also wakes
tens to hundreds of microseconds late, by the host's mood).
"""

from __future__ import annotations

import time


class Pacer:
    """Due times at ``rate_hz`` from ``start()`` on, and waiting for them."""

    def __init__(self, rate_hz: float, clock=time.perf_counter):
        self.period = 1.0 / rate_hz
        self.clock = clock
        self.t0 = None

    def start(self) -> float:
        """Fix tick 0's due time now."""
        self.t0 = self.clock()
        return self.t0

    def due(self, k: int) -> float:
        return self.t0 + k * self.period

    def wait(self, k: int) -> float:
        """Wait until tick k is due; returns how late (seconds) the wait
        ended, 0 or more."""
        due = self.due(k)
        while True:
            now = self.clock()
            if now >= due:
                return now - due


def tick_ms(due: float, returned: float) -> float:
    """A tick's time in ms: from its due time to its return."""
    return (returned - due) * 1e3


def rate(work: float, start: float, end: float) -> float:
    """Work per second over the whole window [start, end]."""
    return work / (end - start)
