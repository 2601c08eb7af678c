"""95th percentile of the tick time over every tick due in the window:
from each tick's due time on the schedule to the return of
``loop.tick`` (host clock), so a stall also counts in the ticks behind
it. What the engine's game thread pays each frame."""

from harness.stats import percentile

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", None, None


def read(ctx):
    xs = ctx.samples.get("tick_ms")
    return percentile(xs, 95) if xs else None
