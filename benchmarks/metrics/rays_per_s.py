"""Rays of every frame completed in the window over the window's seconds;
the window ends in a synchronize (host clock)."""

from harness.schedule import rate

UNIT, SOURCE, LAYER, MOVES = "rays/s", "host_clock", None, None


def read(ctx):
    v = ctx.values
    if not v.get("rays"):
        return None
    return rate(v["rays"], 0.0, v["window_s"])
