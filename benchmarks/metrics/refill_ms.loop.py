"""The frame graph's refill time (scene copy, engine build, copy-in; its
``refill_ms`` summed over the ticks in which its ``refills`` rose) per
frame dispatched in the window: about 0 where the scene holds still."""

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "compiled call", \
    "tick_ms_p95"


def read(ctx):
    n = ctx.values.get("frames_dispatched")
    return ctx.values.get("refill_ms", 0.0) / n if n else None
