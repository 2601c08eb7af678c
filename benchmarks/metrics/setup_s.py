"""Seconds from the start of the process to the first timed tick or frame:
imports, the kernel libraries (built on a checkout's first run), the
scene, the warm-up and the capture (host clock)."""

UNIT, SOURCE, LAYER, MOVES = "s", "host_clock", None, None


def read(ctx):
    return ctx.setup_s
