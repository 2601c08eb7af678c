"""Device-idle milliseconds per traced frame while the host refills the
compiled frame: every idle stretch of the traced window whose middle lies
inside the program's ``art.refill`` host span (scene copy, engine build
and its host waits, copy-in)."""

from harness import spans

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "compiled call", \
    "rays_per_s"


def read(ctx):
    return spans.idle_ms_in(ctx.trace_data, "refill")
