"""Device milliseconds per traced frame of every activity that is not one
of the kernel table's (B1-B3): the bounce loop's glue, the refill's
kernels and the copies."""

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "trace ops", \
    "tick_ms_p95"


def read(ctx):
    frames = ctx.trace_data.frames("bench.tick") if ctx.trace_data else []
    if not frames:
        return None
    return 1e3 * sum(ctx.trace_data.glue_s(f) for f in frames) / len(frames)
