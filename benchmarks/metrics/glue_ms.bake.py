"""Device milliseconds per traced frame of every activity that is not one
of the kernel table's (B1-B3): the reverb IR's index_add_, permeation's
scatter_reduce, the winner gathers, the refill, the copies."""

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "trace ops", \
    "rays_per_s"


def read(ctx):
    frames = ctx.trace_data.frames("bench.frame") if ctx.trace_data else []
    if not frames:
        return None
    return 1e3 * sum(ctx.trace_data.glue_s(f) for f in frames) / len(frames)
