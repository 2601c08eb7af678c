"""Share of each traced frame's span, from its first device activity to
its last, with nothing running on the device; the mean over the frames."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "tick_ms_p95"


def read(ctx):
    shares = []
    frames = ctx.trace_data.frames("bench.tick") if ctx.trace_data else []
    for f in frames:
        span = (max(e.end for e in f) - min(e.ts for e in f)) * 1e-6
        if span > 0:
            shares.append(1.0 - ctx.trace_data.busy_s(f) / span)
    return 100.0 * sum(shares) / len(shares) if shares else None
