"""Device milliseconds per traced frame of the kernel table's kernels
(B1 closest hit, B2 fused occlusion, B3 chords)."""

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "kernels", \
    "tick_ms_p95"


def read(ctx):
    frames = ctx.trace_data.frames("bench.tick") if ctx.trace_data else []
    if not frames:
        return None
    return 1e3 * sum(ctx.trace_data.kernel_s(f) for f in frames) / len(frames)
