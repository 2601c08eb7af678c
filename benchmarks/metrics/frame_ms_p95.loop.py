"""95th percentile of the loop's ``raytracer_ms`` over every frame
harvested in the window: the device time between the CUDA events the
loop records around a frame on its stream (refill, replay and copies)."""

from harness.stats import percentile

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "compiled call", \
    "tick_ms_p95"


def read(ctx):
    xs = ctx.samples.get("frame_ms")
    return percentile(xs, 95) if xs else None
