"""Device milliseconds per traced step of the loudness map's
``map.permeation`` span (inside ``step.loss``): B3 over every first hit
toward the 8 targets and its glue (the offset points, the directions,
the masked sum); the activities between its begin and end marker
kernels, every marker left out. A program without the span reads
nothing."""

from harness import spans

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "model", "rays_per_s"


def read(ctx):
    return spans.stage_ms(ctx.trace_data, "map.permeation")
