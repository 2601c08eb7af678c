"""Device milliseconds per traced frame of the model's ``permeation``
stage (B3 and its scatter): the activities between its begin and end
marker kernels, the markers left out."""

from harness import spans

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "model", "rays_per_s"


def read(ctx):
    return spans.stage_ms(ctx.trace_data, "permeation")
