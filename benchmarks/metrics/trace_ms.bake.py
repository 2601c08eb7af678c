"""Device milliseconds per traced frame of the model's ``trace`` stage
(the bounce loop: B1 and B2 each bounce, the winner gathers, the
reflections): the activities between its begin and end marker kernels,
the markers left out."""

from harness import spans

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "model", "rays_per_s"


def read(ctx):
    return spans.stage_ms(ctx.trace_data, "trace")
