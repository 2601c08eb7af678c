"""Device milliseconds per traced step of the training step's
``step.adam`` span: the capturable Adam update of the 9 material
tensors; the activities between its begin and end marker kernels, the
markers left out."""

from harness import spans

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "model", "rays_per_s"


def read(ctx):
    return spans.stage_ms(ctx.trace_data, "step.adam")
