"""Device milliseconds per traced step of the training step's ``step.loss``
span: the loudness map (B1 and B2 each bounce, B3, the winner gathers,
the impulse response), the loss and the zeroed gradients; the
activities between its begin and end marker kernels, every marker left
out."""

from harness import spans

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "model", "rays_per_s"


def read(ctx):
    return spans.stage_ms(ctx.trace_data, "step.loss")
