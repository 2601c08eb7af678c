"""Device milliseconds per traced step of the training step's
``step.backward`` span: B4 (the density adjoint), autograd's winner
recompute through the bounce loop and the adjoints of the gathers and
the impulse response; the activities between its begin and end marker
kernels, every marker left out."""

from harness import spans

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "model", "rays_per_s"


def read(ctx):
    return spans.stage_ms(ctx.trace_data, "step.backward")
