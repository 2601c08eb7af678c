"""Host waits per traced frame: the program's ``art.sync`` host spans,
one around each step of its frame path that waits for the device (the
kernel engine's row selections in the refill)."""

from harness import spans

UNIT, SOURCE, LAYER, MOVES = "count", "program_span", "kernel engine", \
    "rays_per_s"


def read(ctx):
    return spans.host_spans_per_frame(ctx.trace_data, "sync")
