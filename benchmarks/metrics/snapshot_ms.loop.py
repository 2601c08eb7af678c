"""Median of the loop's ``batch_cycle_ms`` (the registry's snapshot:
publish and upload) over the window's dispatching ticks."""

from harness.stats import percentile

UNIT, SOURCE, LAYER, MOVES = "ms", "program_counter", "runtime", \
    "tick_ms_p95"


def read(ctx):
    xs = ctx.samples.get("snapshot_ms")
    return percentile(xs, 50) if xs else None
