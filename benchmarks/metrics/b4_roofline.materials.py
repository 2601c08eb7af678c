"""B4's share of its roofline in the judged traced step: the least time
its work needs (the larger of its counted float32 operations at the data
sheet's peak and its bytes at the memory peak; ``harness/chord_roofline.
py``, counted from the reference's first-hitting rays of that step, the
targets and the primitives) over the device time of B4's launches in
that step (matched by the kernel's name in the same module)."""

from harness import chord_roofline, roofline

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "rays_per_s"


def read(ctx):
    frames = ctx.trace_data.frames("bench.frame") if ctx.trace_data else []
    c, j = ctx.counts, ctx.values.get("judged_step")
    if not frames or not c or "hitting" not in c or j is None \
            or j >= len(frames):
        return None
    spent = chord_roofline.b4_seconds(frames[j])
    if spent <= 0:
        return None
    least, _ = roofline.least_s(*chord_roofline.b4_counts(
        c["prims"], c["hitting"], c["sets"]))
    return 100.0 * least / spent
