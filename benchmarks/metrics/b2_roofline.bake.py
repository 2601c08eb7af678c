"""B2's share of its roofline in the judged traced frame: the least time
its work needs (the larger of its counted float32 operations at the data
sheet's peak and its bytes at the memory peak; ``harness/roofline.py``,
counted from the reference's live rays and open pairs of that frame)
over its device time in that frame's launches."""

from harness import roofline

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "kernels", "rays_per_s"


def read(ctx):
    frames = ctx.trace_data.frames("bench.frame") if ctx.trace_data else []
    c = ctx.counts
    if not frames or not c:
        return None
    spent = ctx.trace_data.kernel_s(frames[ctx.values["judged_frame"]],
                                    ["B2"])
    if spent <= 0:
        return None
    least, _ = roofline.least_s(*roofline.b2_counts(c["prims"], c["live"],
                                                    c["open_pairs"]))
    return 100.0 * least / spent
