"""Share of the traced slice (its host span, back-to-back frames ending
in a synchronize) with nothing running on the device."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "device", "rays_per_s"


def read(ctx):
    t = ctx.trace_data
    if t is None or not t.in_window():
        return None
    lo, hi = t.window()
    busy = t.busy_s(t.in_window(), lo, hi)
    return 100.0 * (1.0 - busy / ((hi - lo) * 1e-6))
