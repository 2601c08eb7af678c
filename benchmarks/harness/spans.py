"""The program's own spans in a traced run.

The program marks each stage of a frame on the device with two
one-thread kernels on the frame's stream, ``art_span_<stage>_begin`` and
``art_span_<stage>_end`` (a stage's dots written as underscores), which a
CUDA graph captures like any other kernel, so that a replayed frame
carries them. What runs on the host outside the graph it names with host
ranges ``art.<name>`` (``record_function``). A program without them has
neither: every reader here then returns None.
"""

from __future__ import annotations

import re

from harness import devtrace

FRAME = "bench.frame"
HOST_PREFIX = "art."
MARKER = re.compile(r"(?:void\s+)?art_span_([A-Za-z0-9_]+)_(begin|end)"
                    r"(?![A-Za-z0-9_])")


def marker(name: str) -> tuple[str, str] | None:
    """(stage with underscores, "begin" or "end") of a marker kernel's
    name, None for any other activity."""
    m = MARKER.match(name)
    return (m.group(1), m.group(2)) if m else None


def stage_ms(trace, stage: str) -> float | None:
    """Device milliseconds per traced frame of the activities between
    ``stage``'s begin and end markers, every marker left out; None
    unless every traced frame has both."""
    frames = trace.frames(FRAME) if trace is not None else []
    if not frames:
        return None
    want = stage.replace(".", "_")
    total = 0.0
    for events in frames:
        inside = ended = False
        for e in events:
            m = marker(e.name)
            if m is not None:
                if m[0] == want:
                    inside = m[1] == "begin"
                    ended = ended or m[1] == "end"
                continue
            if inside:
                total += e.end - e.ts
        if not ended:
            return None
    return 1e-3 * total / len(frames)


def host_spans(trace, name: str | None = None) -> list:
    """The program's host spans (``art.<name>``; all of them without a
    name) on the thread that ran the traced window."""
    tid = trace.window_span().tid
    want = None if name is None else HOST_PREFIX + name
    return [h for h in trace.host
            if h.cat == "user_annotation" and h.tid == tid
            and h.name.startswith(HOST_PREFIX)
            and (want is None or h.name == want)]


def host_spans_per_frame(trace, name: str) -> float | None:
    """How many ``art.<name>`` host spans began inside a traced frame's
    span, per traced frame; None where the frames hold no ``art.`` span
    at all."""
    frames = [s for s in trace.spans if s.name == FRAME] \
        if trace is not None else []
    if not frames:
        return None

    def inside(h):
        return any(f.ts <= h.ts <= f.end for f in frames)

    mine = [h for h in host_spans(trace) if inside(h)]
    if not mine:
        return None
    return sum(h.name == HOST_PREFIX + name for h in mine) / len(frames)


def idle_ms_in(trace, name: str) -> float | None:
    """Milliseconds per traced frame in which the device ran nothing
    while the host was inside an ``art.<name>`` span: each idle stretch
    of the traced window counts whole where such a span holds its middle
    (``devtrace.innermost`` over those spans). None without the span."""
    if trace is None or not trace.in_window():
        return None
    outer = host_spans(trace, name)
    n_frames = len(trace.frames(FRAME))
    if not outer or not n_frames:
        return None
    lo, hi = trace.window()
    idle = devtrace.gaps([(e.ts, e.end) for e in trace.in_window()], lo, hi)
    inner = devtrace.innermost(outer, [0.5 * (s + e) for s, e in idle])
    total = sum(e - s for (s, e), h in zip(idle, inner) if h is not None)
    return 1e-3 * total / n_frames
