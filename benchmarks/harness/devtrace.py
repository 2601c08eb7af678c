"""The device trace of a traced run, and its reduction.

``profiled`` runs a block under ``torch.profiler`` (host and device
activities), writes the Chrome trace under a fresh directory of the
temporary directory and reads it back as a ``Trace``: the device
activities (kernels, copies, memsets), the benchmark's own spans (its
``record_function`` ranges, names starting ``bench.``) and the host's
operations. A device activity belongs to the span in which the host
call that launched it ran (the trace's correlation ids); one whose
launch is not in the trace goes to the last span that began before it
started.

Kernels are told apart from the rest by name, from the table in
``kernels.json`` beside this package: every device activity that is not
one of its kernels is glue.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
import shutil
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."
# Idle stretches shorter than this (microseconds) are the device's own
# between two kernels, not a wait for the host.
SHORT_GAP_US = 20.0
KERNELS_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels.json")


def kernel_table(path: str = KERNELS_FILE) -> dict:
    """{class: [kernel function names]} (B1, B2, B3, ...)."""
    with open(path) as f:
        return {k: v for k, v in json.load(f).items() if not k.startswith("_")}


def classify(name: str, table: dict) -> str | None:
    """The class of a device activity's name, or None for glue. A kernel
    matches when its function name appears as a whole identifier."""
    for cls, fns in table.items():
        for fn in fns:
            if re.search(rf"(?<![A-Za-z0-9_]){re.escape(fn)}(?![A-Za-z0-9_])",
                         name):
                return cls
    return None


def short_name(name: str) -> str:
    """A device activity's name without return type, template arguments
    and parameters, at most 80 characters."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([A-Za-z_][A-Za-z0-9_:]*)\s*[<(]", name)
    return (m.group(1) if m else name)[:80]


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) microsecond pairs."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def gaps(intervals, lo: float, hi: float):
    """(start, end) microsecond stretches of [lo, hi] that no interval
    covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def innermost(host, points):
    """For each time in ``points``, the innermost of the (nested) host
    events that contains it, or None: one sweep with a stack."""
    evs = sorted(host, key=lambda h: (h.ts, -h.end))
    out = [None] * len(points)
    stack, j = [], 0
    for q in sorted(range(len(points)), key=points.__getitem__):
        m = points[q]
        while j < len(evs) and evs[j].ts <= m:
            while stack and stack[-1].end <= evs[j].ts:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1].end <= m:
            stack.pop()
        out[q] = stack[-1] if stack else None
    return out


Event = collections.namedtuple("Event", "name cat ts end corr tid")


class Trace:
    """A parsed Chrome trace of ``torch.profiler``."""

    def __init__(self, events: list[dict], table: dict | None = None):
        self.table = kernel_table() if table is None else table
        self.device, self.spans, self.host = [], [], []
        launch_ts = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            args = e.get("args") or {}
            ev = Event(e.get("name", ""), e.get("cat", ""), float(e["ts"]),
                       float(e["ts"]) + float(e["dur"]),
                       args.get("correlation"), e.get("tid"))
            if ev.cat in DEVICE_CATS:
                self.device.append(ev)
            elif ev.cat == "user_annotation" and ev.name.startswith(
                    SPAN_PREFIX):
                self.spans.append(ev)
            else:
                self.host.append(ev)
                if ev.cat in LAUNCH_CATS and ev.corr is not None:
                    launch_ts[ev.corr] = ev.ts
        self.device.sort(key=lambda e: e.ts)
        self.spans.sort(key=lambda e: e.ts)
        self._launch_ts = launch_ts
        self._classes = {n: classify(n, self.table)
                         for n in {e.name for e in self.device}}

    def window(self, name: str = "bench.traced"):
        """(start, end) microseconds of the first span of that name."""
        for s in self.spans:
            if s.name == name:
                return s.ts, s.end
        raise KeyError(f"no span {name!r} in the trace")

    def per_span(self, name: str) -> list[list[Event]]:
        """For each span of that name in time order, the device activities
        launched inside it."""
        spans = [s for s in self.spans if s.name == name]
        starts = [s.ts for s in spans]
        out = [[] for _ in spans]
        for ev in self.device:
            t = self._launch_ts.get(ev.corr)
            if t is not None:
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= spans[i].end:
                    out[i].append(ev)
                continue
            i = bisect.bisect_right(starts, ev.ts) - 1
            if i >= 0:
                out[i].append(ev)
        return out

    def frames(self, name: str) -> list[list[Event]]:
        """``per_span`` without the spans that launched nothing (a tick
        that skipped, its frame still running)."""
        return [f for f in self.per_span(name) if f]

    def in_window(self, name: str = "bench.traced") -> list[Event]:
        lo, hi = self.window(name)
        return [e for e in self.device if e.end > lo and e.ts < hi]

    def busy_s(self, events, lo: float = float("-inf"),
               hi: float = float("inf")) -> float:
        """Seconds in which one of ``events`` ran, within [lo, hi]."""
        return union_s((max(e.ts, lo), min(e.end, hi)) for e in events
                       if e.end > lo and e.ts < hi)

    def kernel_s(self, events, classes=None) -> float:
        """Device seconds of the events of the kernel classes (all the
        table's when None)."""
        want = set(self.table) if classes is None else set(classes)
        return sum(e.end - e.ts for e in events
                   if self._classes[e.name] in want) * 1e-6

    def glue_s(self, events) -> float:
        return sum(e.end - e.ts for e in events
                   if self._classes[e.name] is None) * 1e-6

    def breakdown(self, name: str = "bench.traced", top: int = 10) -> dict:
        """The ``top`` device operations by total seconds in the window,
        and the ``top`` idle stretches summed by what the host was doing:
        the host operation innermost at their middle on the thread that
        ran the window (its ``bench.`` span where it ran none). Stretches
        under ``SHORT_GAP_US`` are the device's own, between kernels."""
        lo, hi = self.window(name)
        evs = self.in_window(name)
        ops = collections.Counter()
        for e in evs:
            ops[short_name(e.name)] += (min(e.end, hi) - max(e.ts, lo)) * 1e-6
        main = self.window_span(name).tid
        host = [h for h in self.host + self.spans if h.tid == main]
        idle = collections.Counter()
        long_gaps = []
        for s, e in gaps([(x.ts, x.end) for x in evs], lo, hi):
            if e - s < SHORT_GAP_US:
                idle["device: between kernels"] += (e - s) * 1e-6
            else:
                long_gaps.append((s, e))
        inner = innermost(host, [0.5 * (s + e) for s, e in long_gaps])
        for (s, e), h in zip(long_gaps, inner):
            idle[short_name(h.name) if h else "host: none"] += (e - s) * 1e-6
        return dict(device_ops=[[k, v] for k, v in ops.most_common(top)],
                    idle_gaps=[[k, v] for k, v in idle.most_common(top)])

    def window_span(self, name: str = "bench.traced") -> Event:
        return next(s for s in self.spans if s.name == name)


@contextlib.contextmanager
def profiled(device, holder: dict):
    """Profile the block (host and, on a card, device activities); on
    exit ``holder["trace"]`` is the parsed ``Trace``. The Chrome trace is
    written under a fresh directory of the temporary directory, which is
    removed once read."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.traced"):
                yield
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["trace"] = Trace(json.load(f)["traceEvents"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
