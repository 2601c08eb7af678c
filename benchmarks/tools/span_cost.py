"""What the program's spans cost, on the card.

    python3 benchmarks/tools/span_cost.py [--rounds 4] [--seconds 8]

With the device spans' markers on and off in turns (on, off, off, on,
...; ``utils/profiling.py::set_device_spans``), each turn with a frame
graph captured anew:

- the bake (``bake_1m``'s scene and trace settings): device ms per frame
  between CUDA events around ``--frames`` frames on one scene (no
  refill: the graph, the inputs' and outputs' copies), and rays/s over
  ``--seconds`` of frames back to back, each refilled with its own
  listener position, at most two ahead of the device, as the cell runs;
- a static loop frame (``sample_scene``'s scene and settings): device ms
  per frame over ``--loop-frames`` frames on one scene;

then, with the markers on, the markers' own device ms per bake frame
and their count (two replays under ``torch.profiler``), the program's
host spans per bake frame, and the host microseconds of one host span
entered and left with the profiler off and on. Prints one JSON line per
turn, then the summary.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--loop-frames", type=int, default=500)
    a = p.parse_args(argv)
    sys.path[:0] = [ROOT, BENCH_DIR]
    import torch

    from harness import runner, scene
    from reference import frame as reference

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from audio_raytracer_tpu_torch.models.raytracer import make_forward
    from audio_raytracer_tpu_torch.types import TraceConfig
    from audio_raytracer_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    runner.load_libraries()

    def cell(name):
        # The configuration's file (the loop cells are held back from
        # BENCHMARK.json).
        with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        sc = cfg["scene"]
        layout = scene.random_layout(sc["layout_seed"], sc["spheres"],
                                     sc["aabbs"], sc["obbs"], sc["targets"],
                                     sc["extent"], sc["size_range"], dev)
        tcfg = TraceConfig(**cfg["trace"])
        return (tcfg, scene.port_scene(layout),
                reference.fibonacci_directions(tcfg.ray_count, dev))

    bake, loop = cell("bake_1m"), cell("sample_scene")
    g = scene.generator(7, dev)
    pos = (torch.rand((256, 3), generator=g, device=dev) * 2 - 1) * 30.0

    def device_ms(tcfg, port, dirs, n):
        step = make_forward(tcfg, device=dev)
        for k in range(3):
            step(pos[k], dirs, port, reuse_scene=True)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for k in range(n):
            step(pos[k % len(pos)], dirs, port, reuse_scene=True)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def rays_per_s(tcfg, port, dirs):
        step = make_forward(tcfg, device=dev)
        for k in range(3):
            step(pos[k], dirs, port)
        torch.cuda.synchronize()
        pending, n = collections.deque(), 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < a.seconds:
            step(pos[n % len(pos)], dirs, port)
            n += 1
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.popleft().synchronize()
        torch.cuda.synchronize()
        return tcfg.ray_count * n / (time.perf_counter() - t0)

    card = runner.power_limit()
    got = {True: collections.defaultdict(list),
           False: collections.defaultdict(list)}
    order = [r % 4 in (0, 3) for r in range(a.rounds)]
    for on in order:
        profiling.set_device_spans(on)
        turn = dict(
            bake_device_ms=device_ms(*bake, a.frames),
            bake_rays_per_s=rays_per_s(*bake),
            loop_device_ms=device_ms(*loop, a.loop_frames))
        for k, v in turn.items():
            got[on][k].append(v)
        print(json.dumps(dict(spans=on, card=card, **turn)), flush=True)
    profiling.set_device_spans(True)

    # The markers' own device time and the host spans, per bake frame.
    tcfg, port, dirs = bake
    step = make_forward(tcfg, device=dev)
    for k in range(3):
        step(pos[k], dirs, port)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    tmp = tempfile.mkdtemp(prefix="span-cost-")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for k in range(2):
                step(pos[3 + k], dirs, port)
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    marks = [e for e in events if e.get("cat") == "kernel"
             and profiling.marker_span(e.get("name", "")) is not None]
    host = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(profiling.HOST_PREFIX)]
    marker_us = sum(e["dur"] for e in marks)
    markers = len(marks)

    def span_us(n=20000):
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off_us = span_us()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on_us = span_us()

    def med(xs):
        return statistics.median(xs) if xs else None

    summary = dict(
        card=card, rounds=a.rounds,
        **{f"{k}_{'on' if on else 'off'}": med(got[on][k])
           for on in (True, False) for k in got[on]},
        marker_device_ms_per_frame=marker_us * 1e-3 / 2,
        markers_per_frame=markers / 2,
        host_spans_per_frame=len(host) / 2,
        host_span_us_profiler_off=off_us,
        host_span_us_profiler_on=on_us)
    for k in ("bake_device_ms", "bake_rays_per_s", "loop_device_ms"):
        on, off = summary[f"{k}_on"], summary[f"{k}_off"]
        summary[f"{k}_on_over_off"] = on / off
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
