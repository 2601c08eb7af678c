"""Driver: frames of the program's compiled forward, back to back.

An offline user's bake: ``make_forward(cfg)`` (on the card a frame
graph) called frame after frame on the configuration's scene (drawn
from its ``layout_seed``, else from the seed), the same directions, and
one listener position a frame, drawn from the seed in +/-
``listener_extent``. Set-up makes the scene, the
directions and the positions on the device and runs ``warmup_frames``
frames (the warm-up, the capture and replays). The window enqueues
frames until its seconds have passed, at most ``in_flight`` ahead of the
device, and ends in a synchronize.

Values: ``rays`` (rays x frames completed) and ``window_s``. With
``--trace`` a further ``traced_frames`` frames run under the profiler,
each in a ``bench.frame`` span.

Correct: one frame drawn from the seed, among the window's (among the
traced ones in a traced run, whose counts the roofline takes), is held
against the reference for the same scene, directions and position.
"""

from __future__ import annotations

import collections
import time

import torch

from harness import devtrace, judge, scene
from reference import frame as reference


def run(ctx):
    from audio_raytracer_tpu_torch.models.raytracer import make_forward
    from audio_raytracer_tpu_torch.types import TraceConfig

    tr, sc, dev = ctx.traffic, ctx.config["scene"], ctx.device
    tcfg = TraceConfig(**{**ctx.config["trace"],
                          "compute_dtype": ctx.compute_dtype})
    layout = scene.random_layout(sc.get("layout_seed", ctx.seed),
                                 sc["spheres"], sc["aabbs"],
                                 sc["obbs"], sc["targets"], sc["extent"],
                                 sc["size_range"], dev)
    port = scene.port_scene(layout)
    dirs = reference.fibonacci_directions(tcfg.ray_count, dev)
    g = scene.generator(ctx.seed + 1, dev)
    ext = tr["listener_extent"]
    n_pos = tr["positions"]
    pos = (torch.rand((n_pos, 3), generator=g, device=dev) * 2 - 1) * ext
    step = make_forward(tcfg, device=dev)
    ctx.mark("inputs")
    n_warm = tr["warmup_frames"]
    for k in range(n_warm):
        step(pos[k % n_pos], dirs, port)
        ctx.sync()
        if k < 2:
            ctx.mark(("first frame", "capture")[k])
    ctx.setup_done()

    # Frame i of the window is at position n_warm + i, the traced ones
    # after the window's.
    outs, pending = [], collections.deque()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        res, st = step(pos[(n_warm + len(outs)) % n_pos], dirs, port)
        outs.append((st, res.reverb_ir))
        del res
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > tr["in_flight"]:
                pending.popleft().synchronize()
    ctx.sync()
    t1 = time.perf_counter()
    ctx.values.update(rays=tcfg.ray_count * len(outs), window_s=t1 - t0)
    ctx.attempted = len(outs)

    u = float(torch.rand((), generator=scene.generator(ctx.seed + 2,
                                                       "cpu")))
    judged, base = outs, 0
    if ctx.trace:
        holder, traced = {}, []
        with devtrace.profiled(dev, holder):
            for k in range(tr["traced_frames"]):
                with torch.profiler.record_function("bench.frame"):
                    res, st = step(pos[(n_warm + len(outs) + k) % n_pos],
                                   dirs, port)
                traced.append((st, res.reverb_ir))
                del res
        ctx.trace_data = holder["trace"]
        judged, base = traced, len(outs)
    j = min(int(u * len(judged)), len(judged) - 1)
    ctx.values["judged_frame"] = j
    settings, ir = judged[j]
    if dev.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del step, outs, judged
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference.frame(layout, pos[(n_warm + base + j) % n_pos],
                          ctx.config["trace"], dev, directions=dirs)
    ctx.log(f"reference: frame {base + j} in "
            f"{time.perf_counter() - t_ref:.2f} s")
    ctx.counts = dict(ref["counts"], prims=(sc["spheres"], sc["aabbs"],
                                            sc["obbs"]))
    gaps = judge.frame_gaps(settings, ir, ref)
    ctx.numbers = dict(judge.summarize([gaps]), missing=0)
    ctx.failed = judge.failed_frames([gaps], ctx.limits)
