"""Driver: an engine ticking the program's real-time loop on a schedule.

The program's ``AsyncRaytraceLoop`` over its ``SceneRegistry``, filled
with the configuration's scene drawn from the seed, ticked open-loop at
``rate_hz`` for the run's seconds: tick k is due at start + k / rate,
whatever the ticks before it took. Before each tick the listener steps
along a closed path through seeded waypoints and, with ``mover``, one
AABB walks its waypoint loop on the engine's fixed step (the upstream
Sample Scene's PlatformMover), written through the registry's
``update_aabb`` on each tick that a fixed step has moved it since the
last. The pacer polls the clock between ticks (``harness/schedule.py``).
Set-up fills the registry, makes the loop and ticks it ``warmup_ticks``
times back to back, each waited for, by when its frame graph has to be
captured and replaying. The layout comes from the configuration's
``layout_seed`` (else the seed); the seed draws the path (seed + 3) and
the judged frames (seed + 1).

Samples: ``tick_ms`` (due time to the return of ``tick``), ``late_ms``
(how late each tick began), ``frame_ms`` (the loop's ``raytracer_ms`` of
each frame harvested in the window), ``snapshot_ms`` (its
``batch_cycle_ms``) and ``replay_ms`` (its graph's) of each dispatching
tick; values: ``refill_ms`` (summed over the ticks whose refill count
rose) and ``frames_dispatched``.
With ``--trace`` a further ``traced_ticks`` ticks run on the schedule
under the profiler, each in a ``bench.tick`` span.

Correct: every frame dispatched in the window is harvested, and a sample
of ``judged_frames`` of them drawn from the seed is held against the
reference, traced for the scene rebuilt from the benchmark's own record
(the moved AABB's centre and the listener at that frame's dispatch).
"""

from __future__ import annotations

import time

import torch

from harness import devtrace, judge, scene
from harness.schedule import Pacer, tick_ms
from harness.stats import percentile
from reference import frame as reference


def _loop_parts(ctx):
    from audio_raytracer_tpu_torch.runtime import (
        AsyncRaytraceLoop,
        SceneRegistry,
    )
    from audio_raytracer_tpu_torch.types import TraceConfig

    return AsyncRaytraceLoop, SceneRegistry, TraceConfig(
        **{**ctx.config["trace"], "compute_dtype": ctx.compute_dtype})


def run(ctx):
    tr, sc = ctx.traffic, ctx.config["scene"]
    Loop, Registry, tcfg = _loop_parts(ctx)
    layout = scene.random_layout(sc.get("layout_seed", ctx.seed),
                                 sc["spheres"], sc["aabbs"], sc["obbs"],
                                 sc["targets"], sc["extent"],
                                 sc["size_range"], "cpu")
    rate = tr["rate_hz"]
    n_warm = tr["warmup_ticks"]
    n_win = int(round(ctx.seconds * rate))
    n_trace = tr["traced_ticks"] if ctx.trace else 0
    total = n_warm + n_win + n_trace + 1
    lis = tr["listener"]
    origins = scene.waypoint_path(ctx.seed + 3, total, lis["waypoints"],
                                  lis["extent"],
                                  lis["speed_m_per_s"] / rate).tolist()
    mover = tr.get("mover")
    reg = Registry()
    handles = scene.fill_registry(reg, layout)
    if mover:
        m = mover["aabb"]
        centers, moved = scene.mover_centres(
            layout["aabb_center"][m], mover["waypoints"], total, rate,
            mover["fixed_step_hz"], mover["speed_m_per_s"])
        half = layout["aabb_half"][m].tolist()
        mat = tuple(layout["aabb_mat"][m].tolist())

    ctx.mark("registry")
    loop = Loop(reg, tcfg, compute_async=tr["async"], device=ctx.device,
                graph=True)
    ctx.mark("loop")
    graph = loop.graph_frames
    tick_of = {}  # dispatch number -> tick index
    harvested = set()  # dispatch numbers harvested
    answers = {}  # judged dispatch number -> (settings, impulse response)
    judge_at = set()

    def move(i):
        """The scene's change before tick i; returns i."""
        if mover and moved[i]:
            reg.update_aabb(handles[m], centers[i], half, mat)
        return i

    def after(i, settings, h0, d0):
        h = loop.frames_harvested
        if h > h0:
            harvested.add(h)
            if h in judge_at:
                answers[h] = (settings, loop.reverb_ir)
        if loop.frames_dispatched > d0:
            tick_of[loop.frames_dispatched] = i

    # Set-up: back-to-back ticks, each waited for; by their end the
    # frame graph has to be captured and replaying.
    for i in range(n_warm):
        h0, d0 = loop.frames_harvested, loop.frames_dispatched
        after(move(i), loop.tick(origins[i]), h0, d0)
        ctx.sync()
        if i < 2:
            ctx.mark(("first tick", "capture")[i])
    if graph.replays < 2:
        raise RuntimeError(f"{n_warm} warm-up ticks replayed the frame graph "
                           f"{graph.replays} times")
    first = loop.frames_dispatched + 1
    # The judged frames, drawn from the seed among the window's possible
    # dispatches (one a tick at most); only their answers are kept.
    g = scene.generator(ctx.seed + 1, "cpu")
    judge_at.update(first + j for j in torch.randperm(
        n_win, generator=g)[:tr["judged_frames"]].tolist())
    ctx.setup_done()

    pacer = Pacer(rate)
    pacer.start()
    refills = graph.refills
    for k in range(n_win):
        i = move(n_warm + k)
        late = pacer.wait(k)
        h0, d0 = loop.frames_harvested, loop.frames_dispatched
        settings = loop.tick(origins[i])
        ctx.sample("tick_ms", tick_ms(pacer.due(k), time.perf_counter()))
        ctx.sample("late_ms", late * 1e3)
        if loop.frames_harvested > h0:
            ctx.sample("frame_ms", loop.raytracer_ms)
        if loop.frames_dispatched > d0:
            ctx.sample("snapshot_ms", loop.batch_cycle_ms)
            ctx.sample("replay_ms", graph.replay_ms)
        if graph.refills > refills:
            ctx.values["refill_ms"] = (ctx.values.get("refill_ms", 0.0)
                                       + graph.refill_ms)
            refills = graph.refills
        after(i, settings, h0, d0)
    last = loop.frames_dispatched
    ctx.values["frames_dispatched"] = last - first + 1
    ctx.attempted = n_win

    # The frame still in flight, harvested by one more tick.
    ctx.sync()
    i = n_warm + n_win
    h0, d0 = loop.frames_harvested, loop.frames_dispatched
    after(move(i), loop.tick(origins[i]), h0, d0)
    ctx.sync()
    ticks, late = ctx.samples["tick_ms"], ctx.samples["late_ms"]
    ctx.log(f"schedule: {n_win} ticks at {rate} Hz; tick ms p50 / p90 / "
            f"p95 / p99 / max " + " / ".join(
                f"{percentile(ticks, q):.4f}" for q in (50, 90, 95, 99, 100))
            + f"; late ms p50 {percentile(late, 50):.4f} max "
            f"{max(late):.4f}; replay ms p50 / p95 / max " + " / ".join(
                f"{percentile(ctx.samples['replay_ms'], q):.4f}"
                for q in (50, 95, 100))
            + "; tick ms p95 by 10 s: " + " ".join(
                f"{percentile(ticks[j:j + 10 * rate], 95):.3f}"
                for j in range(0, n_win, 10 * rate)))

    if n_trace:
        holder = {}
        with devtrace.profiled(ctx.device, holder):
            pacer.start()
            for k in range(n_trace):
                i = move(n_warm + n_win + 1 + k)
                with torch.profiler.record_function("bench.wait"):
                    pacer.wait(k)
                with torch.profiler.record_function("bench.tick"):
                    loop.tick(origins[i])
        ctx.trace_data = holder["trace"]

    if ctx.device.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    due = range(first, last + 1)
    missing = [d for d in due if d not in harvested]
    judged = dict(sorted(answers.items()))
    del loop, graph, answers
    reg.close()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    frames = []
    t_ref = time.perf_counter()
    for d, (settings, ir) in judged.items():
        i = tick_of[d]
        lay = scene.with_aabb(layout, m, centers[i]) if mover else layout
        ref = reference.frame(lay, origins[i], ctx.config["trace"],
                              ctx.device)
        frames.append(judge.frame_gaps(settings, ir, ref))
    ctx.numbers = dict(judge.summarize(frames), missing=len(missing))
    ctx.failed = len(missing) + judge.failed_frames(frames, ctx.limits)
    ctx.log(f"reference: {len(frames)} frames in "
            f"{time.perf_counter() - t_ref:.2f} s")

