"""The port's spans (``utils/profiling.py``): host ranges around what runs
outside a captured graph, device spans around a frame's stages and a
training step's, and the count of the frame path's host waits.

The CPU tests run a ``FrameGraph`` on the CPU, where each device span
opens its host range alone. The tests marked ``card`` need a CUDA device
and skip without one; this file imports nothing of the JAX package, so on
the card they run alone:

    python -m pytest tests/test_torch_spans.py -m card --noconftest -q
"""

import dataclasses
import json
import os
import re
import warnings

import pytest
import torch

from audio_raytracer_tpu_torch.models.differentiable import (
    SceneParams,
    loudness_map,
    make_train_step,
)
from audio_raytracer_tpu_torch.models.frame_graph import (
    FrameGraph,
    frame_skip_sets,
)
from audio_raytracer_tpu_torch.models.raytracer import (
    demo_inputs,
    random_scene,
)
from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.runtime import AsyncRaytraceLoop, SceneRegistry
from audio_raytracer_tpu_torch.types import TraceConfig
from audio_raytracer_tpu_torch.utils import profiling

CPU = "cpu"
CFG = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=150.0,
                  num_reverb_bins=16)
H = CFG.max_hits_per_ray
# A frame's device spans in the order they begin.
STAGES = (["frame", "trace"] + ["trace.bounce"] * H
          + ["permeation", "reverb", "process"])


def scene(seed=0, targets=2, device=CPU):
    return random_scene(seed, 3, 4, 3, num_targets=targets, extent=8.0,
                        device=device)


def profiled_names(fn):
    """The ``art.`` host ranges ``fn`` opened, as (name, start, end) in
    the order they began."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    evs = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("art.")]
    return sorted(evs, key=lambda e: (e[1], -e[2]))


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_frame_under_the_profiler_names_its_steps():
    fg = FrameGraph(CFG, device=CPU)
    o, d = demo_inputs(CFG, device=CPU)
    fg(o, d, scene())
    fg(o, d, scene())  # the capture
    evs = profiled_names(lambda: fg(o, d, scene(1)))
    names = [n for n, _, _ in evs]
    syncs = 1 + 6 * len(frame_skip_sets(2))
    assert names == (
        ["art.frame.call", "art.refill", "art.refill.scene_copy",
         "art.refill.engine_build"] + ["art.sync"] * syncs
        + ["art.refill.copy_in", "art.replay"]
        + ["art." + s for s in STAGES] + ["art.copy_out"])
    by = {}
    for e in evs:
        by.setdefault(e[0], []).append(e)
    call, refill = by["art.frame.call"][0], by["art.refill"][0]
    assert inside(refill, call) and inside(by["art.replay"][0], call)
    for step in ("scene_copy", "engine_build", "copy_in"):
        assert inside(by["art.refill." + step][0], refill)
    assert all(inside(s, by["art.refill.engine_build"][0])
               for s in by["art.sync"])
    frame = by["art.frame"][0]
    assert inside(frame, by["art.replay"][0])
    for s in ("trace", "permeation", "reverb", "process"):
        assert inside(by["art." + s][0], frame)
    bounces = by["art.trace.bounce"]
    assert len(bounces) == H
    assert all(inside(b, by["art.trace"][0]) for b in bounces)
    assert all(a[2] <= b[1] for a, b in zip(bounces, bounces[1:]))


def test_the_loop_and_a_training_step_name_theirs():
    reg = SceneRegistry()
    reg.add_target([1.0, 0.5, 0.0])
    reg.add_aabb([3.0, 0.0, 0.0], [1.0, 1.0, 1.0], (0.1, 1.0, 1.0))
    loop = AsyncRaytraceLoop(reg, CFG, device=CPU)
    loop.tick([0.0, 0.0, 0.0])
    names = [n for n, _, _ in profiled_names(
        lambda: loop.tick([0.5, 0.0, 0.0]))]
    for n in ("art.tick", "art.harvest", "art.snapshot", "art.dispatch",
              "art.frame"):
        assert n in names, n
    assert names.index("art.harvest") < names.index("art.snapshot") \
        < names.index("art.dispatch")

    sc = scene(targets=1)
    o, d = demo_inputs(CFG, device=CPU)
    with torch.no_grad():
        target = loudness_map(o, d, sc, CFG, device=CPU)
    step, init = make_train_step(CFG, device=CPU)
    params = SceneParams.from_scene(sc)
    opt = init(params)
    names = [n for n, _, _ in profiled_names(
        lambda: step(params, opt, sc, o, d, target))]
    assert [n for n in names if n.startswith("art.step.")] == \
        ["art.step.loss", "art.step.backward", "art.step.adam"]


def test_without_the_profiler_no_range_is_entered(monkeypatch):
    def entered(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    fg = FrameGraph(CFG, device=CPU)
    o, d = demo_inputs(CFG, device=CPU)
    for seed in range(3):
        fg(o, d, scene(seed))
    reg = SceneRegistry()
    reg.add_target([1.0, 0.5, 0.0])
    loop = AsyncRaytraceLoop(reg, CFG, device=CPU)
    for _ in range(2):
        loop.tick([0.0, 0.0, 0.0])
    assert fg.replays == 2 and loop.frames_harvested == 1


@pytest.mark.parametrize("targets", [0, 1, 3, 16])
def test_a_refill_counts_its_host_waits(targets):
    fg = FrameGraph(CFG, device=CPU)
    o, d = demo_inputs(CFG, device=CPU)
    groups = len(frame_skip_sets(targets))
    sc = scene(targets=targets)
    for k in range(3):
        before = K.host_syncs
        fg(o, d, sc if k == 2 else scene(k, targets=targets))
        # The winner tables' copy from host data, and two row selections
        # per type (spheres, AABBs, OBBs) for each group of B2's skip sets.
        assert K.host_syncs - before == 1 + 6 * groups
    before = K.host_syncs
    fg(o, d, sc, reuse_scene=True)
    assert K.host_syncs == before


def test_span_names_map_to_markers_and_back():
    names = [m for s in profiling.SPANS for m in profiling.marker_names(s)]
    assert len(set(names)) == 2 * len(profiling.SPANS)
    for s in profiling.SPANS:
        begin, end = profiling.marker_names(s)
        assert profiling.marker_span(begin) == (s, False)
        assert profiling.marker_span(end) == (s, True)
        assert profiling.marker_span(
            f"void {end}(unsigned long long*)") == (s, True)
    assert profiling.marker_span("closest_hit_kernel") is None
    assert profiling.marker_span("art_span_frame_ended") is None
    with pytest.raises(ValueError):
        profiling.marker_names("bounce")
    # csrc/spans.cu makes one begin and one end kernel per span, in
    # SPANS' order (its index is the span's).
    with open(os.path.join(build.CSRC_DIR, "spans.cu")) as f:
        src = f.read()
    listed = re.search(r"#define ART_SPANS\(X\)(.*?)\n\n", src, re.S)
    got = re.findall(r"X\((\w+)\)", listed.group(1))
    assert got == [s.replace(".", "_") for s in profiling.SPANS]
    assert "spans" in build.SOURCES


def test_totals_read_a_span_buffer():
    buf = profiling.span_buffer(CPU)
    assert buf.shape == (len(profiling.SPANS), profiling.WORDS)
    assert profiling.totals(buf) == {} == profiling.totals(None)
    i = profiling.SPANS.index("reverb")
    buf[i] = torch.tensor([123, 2_500_000, 2])  # stamp, ns, count
    assert profiling.totals(buf) == {"reverb": (2, 2.5)}


def test_the_device_spans_switch_is_in_the_key():
    fg = FrameGraph(CFG, device=CPU)
    o, d = demo_inputs(CFG, device=CPU)
    sc = scene()
    fg(o, d, sc)
    fg(o, d, sc, reuse_scene=True)
    key = fg.key
    try:
        profiling.set_device_spans(False)
        fg(o, d, sc, reuse_scene=True)
        assert fg.key != key and fg.warmups == 2
        fg(o, d, sc, reuse_scene=True)
        assert fg.captures == 2
    finally:
        profiling.set_device_spans(True)
    fg(o, d, sc, reuse_scene=True)
    assert fg.key == key and fg.warmups == 3


def test_the_cpu_launches_no_marker(monkeypatch):
    def launched(*a):
        raise AssertionError("a marker launched on the CPU")

    monkeypatch.setattr(profiling, "_mark", launched)
    fg = FrameGraph(CFG, device=CPU)
    o, d = demo_inputs(CFG, device=CPU)
    fg(o, d, scene())
    assert fg.span_totals() == {} and profiling.span_totals(CPU) == {}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_CFG = TraceConfig(ray_count=262144, max_bounces=4, max_ray_life=300.0,
                       num_reverb_bins=64)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def frame_markers(cfg):
    """(span, is the end) of every marker of one frame, in launch
    order."""
    one = [("frame", False), ("trace", False)]
    for step in range(cfg.max_hits_per_ray):
        one.append(("trace.bounce", False))
        if cfg.compact_rays and step > 0:
            one += [("trace.compact", False), ("trace.compact", True)]
            if not cfg.compact_unordered:
                one += [("trace.restore", False), ("trace.restore", True)]
        one.append(("trace.bounce", True))
    one.append(("trace", True))
    for s in ("permeation", "reverb", "process"):
        one += [(s, False), (s, True)]
    return one + [("frame", True)]


def test_compaction_names_its_reorder():
    for unordered in (False, True):
        cfg = dataclasses.replace(CFG, compact_rays=True,
                                  compact_unordered=unordered)
        fg = FrameGraph(cfg, device=CPU)
        o, d = demo_inputs(cfg, device=CPU)
        evs = profiled_names(lambda: fg(o, d, scene()))
        got = [(n[4:], False) for n, _, _ in evs
               if n[4:] in profiling.SPANS]
        # The host ranges begin in the markers' order.
        assert got == [m for m in frame_markers(cfg) if not m[1]]


def card_frames(tmp_path, cfg=None, frames=3):
    """A frame graph at a bake's shape on a smaller scene, warmed up and
    captured, then ``frames`` replays (each a new position and a
    refill) under torch.profiler: (graph, span totals before and after,
    the trace's device kernels in time order)."""
    cfg = cfg or CARD_CFG
    dev = torch.device("cuda")
    sc = random_scene(0, 64, 128, 64, num_targets=4, extent=40.0,
                      size_range=(0.5, 4.0), device=dev)
    o, d = demo_inputs(cfg, device=dev)
    fg = FrameGraph(cfg, device=dev)
    for _ in range(2):
        fg(o, d, sc)
    torch.cuda.synchronize()
    before = fg.span_totals()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(frames):
            fg(o + 0.5 * (k + 1), d, sc)
        torch.cuda.synchronize()
    after = fg.span_totals()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    return fg, before, after, kernels


@pytest.mark.card
@pytest.mark.parametrize("compact", [False, True],
                         ids=["plain", "compacted"])
def test_replayed_frames_carry_every_marker(tmp_path, compact):
    need_card()
    cfg = dataclasses.replace(CARD_CFG, compact_rays=compact)
    fg, before, after, kernels = card_frames(tmp_path, cfg)
    assert fg.replays == 4  # the capture's and the three profiled
    got = [profiling.marker_span(e["name"]) for e in kernels]
    got = [m for m in got if m is not None]
    one = frame_markers(cfg)
    assert got == one * 3
    ends = [s for s, end in one if end]
    for s in set(ends):
        assert after[s][0] - before[s][0] == 3 * ends.count(s)


@pytest.mark.card
def test_span_totals_agree_with_the_profiler(tmp_path):
    need_card()
    fg, before, after, kernels = card_frames(tmp_path)
    begun, spent = {}, {}
    for e in kernels:
        m = profiling.marker_span(e["name"])
        if m is None:
            continue
        s, end = m
        if end:
            spent[s] = spent.get(s, 0.0) + (e["ts"] - begun.pop(s)) * 1e-3
        else:
            begun[s] = e["ts"]
    for s, ms in spent.items():
        count, total = after[s][0] - before[s][0], after[s][1] - before[s][1]
        assert count > 0
        assert total == pytest.approx(ms, rel=0.05), s


@pytest.mark.card
def test_host_syncs_are_every_wait_of_a_refill():
    need_card()
    dev = torch.device("cuda")
    o, d = demo_inputs(CARD_CFG, device=dev)
    fg = FrameGraph(CARD_CFG, device=dev)
    for seed in range(2):  # the warm-up and the capture
        fg(o, d, random_scene(seed, 64, 128, 64, num_targets=8, device=dev))
    sc = random_scene(2, 64, 128, 64, num_targets=8, device=dev)
    torch.cuda.synchronize()
    before = K.host_syncs
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fg(o, d, sc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # A replayed frame's only waits are its refill's: the winner tables'
    # copy from host data, and two row selections per type for B2's one
    # group of 9 skip sets.
    waits = [w for w in caught if "synchroniz" in str(w.message)]
    assert K.host_syncs - before == len(waits) == 7
