"""The readers of the program's own spans (``harness/spans.py``) and the
bake's five metrics built on them, on a synthetic Chrome trace."""

import types

import pytest

from harness import devtrace, loader, spans

TABLE = {"B1": ["closest_hit_kernel"], "B2": ["multi_any_hit_kernel"],
         "B3": ["multi_chord_kernel"]}
METRICS = ("trace_ms.bake", "permeation_ms.bake", "reverb_ms.bake",
           "host_syncs.bake", "refill_idle_ms.bake")


def X(cat, name, ts, dur, corr=None, tid=1):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=1)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def frame(t0, corr, markers=True, host=True):
    """One traced frame from ``t0`` us: a refill on the host (two host
    waits, a glue kernel, the device idle 150 us under the second wait),
    then one graph launch whose kernels hold the stage markers."""
    mark = (lambda n, ts: [X("kernel", f"art_span_{n}(unsigned long long*)",
                             ts, 2, corr=corr, tid=7)]) if markers else \
        (lambda n, ts: [])
    ev = [X("user_annotation", "bench.frame", t0, 1000)]
    if host:
        ev += [X("user_annotation", "art.frame.call", t0 + 5, 990),
               X("user_annotation", "art.refill", t0 + 10, 300),
               X("user_annotation", "art.sync", t0 + 20, 10),
               X("user_annotation", "art.sync", t0 + 100, 150),
               X("user_annotation", "art.replay", t0 + 400, 20)]
    ev += [X("cuda_runtime", "cudaLaunchKernel", t0 + 12, 3, corr=corr - 1),
           X("kernel", "void at::native::elementwise_kernel<4>(int)",
             t0 + 40, 60, corr=corr - 1, tid=7),
           X("cuda_runtime", "cudaGraphLaunch", t0 + 405, 5, corr=corr)]
    # Device: idle 100..250 (under the second art.sync, in the refill),
    # then the graph from 250.
    ev += mark("frame_begin", t0 + 250) + mark("trace_begin", t0 + 252)
    ev += mark("trace_bounce_begin", t0 + 254)
    ev += [X("kernel", "closest_hit_kernel", t0 + 256, 100, corr=corr,
             tid=7)]
    ev += mark("trace_bounce_end", t0 + 356)
    ev += [X("kernel", "multi_any_hit_kernel", t0 + 358, 200, corr=corr,
             tid=7)]
    ev += mark("trace_end", t0 + 558) + mark("permeation_begin", t0 + 560)
    ev += [X("kernel", "multi_chord_kernel", t0 + 562, 30, corr=corr,
             tid=7)]
    ev += mark("permeation_end", t0 + 592) + mark("reverb_begin", t0 + 594)
    ev += [X("kernel", "void at::native::indexFuncLargeIndex<float>(int)",
             t0 + 596, 40, corr=corr, tid=7)]
    ev += mark("reverb_end", t0 + 636) + mark("process_begin", t0 + 638)
    ev += [X("kernel", "void at::native::reduce_kernel<1>(int)", t0 + 640,
             8, corr=corr, tid=7)]
    ev += mark("process_end", t0 + 648) + mark("frame_end", t0 + 650)
    return ev


def synthetic(**kw):
    return ([X("user_annotation", "bench.traced", 0, 2100)]
            + frame(50, 11, **kw) + frame(1050, 21, **kw))


def ctx_of(trace):
    return types.SimpleNamespace(trace_data=trace, values={}, samples={},
                                 counts=None)


def test_markers_are_read_by_name():
    assert spans.marker("art_span_trace_bounce_begin(unsigned long long*)") \
        == ("trace_bounce", "begin")
    assert spans.marker("void art_span_frame_end") == ("frame", "end")
    assert spans.marker("art_span_frame_ended") is None
    assert spans.marker("closest_hit_kernel") is None


def test_stages_hold_what_runs_between_their_markers():
    t = devtrace.Trace(synthetic(), TABLE)
    # The trace stage holds B1 and B2, not the bounce's markers.
    assert spans.stage_ms(t, "trace") == pytest.approx(0.3)
    assert spans.stage_ms(t, "trace.bounce") == pytest.approx(0.1)
    ctx = ctx_of(t)
    got = {m: loader.metric(m).read(ctx) for m in METRICS}
    assert got["trace_ms.bake"] == pytest.approx(0.3)
    assert got["permeation_ms.bake"] == pytest.approx(0.03)
    assert got["reverb_ms.bake"] == pytest.approx(0.04)
    # The four stages sum to the frame's span, markers left out.
    stages = sum(spans.stage_ms(t, s) for s in ("trace", "permeation",
                                                "reverb", "process"))
    assert stages == pytest.approx(spans.stage_ms(t, "frame"))


def test_host_waits_and_the_refills_idle():
    t = devtrace.Trace(synthetic(), TABLE)
    ctx = ctx_of(t)
    assert loader.metric("host_syncs.bake").read(ctx) == 2.0
    # Each frame's device idles 150 us between its refill's glue kernel
    # and its graph, with the middle of that stretch inside art.refill;
    # the stretches before, between and after the frames lie outside.
    idle = loader.metric("refill_idle_ms.bake").read(ctx)
    assert idle == pytest.approx(1e-3 * (150 + 150) / 2)


def test_a_program_without_spans_reads_none():
    bare = devtrace.Trace(synthetic(markers=False, host=False), TABLE)
    for m in METRICS:
        assert loader.metric(m).read(ctx_of(bare)) is None, m
        assert loader.metric(m).read(ctx_of(None)) is None, m
    # Markers without host spans, and the other way round.
    no_host = devtrace.Trace(synthetic(host=False), TABLE)
    assert loader.metric("host_syncs.bake").read(ctx_of(no_host)) is None
    assert loader.metric("trace_ms.bake").read(ctx_of(no_host)) == \
        pytest.approx(0.3)
    no_marks = devtrace.Trace(synthetic(markers=False), TABLE)
    assert loader.metric("reverb_ms.bake").read(ctx_of(no_marks)) is None
    assert loader.metric("host_syncs.bake").read(ctx_of(no_marks)) == 2.0


def test_a_stage_missing_from_one_frame_reads_none():
    events = [e for e in synthetic()
              if not (e["name"].startswith("art_span_reverb_end")
                      and e["ts"] > 1000)]
    t = devtrace.Trace(events, TABLE)
    assert spans.stage_ms(t, "reverb") is None
    assert spans.stage_ms(t, "trace") == pytest.approx(0.3)
