"""The device trace's reduction on a synthetic Chrome trace."""

import types

import pytest

from harness import devtrace, loader

TABLE = {"B1": ["closest_hit_kernel"], "B2": ["multi_any_hit_kernel"],
         "B3": ["multi_chord_kernel", "multi_chord_split_kernel"]}


def X(cat, name, ts, dur, corr=None, tid=1):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=1)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """Two ticks: tick 1 launches a B1 kernel, a glue kernel and a copy
    (the copy's launch lies outside any span: assigned by time); tick 2
    launches a B2 kernel in a CUDA graph. A 100 us host op leaves the
    device idle inside tick 1."""
    return [
        X("user_annotation", "bench.traced", 0, 1000),
        X("user_annotation", "bench.tick", 10, 300),
        X("cpu_op", "aten::nonzero", 50, 100),
        X("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        X("cuda_runtime", "cudaLaunchKernel", 200, 5, corr=2),
        X("kernel", "void closest_hit_kernel<(C)0>(float const*, int)", 30,
          20, corr=1, tid=7),
        X("kernel", "void at::native::(anonymous namespace)::"
          "vectorized_elementwise_kernel<4>(int)", 210, 10, corr=2, tid=7),
        X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 250, 5, corr=99,
          tid=7),
        X("user_annotation", "bench.tick", 500, 100),
        X("cuda_runtime", "cudaGraphLaunch", 510, 5, corr=3),
        X("kernel", "multi_any_hit_kernel", 520, 40, corr=3, tid=7),
        X("kernel", "multi_any_hit_kernel_v2_lookalike", 570, 1, corr=3,
          tid=7),
        X("gpu_user_annotation", "bench.tick", 520, 40, tid=7),
    ]


def test_kernels_are_told_apart_by_whole_names():
    assert devtrace.classify("void closest_hit_kernel<0>(int)", TABLE) == "B1"
    assert devtrace.classify("multi_chord_split_kernel", TABLE) == "B3"
    assert devtrace.classify("multi_chord_bwd_kernel", TABLE) is None
    assert devtrace.classify("multi_any_hit_kernel_v2_lookalike",
                             TABLE) is None


def test_activities_go_to_the_span_that_launched_them():
    t = devtrace.Trace(synthetic(), TABLE)
    f1, f2 = t.per_span("bench.tick")
    assert [e.corr for e in f1] == [1, 2, 99]
    assert [e.corr for e in f2] == [3, 3]
    assert t.kernel_s(f1) == pytest.approx(20e-6)
    assert t.glue_s(f1) == pytest.approx(15e-6)
    assert t.kernel_s(f2, ["B2"]) == pytest.approx(40e-6)
    assert t.glue_s(f2) == pytest.approx(1e-6)


def test_busy_and_idle():
    t = devtrace.Trace(synthetic(), TABLE)
    assert t.window() == (0, 1000)
    assert t.busy_s(t.in_window(), 0, 1000) == pytest.approx(76e-6)
    assert devtrace.union_s([(0, 10), (5, 20), (30, 40)]) == \
        pytest.approx(30e-6)
    assert devtrace.gaps([(10, 20), (15, 30)], 0, 50) == [(0, 10), (30, 50)]
    b = t.breakdown()
    ops = dict(b["device_ops"])
    assert ops["multi_any_hit_kernel"] == pytest.approx(40e-6)
    assert ops["at::native::vectorized_elementwise_kernel"] == \
        pytest.approx(10e-6)
    idle = dict(b["idle_gaps"])
    # The stretch 50..210 us lies under aten::nonzero at its middle.
    assert idle["aten::nonzero"] == pytest.approx(160e-6)
    assert sum(idle.values()) == pytest.approx(1000e-6 - 76e-6)


def test_innermost_host_event():
    E = devtrace.Event
    host = [E("outer", "", 0, 100, None, 1), E("inner", "", 10, 20, None, 1),
            E("later", "", 50, 60, None, 1)]
    got = devtrace.innermost(host, [15, 30, 55, 150])
    assert [h.name if h else None for h in got] == \
        ["inner", "outer", "later", None]


def ctx_of(trace, **values):
    return types.SimpleNamespace(trace_data=trace, values=values,
                                 samples={}, counts=None)


def test_loop_readers_on_the_synthetic_trace():
    t = devtrace.Trace(synthetic(), TABLE)
    ctx = ctx_of(t)
    glue = loader.metric("glue_ms.loop").read(ctx)
    kern = loader.metric("kernel_ms.loop").read(ctx)
    assert glue == pytest.approx(1e3 * (15e-6 + 1e-6) / 2)
    assert kern == pytest.approx(1e3 * (20e-6 + 40e-6) / 2)
    idle = loader.metric("frame_idle_share.loop").read(ctx)
    # Frame 1 spans 30..255 us and is busy 35 of them; frame 2 spans
    # 520..571 and is busy 41.
    want = 100 * ((1 - 35 / 225) + (1 - 41 / 51)) / 2
    assert idle == pytest.approx(want)


def test_readers_find_nothing_without_a_trace():
    ctx = ctx_of(None)
    for name in ("glue_ms.loop", "kernel_ms.loop", "frame_idle_share.loop",
                 "glue_ms.bake", "b2_roofline.bake", "idle_share.bake"):
        assert loader.metric(name).read(ctx) is None
    empty = devtrace.Trace([X("user_annotation", "bench.traced", 0, 10)],
                           TABLE)
    assert loader.metric("idle_share.bake").read(ctx_of(empty)) is None


def test_b2_counts_and_roofline():
    from harness import roofline

    ops, nbytes = roofline.b2_counts((1, 1, 1), [10, 0], [20, 0])
    assert ops == 10 * (10 + 6 + 27) + 20 * (15 + 21 + 42)
    assert nbytes == 10 * 12 + 20 * 17 + (20 + 28 + 44)
    pk = dict(float32_flops=1e3, hbm_bytes_per_s=1e3)
    assert roofline.least_s(ops, nbytes, pk) == (ops / 1e3, "ops")
    assert roofline.least_s(1, 5000, pk) == (5.0, "bytes")
    ops1, _ = roofline.b1_counts((2, 3, 4), [100])
    assert ops1 == 100 * (2 * 19 + 3 * 27 + 4 * 69)


def test_b2_roofline_reads_the_judged_frame():
    from harness import roofline

    ev = [X("user_annotation", "bench.traced", 0, 1000)]
    for f, (start, dur) in enumerate(((10, 40), (200, 80))):
        ev += [X("user_annotation", "bench.frame", start, 100),
               X("cuda_runtime", "cudaGraphLaunch", start + 1, 1,
                 corr=f + 1),
               X("kernel", "multi_any_hit_kernel", start + 5, dur,
                 corr=f + 1, tid=7)]
    t = devtrace.Trace(ev, TABLE)
    counts = dict(prims=(1024, 2048, 1024), live=[800_000] * 5,
                  open_pairs=[4_000_000] * 5)
    ctx = ctx_of(t, judged_frame=1)
    ctx.counts = counts
    least, _ = roofline.least_s(*roofline.b2_counts(
        counts["prims"], counts["live"], counts["open_pairs"]))
    got = loader.metric("b2_roofline.bake").read(ctx)
    assert got == pytest.approx(100 * least / 80e-6)
