"""The materials cell, ``calib_1m.materials_step``: a run on the CPU at a
small size (OBBs included) is correct; its control, a step with a wrong
gradient, one that skips Adam and one at another learning rate are not;
its five per-layer readers read a synthetic trace, and on a card (tests
marked ``card``) a traced run reports them."""

import json
import types

import pytest
import torch

from harness import chord_roofline, devtrace, loader, roofline, runner

CELL = "calib_1m.materials_step"
SMALL = dict(
    config=dict(scene=dict(spheres=12, aabbs=20, obbs=8, extent=20.0),
                trace=dict(ray_count=2048, num_reverb_bins=16)),
    traffic=dict(warmup_steps=1, traced_steps=2))
METRICS = ("loss_ms.materials", "backward_ms.materials", "adam_ms.materials",
           "permeation_ms.materials", "b4_roofline.materials")


def run_small(control=False, seed=3_000_000_019, trace=False,
              device="cpu"):
    return runner.run_cell(CELL, seed, 0.3, trace, device=device,
                           control=control, overrides=SMALL)


def test_a_small_run_is_correct():
    out = run_small()
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"rays_per_s", "setup_s"}
    assert set(out["checks"]) == {
        "loss_gap", "grad_gap", "grad_gap_median", "muffle_gap",
        "permeation_gap", "reverb_gap", "ir_gap", "update_gap", "missing"}


def test_a_traced_run_judges_one_of_its_traced_steps(monkeypatch):
    """B4's roofline reads the judged step among the traced steps' spans.
    On the CPU no kernel is traced: each step's span stands as a frame,
    and B4's time in it is set to a second."""
    monkeypatch.setattr(devtrace.Trace, "frames",
                        lambda self, name: self.per_span(name))
    monkeypatch.setattr(chord_roofline, "b4_seconds", lambda frame: 1.0)
    out = run_small(trace=True)
    assert out["correct"] is True, out["checks"]
    assert "b4_roofline.materials" in out["metrics"]


def test_the_control_is_not_correct():
    out = run_small(control=True)
    assert out["correct"] is False, out["checks"]
    checks = out["checks"]
    assert any(c["value"] >= 2 * c["limit"] for c in checks.values()
               if c["limit"] > 0), checks


def test_a_step_that_skips_adam_is_not_correct(monkeypatch):
    """The optimizer's update left out: the tensors do not move, and the
    update reads 1."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self: None)
    out = run_small()
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)
    assert out["checks"]["grad_gap"]["value"] <= \
        out["checks"]["grad_gap"]["limit"]


def test_a_step_with_another_learning_rate_is_not_correct(monkeypatch):
    """Adam at a tenth of the configuration's rate."""
    from audio_raytracer_tpu_torch.models import differentiable

    real = differentiable.adam
    monkeypatch.setattr(differentiable, "adam",
                        lambda lr=1e-2: real(lr / 10))
    out = run_small()
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["update_gap"]["value"] > 0.5


def test_a_wrong_gradient_is_not_correct(monkeypatch):
    """The step's absorption gradients zeroed after its backward, before
    Adam: the judged step's gradients are wrong."""
    from audio_raytracer_tpu_torch.models import differentiable

    real = differentiable._backward

    def backward(loss, leaves):
        real(loss, leaves)
        for x in leaves[::3]:
            x.grad.zero_()

    monkeypatch.setattr(differentiable, "_backward", backward)
    out = run_small()
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["grad_gap"]["value"] >= 1.0


def test_the_rays_that_resolve_alike_agree_to_rounding(capsys):
    """``tools/parted_rays.py`` at a small size: on the rays that resolve
    alike in the program and the reference, the map, the loss and every
    gradient at the program's map agree to float32 rounding."""
    from tools import parted_rays

    assert parted_rays.main(["--device", "cpu", "--rays", "2048",
                             "--scene", "12,20,8,20", "--seeds", "11",
                             "--steps", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["parted"] < 2048 // 100
    alike = out["alike"]
    assert alike["loss_gap"] < 1e-5
    assert max(alike[f] for f in ("muffle", "permeation", "reverb_energy",
                                  "reverb_ir")) < 1e-7
    assert max(alike["at"]) < 1e-5


def X(cat, name, ts, dur, corr=None, tid=1):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=1)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def step_events(t0, corr, b4_us):
    """One traced step: a graph launch whose kernels hold the step's
    markers, the map's nested inside ``step.loss``."""
    ev = [X("user_annotation", "bench.frame", t0, 2000),
          X("cuda_runtime", "cudaGraphLaunch", t0 + 5, 5, corr=corr)]
    t = [t0 + 10]

    def k(name, dur):
        ev.append(X("kernel", name, t[0], dur, corr=corr, tid=7))
        t[0] += dur

    def mark(span, end):
        k(f"art_span_{span}_{'end' if end else 'begin'}"
          "(unsigned long long*)", 1)

    mark("step_loss", 0)
    k("void at::native::fill_kernel<1>(int)", 4)
    k("closest_hit_kernel", 30)
    k("multi_any_hit_kernel", 300)
    mark("map_permeation", 0)
    k("void multi_chord_kernel<8>(float const*)", 60)
    k("void at::native::reduce_kernel<1>(int)", 5)
    mark("map_permeation", 1)
    k("void at::native::indexFuncLargeIndex<float>(int)", 10)
    mark("step_loss", 1)
    mark("step_backward", 0)
    k("void multi_chord_dens_bwd_kernel<8>(float const*)", b4_us)
    k("void at::native::elementwise_kernel<4>(int)", 40)
    mark("step_backward", 1)
    mark("step_adam", 0)
    k("void at::native::multi_tensor_apply_kernel<1>(int)", 3)
    mark("step_adam", 1)
    return ev


def test_the_five_readers_on_a_synthetic_trace():
    ev = [X("user_annotation", "bench.traced", 0, 10_000)]
    ev += step_events(100, 1, 50) + step_events(3000, 2, 70)
    t = devtrace.Trace(ev, {"B1": ["closest_hit_kernel"]})
    counts = dict(hitting=1000, sets=8, prims=(1024, 2048, 1024))
    ctx = types.SimpleNamespace(trace_data=t, values=dict(judged_step=1),
                                samples={}, counts=counts)
    got = {m: loader.metric(m).read(ctx) for m in METRICS}
    assert got["loss_ms.materials"] == pytest.approx(1e-3 * (4 + 30 + 300
                                                             + 60 + 5 + 10))
    assert got["backward_ms.materials"] == pytest.approx(1e-3 * (60 + 40))
    assert got["adam_ms.materials"] == pytest.approx(3e-3)
    assert got["permeation_ms.materials"] == pytest.approx(65e-3)
    least, _ = roofline.least_s(*chord_roofline.b4_counts(
        counts["prims"], 1000, 8))
    assert got["b4_roofline.materials"] == pytest.approx(100 * least / 70e-6)
    # A program without the map's spans (the parent of this cell) reads
    # nothing for them, and the rest as before.
    old = devtrace.Trace([e for e in ev if "map_" not in e["name"]],
                         {"B1": ["closest_hit_kernel"]})
    ctx.trace_data = old
    assert loader.metric("permeation_ms.materials").read(ctx) is None
    assert loader.metric("loss_ms.materials").read(ctx) == \
        pytest.approx(got["loss_ms.materials"])
    ctx.trace_data = None
    assert all(loader.metric(m).read(ctx) is None for m in METRICS)


def test_b4_counts_and_name():
    assert chord_roofline.is_b4("void multi_chord_dens_bwd_kernel<8>(int)")
    assert not chord_roofline.is_b4("multi_chord_kernel")
    assert not chord_roofline.is_b4("multi_chord_dens_bwd_kernel_v2")
    ops, nbytes = chord_roofline.b4_counts((1, 1, 1), 10, 2)
    assert ops == 10 * ((9 + 36) + (7 + 46) + (28 + 88))
    assert nbytes == 10 * 16 * 3 + (24 + 4) + (32 + 4) + (48 + 4)


@pytest.mark.card
def test_a_traced_run_on_the_card_reports_the_five():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run_small(trace=True, device="cuda")
    assert out["correct"] is True, out["checks"]
    assert set(METRICS) <= set(out["metrics"])
    # At 2,048 rays B4 is one launch's latency: a small share.
    assert 0.0 < out["metrics"]["b4_roofline.materials"]["value"] <= 100.0
