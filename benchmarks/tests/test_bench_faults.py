"""A run judges the timed path: sound, it comes out correct; with the
path broken underneath (each fault a cell of one card can have), or with
the program in its next lower precision tier (the control), it does not.
The runs skip the look for a card and run on the CPU at a size a test
can hold, the cells' own limits deciding; the held-back loop cells
too."""

import dataclasses

import pytest
import torch

from harness import runner

SMALL = {
    "sample_scene.moving_60hz": dict(traffic=dict(
        warmup_ticks=3, judged_frames=6)),
    "sample_scene.static_60hz": dict(traffic=dict(
        warmup_ticks=3, judged_frames=6)),
    "bake_1m.frames": dict(
        config=dict(scene=dict(spheres=16, aabbs=32, obbs=16, extent=20.0),
                    trace=dict(ray_count=131072)),
        traffic=dict(warmup_frames=1)),
}
SECONDS = {"bake_1m.frames": 0.5}


@pytest.fixture
def run(bench_root):
    def run(cell, seed=424242, control=False):
        return runner.run_cell(cell, seed, SECONDS.get(cell, 0.4), False,
                               device="cpu", control=control,
                               overrides=SMALL[cell], root=bench_root)
    return run


def stale(real):
    """A frame that returns its state unchanged: the frame before's."""
    last = []

    def f(*a, **k):
        out = real(*a, **k)
        ret = last[0] if last else out
        last[:] = [out]
        return ret
    return f


def half_batch(real):
    """Half the rays left out, every mean over the rest."""
    def f(origin, directions, *a, **k):
        return real(origin, directions[:directions.shape[0] // 2], *a, **k)
    return f


def altered(real):
    """One answer altered where it is produced: target 0's muffle moved
    by 0.01 toward the middle of its range."""
    def f(*a, **k):
        s = real(*a, **k)
        m = s.muffle.clone()
        m[0] = m[0] + torch.where(m[0] > 0.5, -0.01, 0.01)
        return dataclasses.replace(s, muffle=m)
    return f


def plant(monkeypatch, fault):
    from audio_raytracer_tpu_torch.models import frame_graph, raytracer
    from audio_raytracer_tpu_torch.ops import process

    if fault is altered:
        monkeypatch.setattr(process, "process", fault(process.process))
        return
    wrapped = fault(raytracer.forward)
    monkeypatch.setattr(raytracer, "forward", wrapped)
    monkeypatch.setattr(frame_graph, "forward", wrapped)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(run, cell):
    out = run(cell)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_path_is_not_correct(monkeypatch, run, cell, fault):
    plant(monkeypatch, fault)
    out = run(cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(run, cell):
    out = run(cell, control=True)
    assert out["correct"] is False, out["checks"]
