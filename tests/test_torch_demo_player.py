"""The port's scene player, WAV render and visualizer, on the CPU.

Mirrors TestScenePlayer (but ``test_simulate_over_mesh``, which waits for
the port's distribution slice), TestMovingTarget and TestVisualize of
tests/test_demo.py on ``audio_raytracer_tpu_torch.demo``, and holds the
port to the JAX package on the same inputs:

- ``simulate`` (kernel and dense backends) against the JAX ``simulate``
  (jnp) on the sample scene at 48 rays, 2 bounces, 12 frames, within
  the loop limits of tests/test_torch_runtime.py: muffle rtol / atol
  1e-5, reverb fields 1e-4, the IR rtol 1e-3 / atol 1e-2, listener and
  perceived positions exact. ``frame_ms`` is a host time: its shape only.
- ``AsyncRaytraceLoop(backend="dense")`` against the JAX loop on "jnp",
  within the same limits.
- ``render_wav`` of one history in both packages: each target's signal
  agrees within test_torch_dsp.py's rtol 2e-3 / atol 2e-4, so the mix of
  T targets within rtol 2e-3 / atol T x 2e-4 of full scale; the peak
  normalisation divides by a peak that moves by up to rtol 2e-3 too, and
  the int16 conversion truncates (1 LSB). Limit on the samples: rtol
  4e-3, atol 32767 x T x 2e-4 + 1.

Entry points run on the card unless asked for the CPU: with
``torch.cuda.is_available`` patched to False they raise or exit non-zero.
"""

import json
import wave

import jax
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.demo import scene_format as JF
from audio_raytracer_tpu.demo import scene_player as JP
from audio_raytracer_tpu.runtime import AsyncRaytraceLoop as JLoop
from audio_raytracer_tpu.runtime import SceneRegistry as JRegistry
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch.demo import scene_player
from audio_raytracer_tpu_torch.demo.sample_scene import sample_scene_dict
from audio_raytracer_tpu_torch.demo.scene_format import build_registry
from audio_raytracer_tpu_torch.demo.scene_player import render_wav, simulate
from audio_raytracer_tpu_torch.runtime import (
    AsyncRaytraceLoop,
    SceneRegistry,
)
from audio_raytracer_tpu_torch.types import TraceConfig

torch.set_num_threads(1)

CPU = "cpu"
PARITY = dict(ray_count=48, max_bounces=2)
PARITY_FRAMES, PARITY_DT = 12, 0.1


def pcm(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()),
                             np.int16).astype(np.float64)


def sim(doc, frames, dt, **kw):
    loaded = build_registry(doc)
    history = simulate(loaded, frames=frames, dt=dt, verbose=False,
                       device=CPU, **kw)
    return loaded, history


# ---------------------------------------------------------------------------
# TestScenePlayer of tests/test_demo.py
# ---------------------------------------------------------------------------


class TestScenePlayer:
    def test_simulation_runs_and_platform_moves(self):
        loaded, history = sim(sample_scene_dict(ray_count=48, max_bounces=2),
                              12, 0.1)
        assert history["muffle"].shape == (12, 2)
        # Settings populated after the first harvest.
        assert np.any(history["muffle"][2:] > 0) or np.any(
            history["reverb_volume"] > 0)
        # The animated platform actually moved.
        anim = loaded.animations[0]
        assert not np.allclose(anim.position, anim.waypoints[0])
        loaded.registry.close()

    def test_listener_waypoint_path(self):
        doc = {
            "trace": {"ray_count": 32, "max_bounces": 1},
            "listener": {"position": [0, 0, 0], "speed": 10.0,
                         "waypoints": [[10, 0, 0], [10, 0, 10]]},
            "colliders": [{"type": "aabb", "center": [0, -2, 0],
                           "half_extents": [30, 0.5, 30]}],
            "targets": [{"position": [0, 0, 5]}],
        }
        loaded, history = sim(doc, 8, 0.1)
        assert loaded.listener_animation is not None
        # 8 frames x 10 u/s x 0.1 s = 8 units along +x from the origin.
        np.testing.assert_allclose(history["listener"][-1], [8, 0, 0],
                                   atol=1e-5)
        assert not np.allclose(history["listener"][0],
                               history["listener"][-1])
        loaded.registry.close()

    def test_viz_every_dumps_live_frames(self, tmp_path):
        out = tmp_path / "live.png"
        loaded, _ = sim(sample_scene_dict(ray_count=32, max_bounces=1), 5,
                        0.05, viz_every=2, viz_path=str(out))
        for f in (0, 2, 4):
            p = tmp_path / f"live_{f:04d}.png"
            assert p.stat().st_size > 10_000, p
        loaded.registry.close()

    def test_wav_render(self, tmp_path):
        loaded, history = sim(sample_scene_dict(ray_count=32, max_bounces=1),
                              4, 0.05)
        # The sample scene records an impulse response, so the render
        # goes through the convolution reverb-tail stage.
        assert "reverb_ir" in history
        out = tmp_path / "demo.wav"
        render_wav(loaded, history, str(out), sample_rate=8000, dt=0.05,
                   device=CPU)
        data = out.read_bytes()
        assert len(data) > 44  # non-empty PCM payload
        assert data[:4] == b"RIFF"
        loaded.registry.close()

    def test_wav_reverb_tail_audible(self, tmp_path):
        # The IR-driven tail must change the rendered audio against a
        # tail-less render of the same history.
        loaded, history = sim(sample_scene_dict(ray_count=64, max_bounces=2),
                              6, 0.05)
        assert history["reverb_ir"].sum() > 0  # echoes landed in bins
        out_wet = tmp_path / "wet.wav"
        render_wav(loaded, history, str(out_wet), sample_rate=8000,
                   dt=0.05, device=CPU)
        history_dry = dict(history)
        history_dry.pop("reverb_ir")
        out_dry = tmp_path / "dry.wav"
        render_wav(loaded, history_dry, str(out_dry), sample_rate=8000,
                   dt=0.05, device=CPU)
        wet, dry = pcm(out_wet), pcm(out_dry)
        assert wet.shape == dry.shape
        # The tail adds correlated-but-delayed energy: the waveforms
        # must differ by well over quantization noise.
        diff_rms = np.sqrt(((wet - dry) ** 2).mean())
        assert diff_rms > 50.0, diff_rms
        loaded.registry.close()


# ---------------------------------------------------------------------------
# TestMovingTarget of tests/test_demo.py
# ---------------------------------------------------------------------------


def crossing_scene():
    # One source sweeps left (-x) to right (+x) in front of the listener;
    # a floor gives the bounce rays something to hit.
    return {
        "trace": {"ray_count": 64, "max_bounces": 1, "max_ray_life": 100.0},
        "listener": {"position": [0, 0, 0]},
        "colliders": [
            {"type": "aabb", "center": [0, -2, 0],
             "half_extents": [30, 0.5, 30], "material": "concrete"},
        ],
        "targets": [{"position": [-10, 0, 2], "name": "mover"}],
        "animations": [
            {"target": 0, "speed": 20.0,
             "waypoints": [[-10, 0, 2], [10, 0, 2]]},
        ],
    }


class TestMovingTarget:
    def test_target_animation_moves_perceived_position(self):
        loaded, history = sim(crossing_scene(), 10, 0.1)
        pp = history["perceived_position"][:, 0, :]
        # The source swept +x at 2 units/frame and the traced
        # perceived_position followed (one-frame harvest lag).
        assert pp[-1, 0] > pp[2, 0] + 5.0
        np.testing.assert_allclose(pp[:, 2], 2.0, atol=1e-5)
        np.testing.assert_allclose(loaded.animations[0].position,
                                   [10, 0, 2], atol=1e-5)
        loaded.registry.close()

    def test_owned_collider_rides_target_animation(self):
        doc = {
            "trace": {"ray_count": 16, "max_bounces": 1},
            "colliders": [
                {"type": "sphere", "center": [1.0, 0.5, 2.0],
                 "radius": 0.4, "target": 0},
            ],
            "targets": [{"position": [0.0, 0.0, 2.0]}],
            "animations": [
                {"target": 0, "speed": 4.0,
                 "waypoints": [[0, 0, 2], [8, 0, 2]]},
            ],
        }
        loaded = build_registry(doc)
        anim = loaded.animations[0]
        assert len(anim.owned) == 1
        for _ in range(4):  # 4 steps x 4 u/s x 0.5 s = reaches [8,0,2]
            anim.step(loaded.registry, 0.5)
        scene = loaded.registry.snapshot(device=CPU)
        np.testing.assert_allclose(scene.target_positions[0].numpy(),
                                   [8, 0, 2], atol=1e-5)
        # Collider center = target position + authored offset [1,.5,0].
        np.testing.assert_allclose(scene.spheres.center[0].numpy(),
                                   [9, 0.5, 2], atol=1e-5)
        loaded.registry.close()

    def test_wav_pans_left_to_right(self, tmp_path):
        loaded, history = sim(crossing_scene(), 10, 0.1)
        out = tmp_path / "pan.wav"
        render_wav(loaded, history, str(out), sample_rate=8000, dt=0.1,
                   device=CPU)
        stereo = pcm(out).reshape(-1, 2)
        q = len(stereo) // 4

        def lr_energy(seg):
            return (seg[:, 0] ** 2).sum(), (seg[:, 1] ** 2).sum()
        l_early, r_early = lr_energy(stereo[:q])
        l_late, r_late = lr_energy(stereo[-q:])
        # Source left of the listener early -> left channel louder;
        # right late -> right louder (equal-power pan,
        # BinauralDSP.cs:28-30).
        assert l_early > 1.5 * r_early, (l_early, r_early)
        assert r_late > 1.5 * l_late, (l_late, r_late)
        loaded.registry.close()


# ---------------------------------------------------------------------------
# TestVisualize of tests/test_demo.py
# ---------------------------------------------------------------------------


class TestVisualize:
    def test_trace_and_history_pngs(self, tmp_path):
        from audio_raytracer_tpu_torch.demo.visualize import (
            plot_history,
            plot_trace,
        )

        loaded = build_registry(sample_scene_dict(ray_count=48,
                                                  max_bounces=2))
        plot_trace(loaded, str(tmp_path / "trace.png"), rays=48, trails=8,
                   device=CPU)
        assert (tmp_path / "trace.png").stat().st_size > 10_000
        history = simulate(loaded, frames=4, dt=0.05, verbose=False,
                           device=CPU)
        np.savez(tmp_path / "h.npz", **history)
        plot_history(str(tmp_path / "h.npz"), str(tmp_path / "hist.png"),
                     target_names=loaded.target_names)
        assert (tmp_path / "hist.png").stat().st_size > 10_000
        loaded.registry.close()

    def test_without_matplotlib_the_error_names_it(self, tmp_path,
                                                    monkeypatch):
        # The card's machine has no matplotlib: the figure functions
        # import it only when they draw, and say what is missing.
        import sys

        from audio_raytracer_tpu_torch.demo import visualize

        for name in [m for m in sys.modules if m.startswith("matplotlib")]:
            monkeypatch.delitem(sys.modules, name)
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        loaded = build_registry(sample_scene_dict(ray_count=8))
        with pytest.raises(ImportError, match="matplotlib"):
            visualize.plot_trace(loaded, str(tmp_path / "t.png"), rays=8,
                                 device=CPU)
        with pytest.raises(ImportError, match="matplotlib"):
            visualize.plot_history(str(tmp_path / "h.npz"),
                                   str(tmp_path / "h.png"))
        loaded.registry.close()

    def test_cli_writes_trace_and_history(self, tmp_path):
        from audio_raytracer_tpu_torch.demo import visualize

        loaded, history = sim(sample_scene_dict(ray_count=32,
                                                max_bounces=1), 3, 0.05)
        loaded.registry.close()
        np.savez(tmp_path / "h.npz", **history)
        assert visualize.main([
            "--device", "cpu", "--rays", "32", "--trails", "4", "--out",
            str(tmp_path / "t.png"), "--history", str(tmp_path / "h.npz"),
            "--history-out", str(tmp_path / "h.png")]) == 0
        assert (tmp_path / "t.png").stat().st_size > 10_000
        assert (tmp_path / "h.png").stat().st_size > 10_000


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_history():
    loaded = JF.build_registry(sample_scene_dict(**PARITY))
    history = JP.simulate(loaded, frames=PARITY_FRAMES, dt=PARITY_DT,
                          backend="jnp", verbose=False)
    loaded.registry.close()
    return history


def assert_history_close(ours, theirs):
    assert set(ours) == set(theirs)
    np.testing.assert_allclose(ours["muffle"], theirs["muffle"], rtol=1e-5,
                               atol=1e-5)
    for k in ("reverb_strength", "reverb_volume"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours["reverb_ir"], theirs["reverb_ir"],
                               rtol=1e-3, atol=1e-2)
    for k in ("listener", "perceived_position"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ours["frame_ms"].shape == theirs["frame_ms"].shape


@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_simulate_matches_jax(jax_history, backend):
    loaded, ours = sim(sample_scene_dict(**PARITY), PARITY_FRAMES,
                       PARITY_DT, backend=backend)
    loaded.registry.close()
    assert (ours["muffle"][1:] > 0).any()  # harvested settings compared
    assert_history_close(ours, jax_history)


def test_render_wav_matches_jax(jax_history, tmp_path):
    doc = sample_scene_dict(**PARITY)
    ours, theirs = build_registry(doc), JF.build_registry(doc)
    render_wav(ours, jax_history, str(tmp_path / "t.wav"), sample_rate=8000,
               dt=PARITY_DT, device=CPU)
    JP.render_wav(theirs, jax_history, str(tmp_path / "j.wav"),
                  sample_rate=8000, dt=PARITY_DT)
    ours.registry.close()
    theirs.registry.close()
    a, b = pcm(tmp_path / "t.wav"), pcm(tmp_path / "j.wav")
    T = jax_history["muffle"].shape[1]
    assert a.shape == b.shape and np.abs(b).max() > 1000
    np.testing.assert_allclose(a, b, rtol=4e-3, atol=32767 * T * 2e-4 + 1)


def test_dense_loop_harvests_what_the_jax_loop_harvests():
    reg, jreg = SceneRegistry(), JRegistry()
    try:
        for r in (reg, jreg):
            r.add_aabb([0, 0, 6], [2, 2, 1], material=(0.1, 1.0, 1.0))
            r.add_sphere([3, 0, 3], 1.0)
            r.add_obb([-3, 1, 4], [1, 2, 1], [0.0, 0.38268343, 0.0,
                                               0.92387953])
            r.add_target([0, 0, 3])
            r.add_target([-4, 0, -2])
        cfg_kw = dict(ray_count=64, max_bounces=2, max_ray_life=150.0,
                      num_reverb_bins=16)
        ours = AsyncRaytraceLoop(reg, TraceConfig(**cfg_kw), backend="dense",
                                 compute_async=False, device=CPU)
        theirs = JLoop(jreg, JConfig(**cfg_kw), backend="jnp",
                       compute_async=False)
        compared = 0
        for i in range(5):
            origin = [0.3 * i, 0.1 * i, -0.2 * i]
            a, b = ours.tick(origin), theirs.tick(origin)
            assert (a is None) == (b is None)
            if a is None:
                continue
            np.testing.assert_allclose(a.muffle.numpy(),
                                       np.asarray(b.muffle), rtol=1e-5,
                                       atol=1e-5)
            for k in ("reverb_strength", "reverb_volume"):
                np.testing.assert_allclose(float(getattr(a, k)),
                                           float(getattr(b, k)), rtol=1e-4,
                                           atol=1e-4)
            np.testing.assert_array_equal(a.perceived_position.numpy(),
                                          np.asarray(b.perceived_position))
            np.testing.assert_allclose(ours.reverb_ir.numpy(),
                                       np.asarray(theirs.reverb_ir),
                                       rtol=1e-3, atol=1e-2)
            compared += 1
        assert compared == 4
        assert type(ours._engine).__name__ == "DenseBackend"
    finally:
        reg.close()
        jreg.close()


# ---------------------------------------------------------------------------
# The CLI, and the card as the default device
# ---------------------------------------------------------------------------


def test_cli_prints_its_summary_and_writes_the_wav(tmp_path, capsys):
    out = tmp_path / "x.wav"
    npz = tmp_path / "h.npz"
    assert scene_player.main(["--device", "cpu", "--frames", "8",
                              "--render-wav", str(out), "--npz",
                              str(npz)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 8 and summary["device"] == "cpu"
    assert summary["targets"] == ["radio", "speaker"]
    assert out.read_bytes()[:4] == b"RIFF"
    assert np.load(npz)["muffle"].shape == (8, 2)


class TestTheCardIsTheDefault:
    @pytest.fixture(autouse=True)
    def no_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    @pytest.mark.parametrize("module", ["scene_player", "train_materials",
                                        "visualize"])
    def test_cli_without_device_exits_non_zero(self, module, capsys):
        import importlib

        mod = importlib.import_module(
            f"audio_raytracer_tpu_torch.demo.{module}")
        with pytest.raises(SystemExit) as e:
            mod.main(["--steps", "1"] if module == "train_materials"
                     else [])
        assert e.value.code != 0
        assert "CUDA" in capsys.readouterr().err

    def test_simulate_and_render_raise(self, tmp_path):
        loaded = build_registry(sample_scene_dict(ray_count=8))
        with pytest.raises(RuntimeError, match="CUDA"):
            simulate(loaded, frames=1, verbose=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            render_wav(loaded, dict(muffle=np.zeros((1, 2)),
                                    reverb_strength=np.zeros(1)),
                       str(tmp_path / "x.wav"))
        with pytest.raises(RuntimeError, match="CUDA"):
            loaded.registry.snapshot()
        loaded.registry.close()
