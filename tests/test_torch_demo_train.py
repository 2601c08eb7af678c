"""The port's calibration CLI, checkpoints, optimizer carry-over and
profiling utils, on the CPU.

Mirrors TestTrainMaterialsCLI, TestRecoverPoseCLI, TestCheckpoint and
TestTrainingResume of tests/test_demo.py on ``audio_raytracer_tpu_torch``
(the CLI through ``main(argv)`` with ``--device cpu``), adds the source
mode of ``--recover-pose``, and holds ``convert.adam_from_arrays`` to
the JAX package: JAX trains 3 steps, its parameters and Adam moments
carry over, and the port's 2 further steps match JAX's 2 further steps
within tests/test_torch_train.py's step tolerances (loss rtol 1e-5,
parameters rtol / atol 1e-5).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.demo import train_materials as JT
from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.models.raytracer import random_scene as j_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions as j_fib
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch import convert
from audio_raytracer_tpu_torch.demo import train_materials
from audio_raytracer_tpu_torch.models import differentiable as tdiff
from audio_raytracer_tpu_torch.models.raytracer import random_scene
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.types import TraceConfig
from audio_raytracer_tpu_torch.utils import profiling
from audio_raytracer_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)

CPU = "cpu"
TRAIN = dict(rtol=1e-5, atol=1e-5)


def run_cli(argv, capsys):
    """(summary JSON, stderr) of one ``train_materials.main`` run."""
    assert train_materials.main(["--device", "cpu"] + argv) == 0
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), captured.err


# ---------------------------------------------------------------------------
# TestTrainMaterialsCLI and TestRecoverPoseCLI of tests/test_demo.py
# ---------------------------------------------------------------------------


class TestTrainMaterialsCLI:
    def test_trains_and_resumes(self, tmp_path, capsys):
        base = ["--steps", "6", "--rays", "64", "--init", "noisy",
                "--log-every", "3", "--ckpt-every", "3", "--checkpoint",
                str(tmp_path / "ck")]
        out1, _ = run_cli(base, capsys)
        assert out1["final_loss"] < 0.1
        assert set(out1["material_mae"]) == {"absorption", "density",
                                             "echo"}
        out2, err = run_cli(base[:1] + ["12"] + base[2:] + ["--resume"],
                            capsys)
        assert "resumed from step 6" in err
        assert out2["final_loss"] <= out1["final_loss"] * 1.5  # kept going

    def test_loss_falls_from_the_default_start(self, capsys):
        out, err = run_cli(["--steps", "8", "--rays", "64", "--backend",
                            "dense", "--log-every", "7", "--lr", "0.05"],
                           capsys)
        first = float(err.split("step    0: loss ")[1].split()[0])
        assert out["final_loss"] < first
        assert out["backend"] == "dense"


class TestRecoverPoseCLI:
    def test_listener_mode_descends(self, capsys):
        out, _ = run_cli(["--recover-pose", "listener", "--steps", "40",
                          "--rays", "128", "--lr", "0.03", "--log-every",
                          "10"], capsys)
        assert out["mode"] == "recover_pose_listener"
        assert out["pose_error_final"] < out["pose_error_initial"]

    def test_source_mode_descends(self, capsys):
        out, _ = run_cli(["--recover-pose", "source", "--steps", "10",
                          "--rays", "64", "--log-every", "5"], capsys)
        assert out["mode"] == "recover_pose_source"
        assert out["pose_error_final"] < out["pose_error_initial"]


def test_material_errors_match_jax():
    rng = np.random.default_rng(2)

    def params():
        return tdiff.SceneParams(*(
            tdiff.Materials(*(torch.as_tensor(rng.uniform(0, 2, n)
                                              .astype(np.float32))
                              for _ in range(3)))
            for n in (8, 16, 8)))

    a, b = params(), params()
    counts = {"sphere": 3, "aabb": 11, "obb": 8}
    for c in (None, counts):
        got = train_materials._material_errors(a, b, c)
        want = JT._material_errors(a, b, c)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


# ---------------------------------------------------------------------------
# TestCheckpoint and TestTrainingResume of tests/test_demo.py
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        scene = random_scene(1, 3, 3, 3, num_targets=1, device=CPU)
        params = tdiff.SceneParams.from_scene(scene)
        save_checkpoint(tmp_path / "ckpt", {"scene": scene,
                                            "params": params})
        restored = restore_checkpoint(tmp_path / "ckpt",
                                      {"scene": scene, "params": params})
        assert type(restored["scene"]) is type(scene)
        torch.testing.assert_close(restored["scene"].spheres.center,
                                   scene.spheres.center, rtol=0, atol=0)
        torch.testing.assert_close(restored["scene"].obbs.target_id,
                                   scene.obbs.target_id, rtol=0, atol=0)
        torch.testing.assert_close(restored["params"].aabb.echo,
                                   params.aabb.echo, rtol=0, atol=0)

    def test_restore_takes_the_examples_device_and_dtype(self, tmp_path):
        save_checkpoint(tmp_path, {"x": torch.arange(4, dtype=torch.int32),
                                   "step": 7, "betas": (0.9, 0.999)})
        out = restore_checkpoint(tmp_path, {"x": torch.zeros(
            4, dtype=torch.float64), "step": 0, "betas": (0.0, 0.0)})
        assert out["x"].dtype == torch.float64 and out["x"].device.type == CPU
        assert out["step"] == 7 and out["betas"] == (0.9, 0.999)


class TestTrainingResume:
    def test_resume_continues_identically(self, tmp_path):
        cfg = TraceConfig(ray_count=48, max_bounces=2, max_ray_life=80.0)
        scene = random_scene(4, 4, 6, 4, num_targets=2, extent=12.0,
                             size_range=(1.5, 4.0), device=CPU)
        origin = torch.zeros(3)
        dirs = fibonacci_directions(48, device=CPU)
        target = tdiff.Loudness(muffle=torch.full((2,), 0.4),
                                permeation=torch.full((2,), 0.3),
                                reverb_energy=torch.tensor(0.1))
        step, init = tdiff.make_train_step(cfg, device=CPU)
        params = tdiff.SceneParams.from_scene(scene)
        opt = init(params)

        # Train 3 steps, checkpoint, train 2 more (reference run).
        for _ in range(3):
            params, opt, _ = step(params, opt, scene, origin, dirs, target)
        save_checkpoint(tmp_path / "ck", {"params": params,
                                          "opt_state": opt.state_dict()})
        for _ in range(2):
            params, opt, ref_loss = step(params, opt, scene, origin, dirs,
                                         target)

        # Restore into fresh structures and continue: identical result.
        fresh = tdiff.SceneParams.from_scene(scene)
        restored = restore_checkpoint(
            tmp_path / "ck", {"params": fresh,
                              "opt_state": init(fresh).state_dict()})
        r_p = restored["params"]
        r_o = init(r_p)
        r_o.load_state_dict(restored["opt_state"])
        for _ in range(2):
            r_p, r_o, r_loss = step(r_p, r_o, scene, origin, dirs, target)
        np.testing.assert_allclose(float(r_loss), float(ref_loss),
                                   rtol=1e-6, atol=1e-8)
        for a, b in zip(params.leaves(), r_p.leaves()):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# convert.adam_from_arrays against optax
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """The scene of tests/test_torch_train.py at 48 rays and 2 bounces:
    JAX trains 3 steps (jnp tier, optax.adam(1e-2)); returns the scene,
    the state after 3 steps and the parameters and losses of 2 further
    steps."""
    jscene = j_scene(jax.random.key(7), num_spheres=7, num_aabbs=9,
                     num_obbs=8, num_targets=2, extent=14.0,
                     size_range=(1.0, 4.0), target_owned_colliders=True)
    cfg_kw = dict(ray_count=48, max_bounces=2, max_ray_life=200.0)
    jtarget = jdiff.Loudness(muffle=jnp.full((2,), 0.3),
                             permeation=jnp.full((2,), 0.2),
                             reverb_energy=jnp.asarray(0.05))
    dirs = j_fib(48)
    step, opt = jdiff.make_train_step(JConfig(**cfg_kw))
    params = jdiff.SceneParams.from_scene(jscene)
    state = opt.init(params)
    for _ in range(3):
        params, state, _ = step(params, state, jscene, jnp.zeros(3), dirs,
                                jtarget)
    at3 = jax.tree.map(np.asarray, (params, state))
    trail = []
    for _ in range(2):
        params, state, loss = step(params, state, jscene, jnp.zeros(3), dirs,
                                   jtarget)
        trail.append((jax.tree.map(np.asarray, params), float(loss)))
    return jscene, cfg_kw, np.array(dirs), jtarget, at3, trail


def test_adam_from_arrays_continues_a_jax_run(jax_run):
    jscene, cfg_kw, dirs, jtarget, (jparams, jstate), trail = jax_run
    adam_state = jstate[0]  # optax.adam: (ScaleByAdamState, EmptyState)
    params = convert.params_from_arrays(jparams, device=CPU)
    step, init = tdiff.make_train_step(TraceConfig(**cfg_kw),
                                       backend="dense", device=CPU)
    opt = convert.adam_from_arrays(jax.tree.leaves(adam_state.mu),
                                   jax.tree.leaves(adam_state.nu),
                                   int(adam_state.count), init(params))
    assert float(opt.state[params.sphere.density]["step"]) == 3.0
    scene = convert.scene_from_arrays(jax.tree.map(np.asarray, jscene),
                                      device=CPU)
    target = convert.loudness_from_arrays(jtarget, device=CPU)
    for want_params, want_loss in trail:
        params, opt, loss = step(params, opt, scene, torch.zeros(3),
                                 torch.as_tensor(dirs), target)
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        for a, b in zip(params.leaves(), jax.tree.leaves(want_params)):
            np.testing.assert_allclose(a.detach().numpy(), b, **TRAIN)


def test_adam_from_arrays_checks_the_moments():
    pose = tdiff.PoseParams(origin=torch.zeros(3),
                            target_positions=torch.zeros(2, 3))
    _, init = tdiff.make_pose_recovery_step(TraceConfig(ray_count=8),
                                            device=CPU)
    opt = init(pose)
    with pytest.raises(ValueError, match="2 parameters"):
        convert.adam_from_arrays([np.zeros(3)], [np.zeros(3)], 1, opt)
    with pytest.raises(ValueError, match="shape"):
        convert.adam_from_arrays([np.zeros(3), np.zeros(3)],
                                 [np.zeros(3), np.zeros(3)], 1, opt)
    convert.adam_from_arrays([np.ones(3), np.ones((2, 3))],
                             [np.ones(3), np.ones((2, 3))], 5, opt)
    assert float(opt.state[pose.origin]["step"]) == 5.0
    assert opt.state[pose.target_positions]["exp_avg"].shape == (2, 3)


# ---------------------------------------------------------------------------
# utils/profiling
# ---------------------------------------------------------------------------


def test_sync_timer_and_meter():
    assert profiling.sync(tdiff.Loudness(torch.tensor([0.25, 1.0]),
                                         torch.zeros(2),
                                         torch.tensor(0.0))) == 0.25


def test_device_trace_and_summary(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path), device=CPU):
        for _ in range(3):
            x = torch.mm(x, x).tanh()
    top = profiling.summarize_trace(str(tmp_path), top=5)
    assert 0 < len(top) <= 5
    assert [ms for _, ms in top] == sorted((ms for _, ms in top),
                                           reverse=True)
    assert any("mm" in name for name, _ in top)
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "none"))


def test_device_trace_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.device_trace(str(tmp_path)):
            pass


def test_scene_params_fields_match_jax():
    # The checkpoint and the carry-over rely on the same field order.
    assert [f.name for f in dataclasses.fields(tdiff.SceneParams)] == \
        [f.name for f in dataclasses.fields(jdiff.SceneParams)]
    assert [f.name for f in dataclasses.fields(tdiff.PoseParams)] == \
        [f.name for f in dataclasses.fields(jdiff.PoseParams)]
