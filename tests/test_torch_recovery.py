"""Pose recovery on the port, against the JAX package, in float64.

The counterpart of tests/test_gradients.py::TestPoseRecovery: the room of
its ``room_scene`` (seven AABBs and one target behind a thick wall),
built in the port's ``SceneRegistry`` and taken to float64, held equal
to the JAX registry's room; then source recovery on the dense tier
(4 listeners, 256 rays, 300 steps), listener-origin recovery with the
IR (48 bins, 150 steps) and source recovery on the kernel engine (B3
and B5 as plain versions, 128 rays, 60 steps), each at that file's step
count and threshold, with the first step held to JAX's first step
(tests/test_torch_train.py's TRAIN tolerance). The kernel engine
computes in float32 on the float64 room, as JAX's Pallas tier does:
its kernels get float32 tables, origins and directions, and the
gradients reach the float64 target positions through those casts.

``jax_enable_x64`` is on for this module only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.runtime.registry import SceneRegistry as JRegistry
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.models import differentiable as tdiff
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.runtime import SceneRegistry

torch.set_num_threads(1)

F64 = torch.float64
TRAIN = dict(rtol=1e-5, atol=1e-5)
ORIGINS = np.asarray([[0.0, 0.0, 0.0], [6.0, 1.0, -4.0],
                      [-7.0, 2.0, 2.0], [3.0, 0.5, -10.0]])
SHIFT = np.asarray([[0.8, -0.4, 0.6]])
WALL = (0.2, 0.5, 1.0)
ROOM = [([0, -2, 0], [20, 0.5, 20], WALL), ([0, 8, 0], [20, 0.5, 20], WALL),
        ([20, 3, 0], [0.5, 6, 20], WALL), ([-20, 3, 0], [0.5, 6, 20], WALL),
        ([0, 3, 20], [20, 6, 0.5], WALL), ([0, 3, -20], [20, 6, 0.5], WALL),
        ([0, 3, 6], [8, 6, 1.5], (0.0, 2.0, 1.0))]
TARGET = [0.0, 2.0, 10.0]


@pytest.fixture(autouse=True, scope="module")
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def in_float64(x):
    """A scene (or any dataclass of tensors) with its floating tensors in
    float64, as the JAX test takes its room."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    return dataclasses.replace(x, **{f.name: in_float64(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


def fill(reg):
    for center, half, material in ROOM:
        reg.add_aabb(center, half, material=material)
    reg.add_target(TARGET)


@pytest.fixture(scope="module")
def rooms(enable_x64):
    """(JAX room, port room), each from its package's registry, float
    fields in float64."""
    jreg, reg = JRegistry(), SceneRegistry()
    try:
        fill(jreg)
        fill(reg)
        jroom = jax.tree.map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
            jreg.snapshot())
        room = in_float64(reg.snapshot(device="cpu"))
    finally:
        jreg.close()
        reg.close()
    return jroom, room


def test_port_room_is_jax_room(rooms):
    jroom, room = rooms
    for kind in ("spheres", "aabbs", "obbs"):
        a, b = getattr(room, kind), getattr(jroom, kind)
        for name in ("center", "target_id", "active"):
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          np.asarray(getattr(b, name)))
        for name in ("absorption", "density", "echo"):
            np.testing.assert_array_equal(
                getattr(a.material, name).numpy(),
                np.asarray(getattr(b.material, name)))
    np.testing.assert_array_equal(room.aabbs.half_extents.numpy(),
                                  np.asarray(jroom.aabbs.half_extents))
    np.testing.assert_array_equal(room.target_positions.numpy(),
                                  np.asarray(jroom.target_positions))
    assert room.aabbs.center.dtype == room.target_positions.dtype == F64


def cfgs(**kw):
    return JConfig(**kw), ttypes.TraceConfig(**kw)


def jax_source_step(jroom, jcfg, backend="jnp"):
    """JAX's first source-recovery step from the shifted sources."""
    dirs = fibonacci_directions(jcfg.ray_count, jnp.float64)
    origins = jnp.asarray(ORIGINS)
    recs = jdiff.stack_loudness([
        jdiff.loudness_map(origins[i], dirs, jroom, jcfg)
        for i in range(len(ORIGINS))])
    tp = jroom.target_positions + jnp.asarray(SHIFT)
    step, opt = jdiff.make_source_recovery_step(
        jcfg, num_listeners=len(ORIGINS), optimizer=optax.adam(2e-2),
        backend=backend)
    tp, _, loss = step(tp, opt.init(tp), jroom, origins, dirs, recs)
    return np.asarray(tp), float(loss)


def source_recovery(room, cfg, backend, steps, jax_first):
    """The port's source recovery: (distance before, distance after,
    last loss)."""
    dirs = torch.as_tensor(np.array(fibonacci_directions(cfg.ray_count,
                                                         jnp.float64)))
    origins = torch.as_tensor(ORIGINS)
    with torch.no_grad():
        recs = tdiff.stack_loudness([
            tdiff.loudness_map(o, dirs, room, cfg, backend="dense",
                               device="cpu") for o in origins])
    truth = room.target_positions
    tp = truth + torch.as_tensor(SHIFT)
    step, init = tdiff.make_source_recovery_step(
        cfg, len(ORIGINS), optimizer=tdiff.adam(2e-2), backend=backend,
        device="cpu")
    opt = init(tp)
    d0 = float(torch.linalg.vector_norm(tp.detach()[0] - truth[0]))
    for i in range(steps):
        tp, opt, loss = step(tp, opt, room, origins, dirs, recs)
        if i == 0:
            jtp, jloss = jax_first
            np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
            np.testing.assert_allclose(tp.detach().numpy(), jtp, **TRAIN)
    assert tp.dtype == F64
    d1 = float(torch.linalg.vector_norm(tp.detach()[0] - truth[0]))
    return d0, d1, float(loss)


def test_source_position_recovery_dense(rooms):
    jroom, room = rooms
    jcfg, cfg = cfgs(ray_count=256, max_bounces=2, max_ray_life=150.0)
    d0, d1, loss = source_recovery(room, cfg, "dense", 300,
                                   jax_source_step(jroom, jcfg))
    assert np.isfinite(loss)
    assert d1 < 0.5 * d0, (d0, d1)


def test_listener_origin_recovery_with_ir(rooms):
    jroom, room = rooms
    kw = dict(ray_count=256, max_bounces=2, max_ray_life=150.0,
              num_reverb_bins=48, ir_max_distance=80.0)
    jcfg, cfg = cfgs(**kw)
    shift = np.asarray([0.6, 0.4, -0.5])

    jdirs = fibonacci_directions(jcfg.ray_count, jnp.float64)
    jrec = jdiff.loudness_map(jnp.zeros(3, jnp.float64), jdirs, jroom, jcfg)
    jpose = jdiff.PoseParams(origin=jnp.asarray(shift),
                             target_positions=jroom.target_positions)
    jstep, jopt = jdiff.make_pose_recovery_step(
        jcfg, optimizer=optax.adam(2e-2), recover=("origin",))
    jpose, _, jloss = jstep(jpose, jopt.init(jpose), jroom, jdirs, jrec)

    dirs = torch.as_tensor(np.array(jdirs))
    o_true = torch.zeros(3, dtype=F64)
    with torch.no_grad():
        rec = tdiff.loudness_map(o_true, dirs, room, cfg, backend="dense",
                                 device="cpu")
    pose = tdiff.PoseParams(origin=torch.as_tensor(shift),
                            target_positions=room.target_positions.clone())
    step, init = tdiff.make_pose_recovery_step(
        cfg, optimizer=tdiff.adam(2e-2), backend="dense",
        recover=("origin",), device="cpu")
    opt = init(pose)
    o0 = float(torch.linalg.vector_norm(pose.origin - o_true))
    for i in range(150):
        pose, opt, loss = step(pose, opt, room, dirs, rec)
        if i == 0:
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            np.testing.assert_allclose(pose.origin.detach().numpy(),
                                       np.asarray(jpose.origin), **TRAIN)
    o1 = float(torch.linalg.vector_norm(pose.origin.detach() - o_true))
    assert np.isfinite(float(loss))
    assert o1 < 0.3 * o0, (o0, o1)
    # Untouched leaves stay put (gradients masked, not just small).
    np.testing.assert_array_equal(pose.target_positions.detach().numpy(),
                                  room.target_positions.numpy())


def test_source_recovery_kernel_tier(rooms, monkeypatch):
    jroom, room = rooms
    jcfg, cfg = cfgs(ray_count=128, max_bounces=2, max_ray_life=150.0)
    seen = set()

    def spy(name, fn):
        def wrapped(fields, o, *args, **kw):
            seen.add((name, o.dtype))
            return fn(fields, o, *args, **kw)
        return wrapped

    for mod, name in ((K, "run_closest_hit"), (F, "run_multi_any_hit"),
                      (F, "run_multi_chord"), (F, "run_multi_chord_bwd")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    d0, d1, loss = source_recovery(
        room, cfg, "kernel", 60,
        jax_source_step(jroom, jcfg, backend="pallas_interpret"))
    assert np.isfinite(loss)
    assert d1 < 0.8 * d0, (d0, d1)
    # The kernels saw float32 rays, B5 (not B4) ran the adjoint.
    assert seen == {(n, torch.float32) for n in (
        "run_closest_hit", "run_multi_any_hit", "run_multi_chord",
        "run_multi_chord_bwd")}, seen
