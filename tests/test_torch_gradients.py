"""The port's gradients against the function itself and against the JAX
package, in float64, through the dense tier.

The counterpart of tests/test_gradients.py. Its scene (key 11, carried
across with ``convert``, which keeps float64) goes through both
packages: each of its six finite-difference checks runs on the port's
``loudness_loss`` (directional derivatives against central differences,
three directions from a seeded numpy generator, at least one probe not
degenerate), and beside each the port's float64 gradient is held to
JAX's float64 gradient on the same inputs. Then the self-target check
and the material recovery of that file, at its step counts and
thresholds, with the first step held to JAX's first step. The pose
recoveries are in tests/test_torch_recovery.py.

``jax_enable_x64`` is on for this module only, as in
tests/test_gradients.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.convert import (
    loudness_from_arrays,
    params_from_arrays,
    scene_from_arrays,
)
from audio_raytracer_tpu_torch.models import differentiable as tdiff

torch.set_num_threads(1)

F64 = torch.float64
CFG = dict(ray_count=64, max_bounces=3, max_ray_life=150.0)
# The port's float64 gradients against JAX's: the same float64
# arithmetic in another order of operations. Worst case measured on
# these inputs: 9.7e-14 relative (target positions), 7e-15 for the
# materials.
JAX_GRAD = dict(rtol=1e-6, atol=1e-15)
# tests/test_torch_train.py's TRAIN: one Adam step moves each parameter
# by about lr x sign(g).
TRAIN = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def jax_setup(enable_x64):
    """tests/test_gradients.py's ``setup``, in float64."""
    cfg = JConfig(**CFG)
    scene = j_random_scene(jax.random.key(11), num_spheres=10, num_aabbs=14,
                           num_obbs=10, num_targets=2, extent=12.0,
                           size_range=(1.5, 5.0), dtype=jnp.float64)
    scene = scene.replace(target_positions=jnp.asarray(
        [[2.0, 1.0, 0.5], [-1.5, 2.5, 1.0]]))
    origin = jnp.zeros(3)
    dirs = fibonacci_directions(cfg.ray_count, jnp.float64)
    params = jdiff.SceneParams.from_scene(scene)

    def perturb(m):
        return dataclasses.replace(
            m, absorption=jnp.clip(m.absorption + 0.15, 0, 1),
            density=m.density * 0.6, echo=m.echo * 1.4)

    target_params = jdiff.SceneParams(sphere=perturb(params.sphere),
                                      aabb=perturb(params.aabb),
                                      obb=perturb(params.obb))
    target = jdiff.loudness_map(origin, dirs, target_params.into_scene(scene),
                                cfg)
    return cfg, scene, origin, dirs, params, target


def arrays(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(jax_setup):
    """The same inputs carried across to the port, in float64."""
    _, jscene, _, jdirs, jparams, jtarget = jax_setup
    scene = scene_from_arrays(arrays(jscene), device="cpu")
    return (ttypes.TraceConfig(**CFG), scene, torch.zeros(3, dtype=F64),
            torch.as_tensor(np.array(jdirs)),
            params_from_arrays(arrays(jparams), device="cpu"),
            loudness_from_arrays(arrays(jtarget), device="cpu"))


@pytest.fixture(scope="module")
def jax_grads(jax_setup):
    """JAX's float64 gradient of the loss in the materials, the target
    positions and the listener origin, one trace for all six cases."""
    cfg, scene, origin, dirs, params, target = jax_setup

    def loss(p, tp, o):
        return jdiff.loudness_loss(p, scene.replace(target_positions=tp), o,
                                   dirs, cfg, target)

    g = jax.grad(loss, argnums=(0, 1, 2))(params, scene.target_positions,
                                         origin)
    return arrays(g)


def port_loss(setup, params=None, target_positions=None, origin=None):
    cfg, scene, o, dirs, p, target = setup
    if target_positions is not None:
        scene = scene.replace(target_positions=target_positions)
    return tdiff.loudness_loss(p if params is None else params, scene,
                               o if origin is None else origin, dirs, cfg,
                               target, backend="dense", device="cpu")


def with_leaf(params, kind, field, x):
    m = dataclasses.replace(getattr(params, kind), **{field: x})
    return dataclasses.replace(params, **{kind: m})


def unflatten_params(params, flat):
    sizes = [x.numel() for x in params.leaves()]
    parts = iter(torch.split(flat, sizes))
    return tdiff.SceneParams(*(ttypes.Materials(*(next(parts)
                                                  for _ in range(3)))
                               for _ in range(3)))


# Each case: the variable x0, the loss as a function of it, JAX's
# gradient in it, and fd_check's (rel_tol, eps).
def case(name, setup, jg):
    cfg, scene, origin, dirs, params, target = setup
    jp, jtp, jo = jg
    if name in ("echo", "absorption", "density"):
        kind = "obb" if name == "density" else "aabb"
        x0 = getattr(getattr(params, kind), name)
        return (x0, lambda x: port_loss(setup, with_leaf(params, kind, name,
                                                         x)),
                getattr(getattr(jp, kind), name), 0.05, 1e-3)
    if name == "all":
        x0 = torch.cat(params.leaves())
        return (x0, lambda x: port_loss(setup, unflatten_params(params, x)),
                np.concatenate(jax.tree.leaves(jp)), 0.05, 1e-3)
    if name == "target_position":
        return (scene.target_positions,
                lambda x: port_loss(setup, target_positions=x), jtp, 0.08,
                1e-5)
    return origin, lambda x: port_loss(setup, origin=x), jo, 0.08, 1e-5


CASES = ("echo", "absorption", "density", "all", "target_position",
         "listener_origin")


def fd_check(f, x0, seed, rel_tol=0.05, n_dirs=3, eps=1e-3):
    """tests/test_gradients.py's fd_check: grad . v against
    (f(x + eps v) - f(x - eps v)) / 2 eps along n_dirs unit directions.
    Returns the probes checked and the worst relative error."""
    x = x0.detach().clone().reshape(-1).requires_grad_(True)
    (g,) = torch.autograd.grad(f(x.reshape(x0.shape)), [x])
    rng = np.random.default_rng(seed)
    checked, worst = 0, 0.0
    with torch.no_grad():
        for _ in range(n_dirs):
            v = torch.as_tensor(rng.standard_normal(x.shape[0]))
            v = v / torch.linalg.vector_norm(v)
            fp = f((x + eps * v).reshape(x0.shape))
            fm = f((x - eps * v).reshape(x0.shape))
            fd = float((fp - fm) / (2 * eps))
            an = float(g @ v)
            if abs(fd) < 1e-7 and abs(an) < 1e-7:
                continue
            np.testing.assert_allclose(an, fd, rtol=rel_tol, atol=1e-6)
            worst = max(worst, abs(an - fd) / abs(fd))
            checked += 1
    assert checked >= 1, "all FD probes degenerate"
    return checked, worst


def test_convert_keeps_float64_and_float32(jax_setup):
    # A float64 JAX scene, parameters and target arrive in float64; the
    # same scene in float32 arrives as float32, value for value.
    _, jscene, _, _, jparams, jtarget = jax_setup
    scene = scene_from_arrays(arrays(jscene), device="cpu")
    floats = [scene.spheres.center, scene.spheres.radius,
              scene.aabbs.half_extents, scene.obbs.inv_rot,
              scene.obbs.material.density, scene.target_positions]
    assert all(x.dtype == F64 for x in floats)
    np.testing.assert_array_equal(scene.obbs.inv_rot.numpy(),
                                  np.asarray(jscene.obbs.inv_rot))
    assert scene.spheres.target_id.dtype == torch.int32
    assert all(x.dtype == F64 for x in params_from_arrays(
        arrays(jparams), device="cpu").leaves())
    lmap = loudness_from_arrays(arrays(jtarget), device="cpu")
    assert lmap.muffle.dtype == lmap.reverb_energy.dtype == F64

    f32 = jax.tree.map(lambda x: np.asarray(x).astype(np.float32)
                       if np.asarray(x).dtype == np.float64 else
                       np.asarray(x), jscene)
    s32 = scene_from_arrays(f32, device="cpu")
    assert s32.spheres.center.dtype == s32.target_positions.dtype \
        == torch.float32
    np.testing.assert_array_equal(s32.obbs.half_extents.numpy(),
                                  f32.obbs.half_extents)
    assert s32.spheres.target_id.dtype == torch.int32


def test_loudness_map_keeps_float64(setup, jax_setup):
    cfg, scene, origin, dirs, params, _ = setup
    jcfg, jscene, jorigin, jdirs, _, _ = jax_setup
    cfg_ir = dataclasses.replace(cfg, num_reverb_bins=16)
    got = tdiff.loudness_map(origin, dirs, scene, cfg_ir, backend="dense",
                             device="cpu")
    ref = jdiff.loudness_map(jorigin, jdirs, jscene,
                             dataclasses.replace(jcfg, num_reverb_bins=16))
    for k in ("muffle", "permeation", "reverb_energy", "reverb_ir"):
        x = getattr(got, k)
        assert x.dtype == F64, k
        np.testing.assert_allclose(x.numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-12, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_fd_check(setup, jax_grads, name):
    x0, f, _, rel_tol, eps = case(name, setup, jax_grads)
    assert x0.dtype == F64
    fd_check(f, x0, CASES.index(name), rel_tol=rel_tol, eps=eps)


@pytest.mark.parametrize("name", CASES)
def test_grad_matches_jax(setup, jax_grads, name):
    x0, f, ref, _, _ = case(name, setup, jax_grads)
    x = x0.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), [x])
    assert g.dtype == F64 and float(g.abs().sum()) > 0.0
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), **JAX_GRAD)


def test_self_target_zero_loss_and_grad(setup):
    cfg, scene, origin, dirs, params, _ = setup
    with torch.no_grad():
        self_map = tdiff.loudness_map(origin, dirs, scene, cfg,
                                      backend="dense", device="cpu")
    loss = tdiff.loudness_loss(params, scene, origin, dirs, cfg, self_map,
                               backend="dense", device="cpu")
    assert float(loss) < 1e-10


@pytest.fixture(scope="module")
def jax_material_step(jax_setup):
    """JAX's first step of TestMaterialRecovery: (parameters after it,
    loss)."""
    cfg, scene, origin, dirs, _, _ = jax_setup
    truth = jdiff.SceneParams.from_scene(scene)
    target = jdiff.loudness_map(origin, dirs, scene, cfg)
    perturbed = jax.tree.map(lambda x: jnp.clip(x * 0.6 + 0.15, 0.05, None),
                             truth)
    step, opt = jdiff.make_train_step(cfg, optimizer=optax.adam(3e-2))
    params, _, loss = step(perturbed, opt.init(perturbed), scene, origin,
                           dirs, target)
    return arrays(params), float(loss)


def test_material_recovery(setup, jax_material_step):
    # TestMaterialRecovery: 60 Adam steps at lr 3e-2 from materials moved
    # away from the truth bring the loudness map most of the way back.
    cfg, scene, origin, dirs, truth, _ = setup
    kw = dict(backend="dense", device="cpu")
    with torch.no_grad():
        target = tdiff.loudness_map(origin, dirs, scene, cfg, **kw)
    params = tdiff.SceneParams(*(ttypes.Materials(
        *(torch.clamp(x * 0.6 + 0.15, min=0.05) for x in (
            m.absorption, m.density, m.echo)))
        for m in (truth.sphere, truth.aabb, truth.obb)))
    step, init = tdiff.make_train_step(cfg, optimizer=tdiff.adam(3e-2), **kw)
    opt = init(params)

    @torch.no_grad()
    def loudness_err(p):
        pred = tdiff.loudness_map(origin, dirs, p.into_scene(scene), cfg,
                                  **kw)
        return (float((pred.muffle - target.muffle).abs().max())
                + float((pred.permeation - target.permeation).abs().max()))

    err0 = loudness_err(params)
    jparams, jloss = jax_material_step
    for i in range(60):
        params, opt, loss = step(params, opt, scene, origin, dirs, target)
        if i == 0:
            np.testing.assert_allclose(float(loss), jloss, rtol=1e-10)
            for a, b in zip(params.leaves(), jax.tree.leaves(jparams)):
                np.testing.assert_allclose(a.detach().numpy(), b, **TRAIN)
    err1 = loudness_err(params)
    assert all(x.dtype == F64 for x in params.leaves())
    assert np.isfinite(float(loss))
    assert err1 < 0.35 * err0, (err0, err1)
