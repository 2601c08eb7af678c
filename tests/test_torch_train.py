"""The port's differentiable training slice against the JAX package.

The same inputs go through the JAX function and its port: scenes, rays
and cotangents made from numpy seeds (JAX scenes carried across with
``convert``). On the CPU the port's kernel backend runs B4's and B5's
plain versions; the JAX side runs its Pallas kernels in interpret mode
(``PallasBackend(interpret=True, differentiable=True)``) and its jnp
tier. Tolerances: those of tests/test_pallas_grad.py (rtol 2e-4,
atol 2e-6) unless a test states another with its reason. The CUDA
kernels run only on the card, where chip_smoke.py holds each against its
plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops import intersect as jint
from audio_raytracer_tpu.ops import reverb as jrev
from audio_raytracer_tpu.ops.backend import NO_SKIP as J_NO_SKIP
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.ops.pallas import PallasBackend
from audio_raytracer_tpu.ops.pallas import fused as JF
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.convert import (
    loudness_from_arrays,
    params_from_arrays,
    scene_from_arrays,
)
from audio_raytracer_tpu_torch.models import differentiable as tdiff
from audio_raytracer_tpu_torch.ops import intersect as tint
from audio_raytracer_tpu_torch.ops import reverb as trev
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP, DenseBackend
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda.backend import (
    KernelBackend,
    prepare_fields,
)
from audio_raytracer_tpu_torch.ops.cuda.diff import multi_chord_loss

torch.set_num_threads(1)

GRAD = dict(rtol=2e-4, atol=2e-6)


def carry(jscene):
    return scene_from_arrays(jax.tree.map(np.asarray, jscene))


def t(x, grad=False):
    return torch.tensor(np.array(x), dtype=torch.float32, requires_grad=grad)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or GRAD))


# ---------------------------------------------------------------------------
# B4 and B5: the chord adjoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_scene():
    # The fixture scene of tests/test_pallas.py.
    return j_random_scene(jax.random.key(21), num_spheres=9, num_aabbs=13,
                          num_obbs=11, num_targets=2, extent=15.0,
                          size_range=(1.0, 4.0), target_owned_colliders=True)


def adjoint_inputs(jscene, S, seed=3, R=96):
    """Bounce-like origins in the scene, S unit direction sets (one per
    target, then free directions) and a random cotangent [R, S]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12.0, 12.0, (R, 3)).astype(np.float32)
    dirs = []
    for s in range(S):
        v = (np.asarray(jscene.target_positions[s]) - o if s < 2
             else rng.normal(size=(R, 3)))
        dirs.append((v / np.linalg.norm(v, axis=1, keepdims=True))
                    .astype(np.float32))
    g = rng.normal(size=(R, S)).astype(np.float32)
    jskips = (0, 1, J_NO_SKIP)[:S]
    skips = (0, 1, NO_SKIP)[:S]
    return o, dirs, g, jskips, skips


@pytest.fixture(scope="module")
def adjoints(fixture_scene):
    """S -> (inputs, JAX B4 output, JAX B5 output), interpret mode."""
    pb = PallasBackend(fixture_scene, interpret=True)
    out = {}
    for S in (2, 3):
        o, dirs, g, jskips, skips = adjoint_inputs(fixture_scene, S)
        args = (pb._chord_fields, pb.counts, jnp.asarray(o),
                [jnp.asarray(x) for x in dirs], jskips, jnp.asarray(g))
        out[S] = ((o, dirs, g, skips),
                  JF.run_multi_chord_dens_bwd(*args, interpret=True),
                  JF.run_multi_chord_bwd(*args, interpret=True))
    return out


DENS_KEYS = ("s_dens", "a_dens", "o_dens")


def close_sums(got, ref, fields, o, dirs, skips, g):
    """Density gradients are sums over rays and sets of g x chord with g
    of both signs, so they cancel: beside rtol 2e-4, the absolute
    tolerance is 2e-5 of the sum of |g x chord| (float32 sums in another
    order, and the JAX tier's approximate reciprocal, ~1e-7 relative per
    term)."""
    scale = F.multi_chord_dens_bwd_plain(fields, t(o), [t(x) for x in dirs],
                                         skips, t(np.abs(g)))
    for k, a, m in zip(DENS_KEYS, got, scale):
        assert (a != 0).any(), k
        np.testing.assert_allclose(a.numpy(), np.asarray(ref[k]), rtol=2e-4,
                                   atol=2e-5 * float(m.max()), err_msg=k)


def adjoint_spy(monkeypatch):
    """The adjoints MultiChordLoss's backward runs, in order ("B4", "B5")."""
    ran = []
    for key, name in (("B4", "run_multi_chord_dens_bwd"),
                      ("B5", "run_multi_chord_bwd")):
        def spy(*args, _fn=getattr(F, name), _key=key):
            ran.append(_key)
            return _fn(*args)

        monkeypatch.setattr(F, name, spy)
    return ran


class TestChordAdjoints:
    @pytest.mark.parametrize("S", [2, 3])
    def test_dens_bwd_matches_pallas(self, fixture_scene, adjoints, S):
        (o, dirs, g, skips), jd, _ = adjoints[S]
        fields = prepare_fields(carry(fixture_scene))
        got = F.run_multi_chord_dens_bwd(fields, t(o), [t(x) for x in dirs],
                                         skips, t(g))
        close_sums(got, jd, fields, o, dirs, skips, g)

    @pytest.mark.parametrize("S", [2, 3])
    def test_full_bwd_matches_pallas(self, fixture_scene, adjoints, S):
        (o, dirs, g, skips), _, (jo, jdd, jdens) = adjoints[S]
        fields = prepare_fields(carry(fixture_scene))
        d_o, d_dirs, dens = F.run_multi_chord_bwd(
            fields, t(o), [t(x) for x in dirs], skips, t(g))
        assert (d_o != 0).any()
        close(d_o, jo)
        for s in range(S):
            close(d_dirs[s], jdd[s])
        close_sums(dens, jdens, fields, o, dirs, skips, g)

    def test_full_density_equals_dens_only(self, fixture_scene, adjoints):
        # B5's density output is B4's quantity (gv x chord), bit for bit.
        (o, dirs, g, skips), _, _ = adjoints[3]
        fields = prepare_fields(carry(fixture_scene))
        args = (fields, t(o), [t(x) for x in dirs], skips, t(g))
        for a, b in zip(F.run_multi_chord_bwd(*args)[2],
                        F.run_multi_chord_dens_bwd(*args)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("dens_only", [False, True])
    def test_function_matches_dense_autograd(self, fixture_scene, dens_only,
                                             monkeypatch):
        # MultiChordLoss (B3 forward) against torch autograd through the
        # dense tier's permeation chords. Its backward runs B4 alone when
        # only the densities need gradients (dens_only), B5 otherwise.
        scene = carry(fixture_scene)
        o, dirs, g, _, skips = adjoint_inputs(fixture_scene, 3, seed=4)
        dens = [t(x.material.density, grad=True)
                for x in (scene.spheres, scene.aabbs, scene.obbs)]
        sc = scene.replace(
            spheres=dataclasses.replace(scene.spheres, material=dataclasses
                                        .replace(scene.spheres.material,
                                                 density=dens[0])),
            aabbs=dataclasses.replace(scene.aabbs, material=dataclasses
                                      .replace(scene.aabbs.material,
                                               density=dens[1])),
            obbs=dataclasses.replace(scene.obbs, material=dataclasses
                                     .replace(scene.obbs.material,
                                              density=dens[2])))
        ins = [t(x, grad=not dens_only) for x in [o] + dirs]
        wrt = dens if dens_only else ins + dens
        ref = DenseBackend(sc).multi_permeation_loss(ins[0], ins[1:], skips)
        ref_g = torch.autograd.grad((ref * t(g)).sum(), wrt)
        ran = adjoint_spy(monkeypatch)
        out = multi_chord_loss(prepare_fields(sc), skips, ins[0], dens,
                               ins[1:])
        close(out, ref.detach().numpy(), rtol=1e-5, atol=1e-4)
        got_g = torch.autograd.grad((out * t(g)).sum(), wrt)
        assert ran == (["B4"] if dens_only else ["B5"])
        for a, b in zip(got_g, ref_g):
            close(a, b.numpy())


# ---------------------------------------------------------------------------
# The winner recompute and the weighted impulse response
# ---------------------------------------------------------------------------


def test_primitive_t_per_ray_matches_jax(fixture_scene):
    rng = np.random.default_rng(5)
    R = 64
    o = rng.uniform(-4.0, 4.0, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = rng.normal(size=(R,)).astype(np.float32)
    hit, jt, idx = jint.closest_hit(o, d, fixture_scene)
    uni = jint.unified_arrays(fixture_scene)
    keys = ("kind", "center", "half_extents", "inv_rot")
    attrs = {k: np.asarray(uni[k])[np.asarray(idx)] for k in keys}
    hit = np.array(hit)
    assert hit.mean() > 0.3 and len(set(attrs["kind"][hit])) == 3

    def jf(o, d, center, half):
        tt = jint.primitive_t_per_ray(o, d, attrs["kind"], center, half,
                                      attrs["inv_rot"])
        return jnp.sum(jnp.where(hit, tt * w, 0.0)), tt

    (_, jt_rec), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        o, d, attrs["center"], attrs["half_extents"])
    ins = [t(x, grad=True) for x in (o, d, attrs["center"],
                                     attrs["half_extents"])]
    tt = tint.primitive_t_per_ray(ins[0], ins[1],
                                  torch.as_tensor(attrs["kind"]), ins[2],
                                  ins[3], t(attrs["inv_rot"]))
    close(tt[hit], np.asarray(jt_rec)[hit], rtol=1e-5, atol=1e-5)
    close(tt[hit], np.asarray(jt)[hit], rtol=1e-5, atol=1e-5)
    torch.where(torch.as_tensor(hit), tt * t(w), 0.0).sum().backward()
    for x, ref in zip(ins, jg):
        close(x.grad, ref)


def test_weighted_impulse_response_matches_jax():
    rng = np.random.default_rng(6)
    dist = rng.uniform(0.0, 150.0, (40, 5)).astype(np.float32)
    dist[rng.random((40, 5)) < 0.3] = 0.0  # no echo in these slots
    wts = rng.uniform(0.1, 1.0, (40, 5)).astype(np.float32)
    up = rng.normal(size=(48,)).astype(np.float32)
    jcfg = JConfig(num_reverb_bins=48, ir_max_distance=125.0)
    cfg = ttypes.TraceConfig(num_reverb_bins=48, ir_max_distance=125.0)

    def jf(dist, wts):
        ir = jrev.impulse_response(dist, jcfg, weights=wts)
        return jnp.sum(ir * up), ir

    (_, jir), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        dist, wts)
    ins = [t(dist, grad=True), t(wts, grad=True)]
    ir = trev.impulse_response(ins[0], cfg, weights=ins[1])
    close(ir, jir, rtol=1e-5, atol=1e-6)
    (ir * t(up)).sum().backward()
    for x, ref in zip(ins, jg):
        close(x.grad, ref)
    # weights=None keeps the forward's one unit per echo.
    np.testing.assert_allclose(
        trev.impulse_response(t(dist), cfg).numpy(),
        np.asarray(jrev.impulse_response(dist, jcfg)), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# loudness_map: values and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grad_setup():
    """The setup of tests/test_pallas_grad.py."""
    jscene = j_random_scene(jax.random.key(7), num_spheres=7, num_aabbs=9,
                            num_obbs=8, num_targets=2, extent=14.0,
                            size_range=(1.0, 4.0),
                            target_owned_colliders=True)
    cfg_kw = dict(ray_count=48, max_bounces=3, max_ray_life=200.0)
    jtarget = jdiff.Loudness(muffle=jnp.full((2,), 0.3),
                             permeation=jnp.full((2,), 0.2),
                             reverb_energy=jnp.asarray(0.05))
    return jscene, cfg_kw, np.asarray(fibonacci_directions(48)), jtarget


def _pallas_diff(s):
    return PallasBackend(s, interpret=True, differentiable=True)


@pytest.fixture(scope="module")
def jax_grads(grad_setup):
    """backend -> (loudness map, loss, grads of (params, origin, target
    positions)), each computed once."""
    jscene, cfg_kw, dirs, jtarget = grad_setup
    cfg = JConfig(**cfg_kw)
    out = {}
    for name, bf in (("jnp", None), ("pallas_interpret", _pallas_diff)):
        def loss(params, origin, tp, bf=bf):
            sc = params.into_scene(jscene.replace(target_positions=tp))
            pred = jdiff.loudness_map(origin, dirs, sc, cfg,
                                      backend=bf(sc) if bf else None)
            return jdiff._loudness_mse(pred, jtarget), pred

        (val, lmap), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
            jdiff.SceneParams.from_scene(jscene), jnp.zeros(3),
            jscene.target_positions)
        out[name] = (lmap, val, grads)
    return out


def port_grads(grad_setup, backend, with_pose=True):
    """(loss, grads of the 9 materials, the origin and the target
    positions); the poses get none without ``with_pose``."""
    jscene, cfg_kw, dirs, jtarget = grad_setup
    cfg = ttypes.TraceConfig(**cfg_kw)
    scene = carry(jscene)
    params = tdiff.SceneParams.from_scene(scene)
    for x in params.leaves():
        x.requires_grad_(True)
    origin = torch.zeros(3, requires_grad=with_pose)
    tp = scene.target_positions.clone().requires_grad_(with_pose)
    loss = tdiff.loudness_loss(params, scene.replace(target_positions=tp),
                               origin, t(dirs), cfg,
                               loudness_from_arrays(jtarget),
                               backend=backend, device="cpu")
    loss.backward()
    return loss, [x.grad for x in params.leaves()] + [origin.grad, tp.grad]


def jax_leaves(grads):
    params, origin, tp = grads
    return jax.tree.leaves(params) + [origin, tp]


PORT_VS_JAX = [("dense", "jnp"), ("kernel", "pallas_interpret")]


class TestLoudnessMap:
    @pytest.mark.parametrize("backend,jax_backend", PORT_VS_JAX)
    def test_values_match_jax(self, grad_setup, jax_grads, backend,
                              jax_backend):
        jscene, cfg_kw, dirs, _ = grad_setup
        lmap = tdiff.loudness_map(torch.zeros(3), t(dirs), carry(jscene),
                                  ttypes.TraceConfig(**cfg_kw),
                                  backend=backend, device="cpu")
        ref = jax_grads[jax_backend][0]
        for k in ("muffle", "permeation", "reverb_energy"):
            close(getattr(lmap, k), getattr(ref, k), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("backend,jax_backend", PORT_VS_JAX)
    def test_grads_match_jax(self, grad_setup, jax_grads, backend,
                             jax_backend):
        # Materials (9 leaves), the listener origin and the target
        # positions.
        loss, grads = port_grads(grad_setup, backend)
        _, jloss, jg = jax_grads[jax_backend]
        close(loss, jloss, rtol=1e-5, atol=1e-7)
        leaves = jax_leaves(jg)
        assert len(grads) == len(leaves) == 11
        for name, a, b in zip(range(11), grads, leaves):
            assert a is not None, name
            close(a, b)
        assert float(grads[-2].abs().sum()) > 0.0  # origin
        assert float(grads[-1].abs().sum()) > 0.0  # target positions

    def test_dens_only_adjoint_matches_full(self, grad_setup, monkeypatch):
        # Without pose gradients the backward runs B4 alone: the material
        # gradients are the full adjoint's
        # (tests/test_pallas_grad.py::TestDensOnlyAdjoint).
        ran = adjoint_spy(monkeypatch)
        _, full = port_grads(grad_setup, "kernel", with_pose=True)
        _, dens = port_grads(grad_setup, "kernel", with_pose=False)
        assert ran == ["B5", "B4"]
        assert dens[9] is None and dens[10] is None
        for a, b in zip(full[:9], dens[:9]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)

    def test_differentiable_mode_keeps_forward_values(self, grad_setup):
        jscene, cfg_kw, dirs, _ = grad_setup
        scene = carry(jscene)
        cfg = ttypes.TraceConfig(**cfg_kw, num_reverb_bins=16)
        maps = [tdiff.loudness_map(torch.zeros(3), t(dirs), scene, cfg,
                                   backend=KernelBackend(scene, **kw),
                                   device="cpu")
                for kw in ({}, dict(differentiable=True))]
        for f in dataclasses.fields(tdiff.Loudness):
            a, b = (getattr(m, f.name) for m in maps)
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=1e-5,
                                       atol=1e-6)

    def test_reverb_ir_matches_jax(self, grad_setup):
        jscene, cfg_kw, dirs, _ = grad_setup
        cfg_kw = dict(cfg_kw, num_reverb_bins=32, ir_max_distance=80.0)
        ref = jax.jit(lambda o: jdiff.loudness_map(
            o, dirs, jscene, JConfig(**cfg_kw)))(jnp.zeros(3))
        got = tdiff.loudness_map(torch.zeros(3), t(dirs), carry(jscene),
                                 ttypes.TraceConfig(**cfg_kw),
                                 backend="dense", device="cpu")
        close(got.reverb_ir, ref.reverb_ir, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_train(grad_setup):
    """Three JAX materials-training steps (jnp tier), parameters after
    each, and one pose-recovery step."""
    jscene, cfg_kw, dirs, jtarget = grad_setup
    cfg = JConfig(**cfg_kw)
    step, opt = jdiff.make_train_step(cfg)
    params = jdiff.SceneParams.from_scene(jscene)
    state = opt.init(params)
    trail = []
    for _ in range(3):
        params, state, loss = step(params, state, jscene, jnp.zeros(3), dirs,
                                   jtarget)
        trail.append((jax.tree.map(np.asarray, params), float(loss)))
    pstep, popt = jdiff.make_pose_recovery_step(cfg)
    pose = jdiff.PoseParams(origin=jnp.asarray([0.4, -0.3, 0.2]),
                            target_positions=jscene.target_positions)
    pose, _, ploss = pstep(pose, popt.init(pose), jscene, dirs, jtarget)
    return trail, (jax.tree.map(np.asarray, pose), float(ploss))


# Adam moves each parameter by about lr x sign(g) per step, so the
# parameters agree to float32 rounding of that update wherever the two
# gradients agree in sign; 1e-5 absolute is ~1e-3 of one step's lr.
TRAIN = dict(rtol=1e-5, atol=1e-5)


class TestTraining:
    @pytest.mark.parametrize("backend", ["dense", "kernel"])
    def test_three_steps_match_jax(self, grad_setup, jax_train, backend):
        jscene, cfg_kw, dirs, jtarget = grad_setup
        trail, _ = jax_train
        step, init = tdiff.make_train_step(ttypes.TraceConfig(**cfg_kw),
                                           backend=backend, device="cpu")
        scene = carry(jscene)
        params = params_from_arrays(
            jax.tree.map(np.asarray, jdiff.SceneParams.from_scene(jscene)))
        opt = init(params)
        target = loudness_from_arrays(jtarget)
        for jparams, jloss in trail:
            params, opt, loss = step(params, opt, scene, torch.zeros(3),
                                     t(dirs), target)
            np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
            for a, b in zip(params.leaves(), jax.tree.leaves(jparams)):
                close(a, b, **TRAIN)

    def test_pose_recovery_step_matches_jax(self, grad_setup, jax_train):
        jscene, cfg_kw, dirs, jtarget = grad_setup
        _, (jpose, jloss) = jax_train
        step, init = tdiff.make_pose_recovery_step(
            ttypes.TraceConfig(**cfg_kw), backend="kernel", device="cpu")
        scene = carry(jscene)
        pose = tdiff.PoseParams(origin=torch.tensor([0.4, -0.3, 0.2]),
                                target_positions=scene.target_positions
                                .clone())
        pose, _, loss = step(pose, init(pose), scene, t(dirs),
                             loudness_from_arrays(jtarget))
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
        close(pose.origin, jpose.origin, **TRAIN)
        close(pose.target_positions, jpose.target_positions, **TRAIN)

    def test_source_recovery_step_matches_jax(self, grad_setup):
        # Two listeners' recordings of the true scene, sources started
        # 0.5 off on every axis: one triangulation step of each package.
        jscene, cfg_kw, dirs, _ = grad_setup
        jcfg = JConfig(**cfg_kw)
        origins = np.array([[0.0, 0.0, 0.0], [3.0, -2.0, 1.0]], np.float32)
        recs = [jdiff.loudness_map(jnp.asarray(o), dirs, jscene, jcfg)
                for o in origins]
        tp0 = np.asarray(jscene.target_positions) + np.float32(0.5)
        jstep, jopt = jdiff.make_source_recovery_step(jcfg, 2)
        jtp, _, jloss = jstep(jnp.asarray(tp0), jopt.init(jnp.asarray(tp0)),
                              jscene, jnp.asarray(origins), dirs,
                              jdiff.stack_loudness(recs))
        step, init = tdiff.make_source_recovery_step(
            ttypes.TraceConfig(**cfg_kw), 2, backend="kernel", device="cpu")
        rec = tdiff.stack_loudness([
            loudness_from_arrays(jax.tree.map(np.asarray, r)) for r in recs])
        tp = t(tp0)
        tp, _, loss = step(tp, init(tp), carry(jscene), t(origins), t(dirs),
                           rec)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(loss) > 0.0
        assert bool((tp.detach() != t(tp0)).any())
        close(tp, jtp, **TRAIN)

    def test_loss_decreases(self):
        # tests/test_gradients.py::TestTraining::test_loss_decreases, in
        # float32, on the kernel backend (B4's plain version here).
        jscene = j_random_scene(jax.random.key(11), num_spheres=10,
                                num_aabbs=14, num_obbs=10, num_targets=2,
                                extent=12.0, size_range=(1.5, 5.0))
        scene = carry(jscene).replace(target_positions=torch.tensor(
            [[2.0, 1.0, 0.5], [-1.5, 2.5, 1.0]]))
        cfg = ttypes.TraceConfig(ray_count=64, max_bounces=3,
                                 max_ray_life=150.0)
        origin = torch.zeros(3)
        dirs = t(fibonacci_directions(64))
        params = tdiff.SceneParams.from_scene(scene)

        def perturb(m):
            return ttypes.Materials(torch.clamp(m.absorption + 0.15, 0, 1),
                                    m.density * 0.6, m.echo * 1.4)

        target_params = tdiff.SceneParams(*(perturb(m) for m in (
            params.sphere, params.aabb, params.obb)))
        with torch.no_grad():
            target = tdiff.loudness_map(origin, dirs,
                                        target_params.into_scene(scene), cfg,
                                        device="cpu")
        step, init = tdiff.make_train_step(cfg, device="cpu")
        opt = init(params)
        losses = []
        for _ in range(25):
            params, opt, loss = step(params, opt, scene, origin, dirs,
                                     target)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.7, losses


# ---------------------------------------------------------------------------
# Device rules
# ---------------------------------------------------------------------------


class TestDeviceRules:
    def test_entry_points_default_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = ttypes.TraceConfig(ray_count=8)
        for make in (lambda: tdiff.make_train_step(cfg),
                     lambda: tdiff.make_pose_recovery_step(cfg),
                     lambda: tdiff.make_source_recovery_step(cfg, 2)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
        scene = scene_from_arrays(jax.tree.map(
            np.asarray, j_random_scene(jax.random.key(0), 2, 2, 2)))
        with pytest.raises(RuntimeError, match="CUDA"):
            tdiff.loudness_map(torch.zeros(3), torch.ones((8, 3)), scene,
                               cfg)

    def test_inputs_must_lie_on_the_device(self):
        cfg = ttypes.TraceConfig(ray_count=8)
        scene = scene_from_arrays(jax.tree.map(
            np.asarray, j_random_scene(jax.random.key(0), 2, 2, 2)))
        with pytest.raises(ValueError, match="origin"):
            tdiff.loudness_map(torch.zeros(3, device="meta"),
                               torch.ones((8, 3)), scene, cfg, device="cpu")
        with pytest.raises(ValueError, match="backend"):
            tdiff.loudness_map(torch.zeros(3), torch.ones((8, 3)), scene,
                               cfg, backend="pallas", device="cpu")
