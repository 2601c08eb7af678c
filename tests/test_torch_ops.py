"""PyTorch port, module by module, against the JAX reference package.

The same numpy inputs (and JAX scenes carried across with
``convert.scene_from_arrays``) go through each JAX function and its
counterpart in ``audio_raytracer_tpu_torch``. Tolerances: rtol 1e-5 on
sums and settings, 1e-6 on geometry; booleans and counts exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu import types as jtypes
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops import fibonacci as jfib
from audio_raytracer_tpu.ops import intersect as jint
from audio_raytracer_tpu.ops import permeation as jperm
from audio_raytracer_tpu.ops import process as jproc
from audio_raytracer_tpu.ops import quaternion as jquat
from audio_raytracer_tpu.ops import reverb as jrev
from audio_raytracer_tpu.ops import trace as jtrace
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.models.raytracer import random_scene
from audio_raytracer_tpu_torch.ops import fibonacci as tfib
from audio_raytracer_tpu_torch.ops import intersect as tint
from audio_raytracer_tpu_torch.ops import permeation as tperm
from audio_raytracer_tpu_torch.ops import process as tproc
from audio_raytracer_tpu_torch.ops import quaternion as tquat
from audio_raytracer_tpu_torch.ops import reverb as trev
from audio_raytracer_tpu_torch.ops import trace as ttrace

torch.set_num_threads(1)

GEOM = dict(rtol=1e-6, atol=1e-5)


def carry(jscene):
    return scene_from_arrays(jax.tree.map(np.asarray, jscene), device="cpu")


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


def assert_close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


@pytest.fixture(scope="module")
def jscene():
    return j_random_scene(jax.random.key(11), num_spheres=7, num_aabbs=9,
                          num_obbs=8, num_targets=3, extent=12.0,
                          size_range=(0.5, 3.0),
                          target_owned_colliders=True)


@pytest.fixture(scope="module")
def scene(jscene):
    return carry(jscene)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(3)
    o = rng.uniform(-6.0, 6.0, (48, 3)).astype(np.float32)
    d = rng.normal(size=(48, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = [0.0, 1.0, 0.0]  # an axis-aligned ray exercises the 1e-12 nudge
    return o, d


class TestFibonacci:
    @pytest.mark.parametrize("n", [2, 37, 256])
    def test_matches_jax(self, n):
        assert_close(tfib.fibonacci_directions(n, device="cpu"),
                     jfib.fibonacci_directions(n), rtol=1e-5, atol=1e-6)

    def test_single_ray_is_nan(self):
        # The reference's n - 1 denominator: 0 / 0.
        assert torch.isnan(tfib.fibonacci_directions(1, device="cpu")[0, 1])


class TestQuaternion:
    def test_rotate_matrix_inverse(self, rays):
        rng = np.random.default_rng(5)
        q = rng.normal(size=(48, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        v = rays[1]
        assert_close(tquat.rotate(t(q), t(v)), jquat.rotate(q, v), **GEOM)
        assert_close(tquat.to_matrix(t(q)), jquat.to_matrix(q), **GEOM)
        assert_close(tquat.inverse(t(q)), jquat.inverse(q), **GEOM)
        assert_close(tquat.normalize(t(q * 2.0)), jquat.normalize(q * 2.0),
                     **GEOM)
        m = tquat.to_matrix(t(q))
        assert_close((m @ t(v)[..., None])[..., 0], jquat.rotate(q, v),
                     rtol=1e-5, atol=1e-6)

    def test_from_axis_angle(self):
        rng = np.random.default_rng(6)
        axis = rng.normal(size=(10, 3)).astype(np.float32)
        angle = rng.uniform(0, 6.28, (10,)).astype(np.float32)
        assert_close(tquat.from_axis_angle(t(axis), t(angle)),
                     jquat.from_axis_angle(axis, angle), **GEOM)


class TestIntersect:
    def test_primitive_t_grids(self, jscene, scene, rays):
        o, d = rays
        sp, ab, ob = jscene.spheres, jscene.aabbs, jscene.obbs
        tsp, tab, tob = scene.spheres, scene.aabbs, scene.obbs
        cases = [
            (tint.sphere_t(t(o), t(d), tsp.center, tsp.radius, tsp.active),
             jint.sphere_t(o, d, sp.center, sp.radius, sp.active)),
            (tint.aabb_t(t(o), t(d), tab.center, tab.half_extents,
                         tab.active),
             jint.aabb_t(o, d, ab.center, ab.half_extents, ab.active)),
            (tint.obb_t(t(o), t(d), tob.center, tob.half_extents,
                        tob.inv_rot, tob.active),
             jint.obb_t(o, d, ob.center, ob.half_extents, ob.inv_rot,
                        ob.active)),
        ]
        for port, ref in cases:
            ref = np.asarray(ref)
            np.testing.assert_array_equal(np.isinf(port.numpy()),
                                          np.isinf(ref))
            fin = np.isfinite(ref)
            np.testing.assert_allclose(port.numpy()[fin], ref[fin], **GEOM)

    def test_closest_hit_and_grid(self, jscene, scene, rays):
        o, d = rays
        hit, tt, idx = tint.closest_hit(t(o), t(d), scene)
        jhit, jt, jidx = jint.closest_hit(o, d, jscene)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        h = hit.numpy()
        np.testing.assert_allclose(tt.numpy()[h], np.asarray(jt)[h], **GEOM)
        skip = np.arange(48, dtype=np.int32) % 3
        g = tint.scene_t_grid(t(o), t(d), scene, t(skip, torch.int32))
        jg = np.asarray(jint.scene_t_grid(o, d, jscene, skip))
        np.testing.assert_array_equal(np.isinf(g.numpy()), np.isinf(jg))

    @pytest.mark.parametrize("skip", [None, 0, 2])
    def test_any_hit_within(self, jscene, scene, rays, skip):
        o, d = rays
        lim = np.linspace(1.0, 25.0, 48).astype(np.float32)
        np.testing.assert_array_equal(
            tint.any_hit_within(t(o), t(d), t(lim), scene, skip).numpy(),
            np.asarray(jint.any_hit_within(o, d, lim, jscene, skip)))

    @pytest.mark.parametrize("skip", [None, 1])
    def test_permeation_loss(self, jscene, scene, rays, skip):
        o, d = rays
        assert_close(tint.permeation_loss(t(o), t(d), scene, skip),
                     jint.permeation_loss(o, d, jscene, skip),
                     rtol=1e-5, atol=1e-5)

    def test_unified_and_packed(self, jscene, scene):
        uni = tint.unified_arrays(scene)
        juni = jint.unified_arrays(jscene)
        for k, v in uni.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(juni[k]),
                                          err_msg=k)
        packed = tint.packed_unified_table(uni)
        assert_close(packed, jint.packed_unified_table(juni), rtol=0, atol=0)
        rows = tint.unpack_attr_rows(packed[[0, 9, 20]])
        jrows = jint.unpack_attr_rows(jint.packed_unified_table(juni)[
            jnp.asarray([0, 9, 20])])
        for k in rows:
            assert_close(rows[k], jrows[k], rtol=0, atol=0)

    def test_reflection_normal_all_kinds(self, jscene, scene, rays):
        # Hit points on each primitive of the scene, every kind in one
        # batch; OBBs keep the reference's swapped-rotation quirk.
        uni = jint.unified_arrays(jscene)
        P = uni["kind"].shape[0]
        rng = np.random.default_rng(9)
        idx = np.arange(48) % P
        hp = (np.asarray(uni["center"])[idx]
              + rng.uniform(-1.5, 1.5, (48, 3)).astype(np.float32))
        args = [uni["kind"], uni["center"], uni["half_extents"],
                uni["inv_rot"]]
        jn = jint.reflection_normal(hp, *(a[idx] for a in args))
        tuni = tint.unified_arrays(scene)
        tn = tint.reflection_normal(
            t(hp), *(tuni[k][torch.as_tensor(idx)] for k in
                     ("kind", "center", "half_extents", "inv_rot")))
        assert_close(tn, jn, **GEOM)
        # The quirk changes the answer: the un-swapped pairing differs.
        ob = np.asarray(uni["kind"])[idx] == 2
        assert ob.any()
        c = np.asarray(uni["center"])[idx][ob]
        q = np.asarray(uni["inv_rot"])[idx][ob]
        local = jquat.rotate(q, hp[ob] - c)
        straight = jquat.rotate(jquat.inverse(q), jint._box_axis_normal(
            local, np.asarray(uni["half_extents"])[idx][ob]))
        assert not np.allclose(np.asarray(straight), tn.numpy()[ob])

    def test_box_axis_normal_ties_fall_to_z(self):
        p = np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 0.5], [0.2, 1.0, 1.0]],
                     np.float32)
        h = np.ones_like(p)
        assert_close(tint._box_axis_normal(t(p), t(h)),
                     jint._box_axis_normal(p, h), rtol=0, atol=0)

    def test_reflect(self, rays):
        _, d = rays
        n = np.roll(d, 1, axis=0)
        assert_close(tint.reflect(t(d), t(n)), jint.reflect(d, n), **GEOM)


class TestTypesAndConvert:
    def test_config_defaults_match(self):
        for f in dataclasses.fields(jtypes.TraceConfig):
            assert getattr(ttypes.TraceConfig(), f.name) == \
                getattr(jtypes.TraceConfig(), f.name), f.name

    # Compaction and the bfloat16 tier are ported; a compute type neither
    # package has raises, with or without compaction.
    @pytest.mark.parametrize("kw", [dict(compute_dtype="float16"),
                                    dict(compute_dtype="float16",
                                         compact_rays=True)])
    def test_later_slices_raise(self, kw):
        with pytest.raises(ValueError):
            ttypes.TraceConfig(**kw)

    @pytest.mark.parametrize("make", [
        lambda: tfib.fibonacci_directions(8),
        lambda: ttypes.Materials.default(2),
        lambda: ttypes.Spheres.build([[0, 0, 0]], [1.0]),
        lambda: ttypes.Aabbs.empty(),
        lambda: ttypes.Obbs.build([[0, 0, 0]], [[1, 1, 1]], [[0, 0, 0, 1]]),
        lambda: ttypes.Scene.build(),
        lambda: scene_from_arrays(jax.tree.map(np.asarray, j_random_scene(
            jax.random.key(0), 1, 1, 1))),
    ], ids=["fibonacci", "materials", "spheres", "aabbs", "obbs", "scene",
            "convert"])
    def test_constructors_default_to_the_card(self, monkeypatch, make):
        # No CUDA device: a default call raises resolve_device's error
        # instead of building on the CPU.
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

    def test_scene_carried_across(self, jscene, scene):
        flat, _ = jax.tree.flatten(jscene)
        ours = [scene.spheres.center, scene.spheres.radius,
                *dataclasses.astuple(scene.spheres.material),
                scene.spheres.target_id, scene.spheres.active]
        for a, b in zip(ours, flat):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert scene.num_primitives == jscene.num_primitives
        assert scene.num_targets == jscene.num_targets

    def test_random_scene_distributions(self):
        s = random_scene(4, 50, 60, 40, num_targets=5, extent=20.0,
                         target_owned_colliders=True, device="cpu")
        assert s.spheres.count == 55 and s.num_targets == 5
        assert float(s.aabbs.center.abs().max()) <= 20.0
        assert float(s.target_positions.abs().max()) <= 16.0
        q = s.obbs.inv_rot
        assert_close(torch.linalg.vector_norm(q, dim=-1), np.ones(40),
                     rtol=1e-5)
        m = s.aabbs.material
        assert 0.0 <= float(m.absorption.min()) <= float(
            m.absorption.max()) <= 0.3
        assert s.spheres.target_id[-5:].tolist() == [0, 1, 2, 3, 4]
        # Reproducible from the seed.
        s2 = random_scene(4, 50, 60, 40, num_targets=5, extent=20.0,
                          target_owned_colliders=True, device="cpu")
        assert torch.equal(s.obbs.center, s2.obbs.center)


class TestTraceHelpers:
    @pytest.mark.parametrize("R,B", [(130, 2), (100, 3), (7, 4), (33, 5)])
    def test_accum_batch_ids(self, R, B):
        np.testing.assert_array_equal(ttrace.accum_batch_ids(R, B).numpy(),
                                      np.asarray(jtrace.accum_batch_ids(R, B)))


class TestPermeation:
    @pytest.mark.parametrize("B", [1, 3])
    def test_matches_jax(self, jscene, scene, B):
        cfg_j = jtypes.TraceConfig(ray_count=96, num_accum_batches=B)
        cfg_t = ttypes.TraceConfig(ray_count=96, num_accum_batches=B)
        d = np.asarray(jfib.fibonacci_directions(96))
        origin = np.array([0.5, -0.25, 1.0], np.float32)
        ref = jperm.permeation(origin, d, jscene, cfg_j)
        port = tperm.permeation(t(origin), t(d), scene, cfg_t)
        assert_close(port, ref, rtol=1e-5, atol=1e-3)

    def test_overwrite_quirk_last_hitting_ray(self, jscene, scene):
        # first_t forces which rays hit: only the last hitting ray of
        # each batch contributes, and a batch without hits stays 0.
        cfg_j = jtypes.TraceConfig(ray_count=12, num_accum_batches=3)
        cfg_t = ttypes.TraceConfig(ray_count=12, num_accum_batches=3)
        d = np.asarray(jfib.fibonacci_directions(12))
        first = np.full(12, np.inf, np.float32)
        first[[1, 2, 9]] = [3.0, 4.0, 2.5]
        o = np.zeros(3, np.float32)
        ref = np.asarray(jperm.permeation(o, d, jscene, cfg_j,
                                          first_t=first))
        port = tperm.permeation(t(o), t(d), scene, cfg_t,
                                first_t=t(first)).numpy()
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-3)
        assert (port[1] == 0).all() and (port[0] != 0).all()


class TestReverbAndProcess:
    @pytest.fixture
    def echo(self):
        rng = np.random.default_rng(2)
        e = rng.uniform(0.0, 180.0, (64, 5)).astype(np.float32)
        e[rng.uniform(size=e.shape) < 0.4] = 0.0
        return e

    @pytest.mark.parametrize("bins", [1, 16, 64])
    def test_impulse_response(self, echo, bins):
        cfg_j = jtypes.TraceConfig(num_reverb_bins=bins)
        cfg_t = ttypes.TraceConfig(num_reverb_bins=bins)
        assert_close(trev.impulse_response(t(echo), cfg_t),
                     jrev.impulse_response(echo, cfg_j), rtol=1e-5,
                     atol=1e-5)

    def test_impulse_response_needs_bins(self, echo):
        with pytest.raises(ValueError):
            trev.impulse_response(t(echo), ttypes.TraceConfig())

    def test_process_counts_zero_entries(self, jscene, scene, echo):
        rng = np.random.default_rng(8)
        muffle = rng.integers(0, 200, (2, 3)).astype(np.int32)
        perm = rng.uniform(0.0, 64.0, (2, 3)).astype(np.float32)
        cfg_j = jtypes.TraceConfig(ray_count=64)
        cfg_t = ttypes.TraceConfig(ray_count=64)
        ref = jproc.process(jtypes.TraceResult(echo, muffle, perm), jscene,
                            cfg_j)
        port = tproc.process(ttypes.TraceResult(
            t(echo), t(muffle, torch.int32), t(perm)), scene, cfg_t)
        for k in ("muffle", "reverb_strength", "reverb_volume",
                  "perceived_position"):
            assert_close(getattr(port, k), getattr(ref, k), rtol=1e-5,
                         atol=1e-7)
        # The zero-counting quirk: reverb_volume is the zero fraction.
        assert float(port.reverb_volume) == pytest.approx(
            (echo == 0).mean(), rel=1e-6)
