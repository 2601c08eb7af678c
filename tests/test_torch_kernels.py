"""The port's kernel modules (B1 closest hit, B2 fused occlusion, B3 fused
chords) against the JAX package's Pallas kernels and dense tier.

On the CPU the port's ``KernelBackend`` runs each kernel's plain version;
the JAX side runs ``PallasBackend(scene, interpret=True)``, as the JAX
package's own tests do, and its ``DenseBackend``. Tolerances are those of
``tests/test_pallas.py``. The CUDA kernels themselves run only on the
card, where chip_smoke.py holds each against its plain version.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops import intersect as jint
from audio_raytracer_tpu.ops.backend import NO_SKIP as J_NO_SKIP
from audio_raytracer_tpu.ops.backend import DenseBackend as JDense
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.ops.pallas import PallasBackend
from audio_raytracer_tpu.types import Aabbs as JAabbs
from audio_raytracer_tpu.types import Scene as JScene
from audio_raytracer_tpu.types import Spheres as JSpheres
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP, DenseBackend
from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import (
    KernelBackend,
    prepare_fields,
)

torch.set_num_threads(1)


def carry(jscene):
    return scene_from_arrays(jax.tree.map(np.asarray, jscene), device="cpu")


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


@pytest.fixture(scope="module")
def jscene():
    # The fixture scene of tests/test_pallas.py.
    return j_random_scene(jax.random.key(21), num_spheres=9, num_aabbs=13,
                          num_obbs=11, num_targets=2, extent=15.0,
                          size_range=(1.0, 4.0), target_owned_colliders=True)


@pytest.fixture(scope="module")
def backends(jscene):
    scene = carry(jscene)
    return (KernelBackend(scene), DenseBackend(scene),
            PallasBackend(jscene, interpret=True), JDense(jscene))


@pytest.fixture(scope="module")
def rays():
    return np.zeros((96, 3), np.float32), np.asarray(fibonacci_directions(96))


def bounce_sets(target_positions, o, d):
    """One echo set + one muffle set per target from a bounce-like offset
    point (tests/test_pallas.py::TestFusedKernels._sets)."""
    origin_pt = np.array([1.0, 2.0, 0.5], np.float32)
    off = o + d * 3.0
    dirs = [np.asarray(jint.safe_normalize(origin_pt - off))]
    limits = [np.asarray(jint.safe_norm(origin_pt - off))]
    for tp in np.asarray(target_positions):
        to_t = tp - off
        dist = np.asarray(jint.safe_norm(to_t))
        dirs.append(to_t / dist[:, None])
        limits.append(dist)
    return off, dirs, np.stack(limits, -1)


class TestClosestHit:
    def test_matches_pallas_and_dense(self, backends, rays):
        o, d = rays
        kb, db, pb, jd = backends
        hit, tt, attrs = kb.closest_hit(t(o), t(d))
        for ref in (pb.closest_hit(o, d), jd.closest_hit(o, d),
                    db.closest_hit(t(o), t(d))):
            rhit, rt, rattrs = (np.asarray(x) if not isinstance(x, dict)
                                else x for x in ref)
            rhit, rt = np.asarray(rhit), np.asarray(rt)
            np.testing.assert_array_equal(hit.numpy(), rhit)
            np.testing.assert_allclose(np.where(rhit, tt.numpy(), 0.0),
                                       np.where(rhit, rt, 0.0),
                                       rtol=1e-5, atol=1e-5)
            for k in ("kind", "absorption", "echo"):
                np.testing.assert_allclose(
                    np.where(rhit, attrs[k].numpy(), 0),
                    np.where(rhit, np.asarray(rattrs[k]), 0),
                    rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(kb.closest_t(t(o), t(d)).numpy(),
                                   tt.numpy())

    def test_tie_break_keeps_lowest_rank(self):
        # Identical overlapping primitives across types: the sphere (the
        # lowest scan rank) wins, and of two equal AABBs the first.
        js = JScene.build(JSpheres.build([[0, 0, 5]], [1.0]),
                          JAabbs.build([[0, 0, 6], [0, 0, 6]],
                                       [[2, 2, 1], [2, 2, 1]]),
                          None, [[0, 9, 0]])
        o = np.zeros((8, 3), np.float32)
        d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (8, 1))
        kb = KernelBackend(carry(js))
        _, tt, a = kb.closest_hit(t(o), t(d))
        _, pt, pa = PallasBackend(js, interpret=True).closest_hit(o, d)
        np.testing.assert_allclose(tt.numpy(), np.asarray(pt), rtol=1e-6)
        np.testing.assert_array_equal(a["kind"].numpy(),
                                      np.asarray(pa["kind"]))
        # Boxes alone: equal t, the earlier AABB wins.
        js2 = JScene.build(None, JAabbs.build([[0, 0, 6], [0, 0, 6]],
                                              [[2, 2, 1], [2, 2, 1]]),
                           None, [[0, 9, 0]])
        tt2, rank = K.run_closest_hit(prepare_fields(carry(js2)), t(o), t(d))
        assert (rank == 0).all() and torch.allclose(tt2, torch.tensor(5.0))

    @pytest.mark.parametrize("kind", ["s", "a", "o"])
    def test_single_type_scenes(self, kind):
        js = j_random_scene(jax.random.key(5),
                            num_spheres=6 if kind == "s" else 0,
                            num_aabbs=6 if kind == "a" else 0,
                            num_obbs=6 if kind == "o" else 0,
                            num_targets=1, extent=10.0)
        o = np.zeros((16, 3), np.float32)
        d = np.asarray(fibonacci_directions(16))
        _, tt, _ = KernelBackend(carry(js)).closest_hit(t(o), t(d))
        _, pt, _ = PallasBackend(js, interpret=True).closest_hit(o, d)
        np.testing.assert_allclose(
            np.nan_to_num(tt.numpy(), posinf=-1),
            np.nan_to_num(np.asarray(pt), posinf=-1), rtol=1e-5)

    def test_dead_lanes_report_a_miss(self, backends, rays):
        o, d = rays
        kb = backends[0]
        alive = torch.arange(96) % 3 != 0
        t_all, r_all = K.run_closest_hit(kb.fields, t(o), t(d))
        t_live, r_live = K.run_closest_hit(kb.fields, t(o), t(d), alive)
        assert torch.isinf(t_live[~alive]).all()
        assert (r_live[~alive] == K.INT_MAX).all()
        assert torch.equal(t_live[alive], t_all[alive])
        assert torch.equal(r_live[alive], r_all[alive])
        assert (r_all[torch.isinf(t_all)] == K.INT_MAX).all()

    def test_inactive_primitives_never_hit(self, jscene):
        scene = carry(jscene)
        import dataclasses
        scene = scene.replace(aabbs=dataclasses.replace(
            scene.aabbs, active=torch.zeros(13, dtype=torch.bool)))
        o = torch.zeros((64, 3))
        d = torch.as_tensor(np.array(fibonacci_directions(64)))
        _, rank = K.run_closest_hit(prepare_fields(scene), o, d)
        ns = scene.spheres.count
        assert not ((rank >= ns) & (rank < ns + 13)).any()
        ref = DenseBackend(scene).closest_hit(o, d)
        got = KernelBackend(scene).closest_hit(o, d)
        assert torch.equal(ref[0], got[0])


class TestFusedOcclusion:
    @pytest.mark.parametrize("init_every", [0, 3])
    def test_matches_pallas_and_dense(self, jscene, backends, rays,
                                      init_every):
        o, d = rays
        kb, db, pb, jd = backends
        off, dirs, limits = bounce_sets(jscene.target_positions, o, d)
        R, S = limits.shape
        init = np.zeros((R, S), bool)
        if init_every:
            init[::init_every, 0] = True
        jskips = (J_NO_SKIP,) + tuple(range(S - 1))
        skips = (NO_SKIP,) + tuple(range(S - 1))
        occ = kb.multi_occluded(t(off), [t(x) for x in dirs], t(limits),
                                skips, t(init, torch.bool)).numpy()
        jdirs = [jnp.asarray(x) for x in dirs]
        for ref in (pb.multi_occluded(off, jdirs, limits, jskips, init),
                    jd.multi_occluded(off, jdirs, limits, jskips, init)):
            np.testing.assert_array_equal(occ, np.asarray(ref))
        np.testing.assert_array_equal(
            occ, db.multi_occluded(t(off), [t(x) for x in dirs], t(limits),
                                   skips, t(init, torch.bool)).numpy())
        assert occ[init].all()
        assert occ.any() and not occ.all()

    def test_fully_resolved_lanes_return_init(self, jscene, backends, rays):
        o, d = rays
        off, dirs, limits = bounce_sets(jscene.target_positions, o, d)
        R, S = limits.shape
        init = torch.ones((R, S), dtype=torch.bool)
        occ = F.run_multi_any_hit(backends[0].fields, t(off),
                                  [t(x) for x in dirs], t(limits),
                                  (NO_SKIP, 0, 1), init)
        assert occ.all()

    def test_skip_never_matches_unowned(self, jscene, backends, rays):
        # The echo set's NO_SKIP must not match a primitive's -1.
        o, d = rays
        off, dirs, limits = bounce_sets(jscene.target_positions, o, d)
        fields = backends[0].fields
        dirs0, lim0 = [t(dirs[0])], t(limits[:, :1])
        init = torch.zeros((96, 1), dtype=torch.bool)
        occ_none = F.run_multi_any_hit(fields, t(off), dirs0, lim0,
                                       (NO_SKIP,), init)
        occ_unowned = F.run_multi_any_hit(fields, t(off), dirs0, lim0,
                                          (-1,), init)
        ref = backends[3].occluded(off, dirs[0], limits[:, 0])
        np.testing.assert_array_equal(occ_none[:, 0].numpy(),
                                      np.asarray(ref))
        assert occ_unowned.sum() <= occ_none.sum()


class TestPaddedTables:
    """The tables B1 and B2 walk: each type's rows padded to whole tiles
    with rows that never hit; for B2 split by the launch's skip targets,
    with inactive rows left out."""

    @pytest.mark.parametrize("skips", [(NO_SKIP,), (NO_SKIP, 0, 1), (1,),
                                       (-1, 0)])
    def test_owned_rows_are_exactly_the_skips_rows(self, jscene, skips):
        scene = carry(jscene)
        fields = prepare_fields(scene)
        kinds = (scene.spheres, scene.aabbs, scene.obbs)
        cols = (K.S_TGT, K.A_TGT, K.O_TGT)
        for (tab, n_free, n_owned), kind, col in zip(
                K.occlusion_tables(fields, skips), kinds, cols):
            ids = K.ids(tab, col).tolist()
            free_pad = -n_free % K.TILE
            free = ids[:n_free]
            owned = ids[n_free + free_pad:n_free + free_pad + n_owned]
            want = kind.target_id[kind.active].tolist()
            assert sorted(free + owned) == sorted(want)
            assert all(i in skips for i in owned)
            assert not any(i in skips for i in free)
            # NO_SKIP never claims an unowned row (target id -1).
            if skips == (NO_SKIP,):
                assert n_owned == 0 and n_free == len(want)
            assert tab.shape[0] % K.TILE == 0
            assert tab.shape[0] == n_free + free_pad + n_owned \
                + (-n_owned % K.TILE)

    def test_padding_rows_never_hit(self, jscene):
        for width in (K.SPH_W, K.AABB_W, K.OBB_W):
            row = K.miss_row(width, "cpu")
            tab = K.pad_to_tiles(row[None])
            assert tab.shape == (K.TILE, width)
            assert not K.active_rows(tab).any()
        fields = prepare_fields(carry(jscene))
        assert not K.active_rows(K.pad_to_tiles(fields.aabb)[13:]).any()
        assert K.active_rows(fields.aabb).all()

    def test_closest_ranks_are_the_original_scan_indices(self, backends,
                                                         rays):
        # B1 walks the padded tables and reports type offset + row with
        # the real counts: the plain version on the padded tables, with
        # its ranks mapped that way, equals it on the original tables.
        o, d = rays
        fields = backends[0].fields
        padded = K.Fields(*K.closest_tables(fields))
        t_ref, r_ref = K.closest_hit_plain(fields, t(o), t(d))
        t_pad, r_pad = K.closest_hit_plain(padded, t(o), t(d))
        assert torch.equal(t_ref, t_pad)
        bounds = np.cumsum((0,) + padded.counts)
        base = np.cumsum((0,) + fields.counts)
        r = r_pad.numpy().astype(np.int64)
        kind = np.searchsorted(bounds, r, side="right") - 1
        hit = r != K.INT_MAX
        mapped = np.where(hit, base[np.minimum(kind, 2)]
                          + r - bounds[np.minimum(kind, 2)], K.INT_MAX)
        np.testing.assert_array_equal(mapped, r_ref.numpy())
        assert hit.any()

    @pytest.mark.parametrize("init_every", [0, 3])
    def test_plain_on_occlusion_tables_matches_pallas_and_dense(
            self, jscene, backends, rays, init_every):
        # B2's decisions on the split tables equal the JAX tiers exactly.
        o, d = rays
        kb, _, pb, jd = backends
        off, dirs, limits = bounce_sets(jscene.target_positions, o, d)
        R, S = limits.shape
        init = np.zeros((R, S), bool)
        if init_every:
            init[::init_every, 0] = True
        skips = (NO_SKIP,) + tuple(range(S - 1))
        jskips = (J_NO_SKIP,) + tuple(range(S - 1))
        split = K.Fields(*(x[0] for x in K.occlusion_tables(kb.fields,
                                                            skips)))
        occ = F.multi_any_hit_plain(split, t(off), [t(x) for x in dirs],
                                    t(limits), skips,
                                    t(init, torch.bool)).numpy()
        jdirs = [jnp.asarray(x) for x in dirs]
        for ref in (pb.multi_occluded(off, jdirs, limits, jskips, init),
                    jd.multi_occluded(off, jdirs, limits, jskips, init)):
            np.testing.assert_array_equal(occ, np.asarray(ref))
        assert occ.any() and not occ.all()

    def test_plain_on_occlusion_tables_without_inactive_rows(self, jscene,
                                                             rays):
        # Inactive AABBs leave B2's tables; the decisions stay those of
        # the original tables.
        import dataclasses
        scene = carry(jscene)
        act = torch.arange(13) % 3 != 0
        scene = scene.replace(aabbs=dataclasses.replace(scene.aabbs,
                                                        active=act))
        fields = prepare_fields(scene)
        o, d = rays
        off, dirs, limits = bounce_sets(jscene.target_positions, o, d)
        skips = (NO_SKIP,) + tuple(range(limits.shape[1] - 1))
        tabs = K.occlusion_tables(fields, skips)
        assert tabs[1][1] + tabs[1][2] == int(act.sum())
        init = torch.zeros(limits.shape, dtype=torch.bool)
        args = (t(off), [t(x) for x in dirs], t(limits), skips, init)
        np.testing.assert_array_equal(
            F.multi_any_hit_plain(K.Fields(*(x[0] for x in tabs)),
                                  *args).numpy(),
            F.multi_any_hit_plain(fields, *args).numpy())


class TestFusedChords:
    def test_matches_pallas_and_dense(self, jscene, backends, rays):
        o, d = rays
        kb, db, pb, jd = backends
        off, dirs, _ = bounce_sets(jscene.target_positions, o, d)
        dirs = dirs[1:]  # target sets only, as ops.permeation passes them
        skips = tuple(range(len(dirs)))
        loss = kb.multi_permeation_loss(t(off), [t(x) for x in dirs], skips)
        jdirs = [jnp.asarray(x) for x in dirs]
        for ref in (pb.multi_permeation_loss(off, jdirs, skips),
                    jd.multi_permeation_loss(off, jdirs, skips)):
            np.testing.assert_allclose(loss.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(
            loss.numpy(), db.multi_permeation_loss(
                t(off), [t(x) for x in dirs], skips).numpy(),
            rtol=1e-5, atol=1e-4)
        assert (loss > 0).any()

    def test_skipped_target_colliders_add_nothing(self, jscene, backends):
        # A ray through target 0's owning sphere: its chord counts only
        # for the sets that do not skip target 0.
        tp = np.asarray(jscene.target_positions)
        o = (tp[0] - np.array([0.0, 0.0, 3.0], np.float32))[None]
        d = np.array([[0.0, 0.0, 1.0]], np.float32)
        fields = backends[0].fields
        both = F.run_multi_chord(fields, t(o), [t(d), t(d)], (0, 1))
        assert both[0, 1] > both[0, 0]


class TestWrappers:
    def test_odd_ray_counts_and_empty_types(self):
        # Ray counts that fill no whole block, and scenes with empty types.
        js = j_random_scene(jax.random.key(8), num_spheres=0, num_aabbs=5,
                            num_obbs=0, num_targets=2, extent=8.0)
        for R in (1, 7, 300):
            kb = KernelBackend(carry(js))
            d = np.asarray(fibonacci_directions(max(R, 2)))[:R]
            o = np.zeros((R, 3), np.float32)
            hit, tt, _ = kb.closest_hit(t(o), t(d))
            rhit, rt, _ = DenseBackend(kb.scene).closest_hit(t(o), t(d))
            assert torch.equal(hit, rhit)
            np.testing.assert_allclose(tt[hit].numpy(), rt[hit].numpy(),
                                       rtol=1e-5)
            occ = kb.multi_occluded(t(o), [t(d)], torch.full((R, 1), 5.0),
                                    (NO_SKIP,),
                                    torch.zeros((R, 1), dtype=torch.bool))
            assert occ.shape == (R, 1)

    def test_empty_scene(self):
        kb = KernelBackend(carry(j_random_scene(jax.random.key(1), 0, 0, 0,
                                                num_targets=1)))
        o = torch.zeros((4, 3))
        hit, tt, attrs = kb.closest_hit(o, o + 1.0)
        assert not hit.any() and torch.isinf(tt).all()
        init = torch.tensor([[True], [False], [True], [False]])
        assert torch.equal(kb.multi_occluded(o, [o], torch.ones((4, 1)),
                                             (NO_SKIP,), init), init)
        assert kb.multi_permeation_loss(o, [o, o], (0, 1)).shape == (4, 2)

    def test_field_tables(self, jscene):
        scene = carry(jscene)
        f = prepare_fields(scene)
        assert f.sph.shape == (scene.spheres.count, K.SPH_W)
        assert f.aabb.shape == (13, K.AABB_W) and f.obb.shape == (11, K.OBB_W)
        np.testing.assert_array_equal(
            K.ids(f.sph, K.S_TGT).numpy(), scene.spheres.target_id.numpy())
        m = f.obb[:, K.O_M:K.O_M + 9].reshape(-1, 3, 3)
        from audio_raytracer_tpu.ops import quaternion as jquat
        np.testing.assert_allclose(
            m.numpy(), np.asarray(jquat.to_matrix(jscene.obbs.inv_rot)),
            rtol=1e-6, atol=1e-7)

    def test_non_cpu_tensors_never_take_the_plain_version(self, backends,
                                                          monkeypatch):
        # A tensor off the CPU goes to the kernel; when the library cannot
        # be built the wrapper raises instead of computing anything else.
        def no_library(name):
            raise RuntimeError(f"cannot build {name}")

        monkeypatch.setattr(build, "load", no_library)
        fields = backends[0].fields
        o = torch.zeros((4, 3), device="meta")
        lim = torch.ones((4, 1), device="meta")
        init = torch.zeros((4, 1), dtype=torch.bool, device="meta")
        before = (K.run_closest_hit.launches, F.run_multi_any_hit.launches,
                  F.run_multi_chord.launches)
        with pytest.raises(RuntimeError, match="closest_hit"):
            K.run_closest_hit(fields, o, o)
        with pytest.raises(RuntimeError, match="multi_any_hit"):
            F.run_multi_any_hit(fields, o, [o], lim, (NO_SKIP,), init)
        with pytest.raises(RuntimeError, match="multi_chord"):
            F.run_multi_chord(fields, o, [o], (0,))
        assert before == (K.run_closest_hit.launches,
                          F.run_multi_any_hit.launches,
                          F.run_multi_chord.launches)

    @pytest.mark.parametrize("S,sizes", [(1, [1]), (16, [16]), (17, [16, 1]),
                                         (40, [16, 16, 8])])
    def test_set_groups(self, S, sizes):
        groups = F.set_groups(S)
        assert [g.stop - g.start for g in groups] == sizes
        assert groups[0].start == 0 and groups[-1].stop == S
        assert all(a.stop == b.start for a, b in zip(groups, groups[1:]))

    def test_many_sets_take_one_launch_per_group(self, backends,
                                                 monkeypatch):
        # More sets than one launch takes: the wrappers launch once per
        # group, each with its own slice of the skips, and join the
        # outputs. A stand-in library records the launches.
        calls = []

        def read_skips(ptr, n):
            return tuple(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))[:n])

        class Lib:
            def multi_any_hit(self, o, dirs, lim, init, R, S, skips, *rest):
                calls.append(("B2", R, S, read_skips(skips, S)))
                return 0

            def multi_chord(self, o, dirs, R, S, skips, *rest):
                calls.append(("B3", R, S, read_skips(skips, S)))
                return 0

        monkeypatch.setattr(build, "load", lambda name: Lib())
        monkeypatch.setattr(F, "table_args", lambda fields, dev: [0] * 6)
        monkeypatch.setattr(F, "occlusion_args",
                            lambda fields, skips, dev: [0] * 9)
        monkeypatch.setattr(F, "stream_of", lambda dev: 0)
        fields = backends[0].fields
        R, S = 5, 20
        o = torch.zeros((R, 3), device="meta")
        lim = torch.ones((R, S), device="meta")
        init = torch.zeros((R, S), dtype=torch.bool, device="meta")
        skips = (NO_SKIP,) + tuple(range(S - 1))
        before = (F.run_multi_any_hit.launches, F.run_multi_chord.launches)
        occ = F.run_multi_any_hit(fields, o, [o] * S, lim, skips, init)
        loss = F.run_multi_chord(fields, o, [o] * (S - 1), skips[1:])
        assert occ.shape == (R, S) and loss.shape == (R, S - 1)
        assert (F.run_multi_any_hit.launches - before[0],
                F.run_multi_chord.launches - before[1]) == (2, 2)
        assert calls == [("B2", R, 16, skips[:16]), ("B2", R, 4, skips[16:]),
                         ("B3", R, 16, skips[1:17]), ("B3", R, 3, skips[17:])]

    def test_plain_versions_do_not_count_launches(self, backends, rays):
        o, d = rays
        before = K.run_closest_hit.launches
        backends[0].closest_hit(t(o), t(d))
        assert K.run_closest_hit.launches == before

    def test_build_command(self, monkeypatch, tmp_path):
        cmd = build.nvcc_command("nvcc", "closest_hit", "out.so")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-O3" in cmd and "--fmad=false" in cmd
        assert "--use_fast_math" not in cmd
        assert cmd[-1].endswith("csrc/closest_hit.cu")
        for n in build.SOURCES:
            assert build.lib_path(n).startswith(build.BUILD_DIR)
        # Without nvcc the build raises (no silent fallback).
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            build.find_nvcc()


class TestAdjointWrappers:
    def test_non_cpu_tensors_never_take_the_plain_version(self, backends,
                                                          monkeypatch):
        # B4 and B5 on a tensor off the CPU: the kernel or an error.
        def no_library(name):
            raise RuntimeError(f"cannot build {name}")

        monkeypatch.setattr(build, "load", no_library)
        fields = backends[0].fields
        o = torch.zeros((4, 3), device="meta")
        g = torch.ones((4, 1), device="meta")
        before = (F.run_multi_chord_dens_bwd.launches,
                  F.run_multi_chord_bwd.launches)
        with pytest.raises(RuntimeError, match="multi_chord_dens_bwd"):
            F.run_multi_chord_dens_bwd(fields, o, [o], (0,), g)
        with pytest.raises(RuntimeError, match="multi_chord_bwd"):
            F.run_multi_chord_bwd(fields, o, [o], (0,), g)
        assert before == (F.run_multi_chord_dens_bwd.launches,
                          F.run_multi_chord_bwd.launches)

    def test_one_launch_per_group_of_sets(self, backends, monkeypatch):
        # 19 sets: two groups. B4 launches once per group into the same
        # density outputs; B5 launches its ray kernel and B4's kernel per
        # group and counts both.
        calls = []

        def read_skips(ptr, n):
            return tuple(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))[:n])

        class Lib:
            def multi_chord_dens_bwd(self, rec_d, rec_inv, R, S, skips,
                                     *rest):
                calls.append(("B4", R, S, read_skips(skips, S)))
                return 0

            def multi_chord_bwd(self, o, dirs, g, R, S, skips, *rest):
                calls.append(("B5", R, S, read_skips(skips, S)))
                return 0

        monkeypatch.setattr(build, "load", lambda name: Lib())
        monkeypatch.setattr(F, "table_args", lambda fields, dev: [0] * 6)
        monkeypatch.setattr(F, "stream_of", lambda dev: 0)
        fields = backends[0].fields
        R, S = 5, 19
        o = torch.zeros((R, 3), device="meta")
        g = torch.ones((R, S), device="meta")
        skips = tuple(range(S))
        before = (F.run_multi_chord_dens_bwd.launches,
                  F.run_multi_chord_bwd.launches)
        dens = F.run_multi_chord_dens_bwd(fields, o, [o] * S, skips, g)
        d_o, d_dirs, dens5 = F.run_multi_chord_bwd(fields, o, [o] * S,
                                                   skips, g)
        counts = [(n,) for n in fields.counts]
        assert [tuple(x.shape) for x in dens] == counts
        assert [tuple(x.shape) for x in dens5] == counts
        assert d_o.shape == (R, 3) and len(d_dirs) == S
        assert all(x.shape == (R, 3) for x in d_dirs)
        assert (F.run_multi_chord_dens_bwd.launches - before[0],
                F.run_multi_chord_bwd.launches - before[1]) == (2, 4)
        lo, hi = skips[:16], skips[16:]
        # B4 takes its ray records padded to whole tiles.
        Rp = F.RAY_TILE_PAD
        assert calls == [("B4", Rp, 16, lo), ("B4", Rp, 3, hi),
                         ("B5", R, 16, lo), ("B4", Rp, 16, lo),
                         ("B5", R, 3, hi), ("B4", Rp, 3, hi)]

    def test_plain_versions_do_not_count_launches(self, backends, rays):
        o, d = rays
        before = (F.run_multi_chord_dens_bwd.launches,
                  F.run_multi_chord_bwd.launches)
        g = torch.ones((96, 1))
        F.run_multi_chord_dens_bwd(backends[0].fields, t(o), [t(d)], (0,), g)
        F.run_multi_chord_bwd(backends[0].fields, t(o), [t(d)], (0,), g)
        assert before == (F.run_multi_chord_dens_bwd.launches,
                          F.run_multi_chord_bwd.launches)


def dens_inputs(jscene, R=96, S=3, seed=8):
    """Bounce-like origins, S unit direction sets (toward targets 0 and 1,
    then a free one, a few with zero components) and a cotangent [R, S]
    that is zero on every set of a third of the rays (missing rays in the
    training step) and on single sets of a few others."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12.0, 12.0, (R, 3)).astype(np.float32)
    dirs = []
    for s in range(S):
        v = (np.asarray(jscene.target_positions[s]) - o if s < 2
             else rng.normal(size=(R, 3)).astype(np.float32))
        v[s::13, s % 3] = 0.0
        dirs.append((v / np.linalg.norm(v, axis=1, keepdims=True))
                    .astype(np.float32))
    g = rng.normal(size=(R, S)).astype(np.float32)
    g[::3] = 0.0
    g[1::10, 1] = 0.0
    return o, dirs, g, (0, 1, J_NO_SKIP)[:S], (0, 1, NO_SKIP)[:S]


class TestDensRecords:
    def test_records_unpack_bit_for_bit(self, jscene):
        # B4's ray records: a head (o, live), then per set (d, g) in the
        # first and (safe_inv(d), g) in the second; padding records zero.
        o, dirs, g, _, _ = dens_inputs(jscene, R=300)
        dirs[2][::7] = 1e-13  # nudged on every axis
        R, S = o.shape[0], len(dirs)
        stacked = torch.stack([t(x) for x in dirs])
        rec_d, rec_inv = F.dens_records(t(o), stacked, t(g))
        Rp = -(-R // F.RAY_TILE_PAD) * F.RAY_TILE_PAD
        assert rec_d.shape == rec_inv.shape == (Rp, 1 + S, 4)
        assert Rp % F.RAY_TILE_PAD == 0 and Rp >= R

        def bits(x):
            return x.contiguous().view(torch.int32)

        live = (t(g) != 0).any(dim=1)
        assert 0 < int(live.sum()) < R
        for rec, x in ((rec_d, stacked), (rec_inv, K.safe_inv(stacked))):
            assert torch.equal(bits(rec[:R, 0, :3]), bits(t(o)))
            assert torch.equal(rec[:R, 0, 3], live.float())
            assert torch.equal(bits(rec[:R, 1:, :3]),
                               bits(x.transpose(0, 1)))
            assert torch.equal(bits(rec[:R, 1:, 3]), bits(t(g)))
            assert not rec[R:].any()  # not live, g = 0
        assert torch.isfinite(rec_inv).all()

    def test_dens_bwd_plain_on_rays_with_a_cotangent(self, jscene, backends):
        # B4 skips the rays whose cotangents are all zero: the plain
        # version on the rest equals it on every ray (the per-primitive
        # sums drop only +0 terms and run in another order: 1e-6 of the
        # sum of |g x chord|), and both equal the JAX tiers' density
        # gradient (the Pallas kernel in interpret mode, and autodiff
        # through the jnp permeation chords) at tests/test_torch_train.py's
        # tolerances.
        import dataclasses

        from audio_raytracer_tpu.ops.pallas import fused as JF

        fields = backends[0].fields
        pb = backends[2]
        o, dirs, g, jskips, skips = dens_inputs(jscene)
        live = (g != 0).any(axis=1)
        every = F.multi_chord_dens_bwd_plain(fields, t(o),
                                             [t(x) for x in dirs], skips,
                                             t(g))
        some = F.multi_chord_dens_bwd_plain(fields, t(o[live]),
                                            [t(x[live]) for x in dirs],
                                            skips, t(g[live]))
        scale = F.multi_chord_dens_bwd_plain(fields, t(o),
                                             [t(x) for x in dirs], skips,
                                             t(np.abs(g)))
        jp = JF.run_multi_chord_dens_bwd(
            pb._chord_fields, pb.counts, jnp.asarray(o),
            [jnp.asarray(x) for x in dirs], jskips, jnp.asarray(g),
            interpret=True)

        def loss(ds, da, do):
            sc = jscene
            for name, dens in (("spheres", ds), ("aabbs", da),
                               ("obbs", do)):
                prims = getattr(sc, name)
                sc = sc.replace(**{name: dataclasses.replace(
                    prims, material=dataclasses.replace(prims.material,
                                                        density=dens))})
            return sum(jnp.sum(jnp.asarray(g[:, s]) * jint.permeation_loss(
                jnp.asarray(o), jnp.asarray(dirs[s]), sc, jskips[s]))
                for s in range(len(dirs)))

        jd = jax.grad(loss, argnums=(0, 1, 2))(
            *(x.material.density for x in (jscene.spheres, jscene.aabbs,
                                           jscene.obbs)))
        for i, k in enumerate(("s_dens", "a_dens", "o_dens")):
            a, m = every[i], scale[i]
            assert (a != 0).any(), k
            np.testing.assert_allclose(some[i].numpy(), a.numpy(), rtol=0,
                                       atol=1e-6 * float(m.max()),
                                       err_msg=k)
            for ref in (jp[k], jd[i]):
                np.testing.assert_allclose(a.numpy(), np.asarray(ref),
                                           rtol=2e-4,
                                           atol=2e-5 * float(m.max()),
                                           err_msg=k)
