"""The single-set backend protocol (B6 ``occluded``, B7 ``permeation_loss``,
B8 its adjoint) and the roofline calibration chain (B9) against the JAX
package.

On the CPU the port's wrappers run their kernels' plain versions; the JAX
side runs ``PallasBackend(interpret=True)``, as its own tests do, and its
jnp tier (``DenseBackend``). Tolerances are those of tests/test_pallas.py
for values and of tests/test_torch_train.py (rtol 2e-4, atol 2e-6) for
gradients, unless a test states another with its reason. The CUDA
kernels run only on the card, where chip_smoke.py holds each against its
plain version.
"""

import ctypes
import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops.backend import DenseBackend as JDense
from audio_raytracer_tpu.ops.pallas import PallasBackend
from audio_raytracer_tpu.types import Aabbs as JAabbs
from audio_raytracer_tpu.types import Scene as JScene
from audio_raytracer_tpu.types import Spheres as JSpheres
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP, DenseBackend
from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.ops.cuda import calibrate as C
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import (
    KernelBackend,
    prepare_fields,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD = dict(rtol=2e-4, atol=2e-6)
R = 96


def carry(jscene):
    return scene_from_arrays(jax.tree.map(np.asarray, jscene), device="cpu")


def t(x, grad=False):
    return torch.tensor(np.array(x), dtype=torch.float32, requires_grad=grad)


@pytest.fixture(scope="module")
def jscene():
    # The fixture scene of tests/test_pallas.py.
    return j_random_scene(jax.random.key(21), num_spheres=9, num_aabbs=13,
                          num_obbs=11, num_targets=2, extent=15.0,
                          size_range=(1.0, 4.0), target_owned_colliders=True)


@pytest.fixture(scope="module")
def backends(jscene):
    return (KernelBackend(carry(jscene)), PallasBackend(jscene,
                                                         interpret=True),
            JDense(jscene))


@pytest.fixture(scope="module")
def rays():
    """Bounce-like origins in the scene and directions of any length
    (0.2 to 3), a few with zero components; unit directions; limits."""
    rng = np.random.default_rng(11)
    o = rng.uniform(-12.0, 12.0, (R, 3)).astype(np.float32)
    v = rng.normal(size=(R, 3)).astype(np.float32)
    v[1::7, 0] = 0.0
    v[2::11, 1:] = 0.0
    v[~v.any(axis=1), 0] = 1.0
    unit = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    d = (unit * rng.uniform(0.2, 3.0, (R, 1))).astype(np.float32)
    limit = rng.uniform(0.5, 30.0, (R,)).astype(np.float32)
    return o, d, unit, limit


# ---------------------------------------------------------------------------
# B6: occluded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip", [None, 0, 1])
def test_occluded_matches_pallas_and_dense(backends, rays, skip):
    kb, pb, jd = backends
    o, d, _, limit = rays
    occ = kb.occluded(t(o), t(d), t(limit), skip_target_id=skip).numpy()
    for ref in (pb.occluded(o, d, limit, skip_target_id=skip),
                jd.occluded(o, d, limit, skip_target_id=skip)):
        np.testing.assert_array_equal(occ, np.asarray(ref))
    np.testing.assert_array_equal(
        occ, DenseBackend(kb.scene).occluded(t(o), t(d), t(limit),
                                             skip).numpy())
    assert occ.any() and not occ.all()


def test_occluded_unbounded_follows_the_jnp_tier(backends, rays):
    # limit = +inf: a ray is occluded only by a real hit. The JAX Pallas
    # kernel encodes a miss as BIG = 3e38 < inf and calls every ray
    # occluded (ROADMAP Queue 3); the port follows the jnp tier.
    kb, pb, jd = backends
    o, d, _, _ = rays
    inf = np.full((R,), np.inf, np.float32)
    occ = kb.occluded(t(o), t(d), t(inf)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jd.occluded(o, d, inf)))
    assert not occ.all()
    assert np.asarray(pb.occluded(o, d, inf)).all()


@pytest.mark.parametrize("skip", [NO_SKIP, 0, 1])
@pytest.mark.parametrize("rows", ["free", "padded", "rotated"])
def test_free_rows_occlude_as_the_skip_target(backends, rays, skip, rows):
    # B6 walks only the free rows of occlusion_tables(fields, (skip,))
    # (active, owned by no skip target) with no skip compare, padded to
    # whole tiles, and each lane meets them in a rotation of the scan order
    # that depends on where its ray joined the cyclic stream. Occlusion is
    # an OR over the primitives, so none of that changes a flag: each
    # equals any_hit_plain with the skip on the full tables, and the JAX
    # jnp tier's.
    kb, _, jd = backends
    o, d, _, limit = rays
    args = (t(o), t(d), t(limit))
    tabs = []
    for i, (tab, n_free, _) in enumerate(K.occlusion_tables(kb.fields,
                                                            (skip,))):
        if rows == "padded":
            n_free = -(-n_free // K.TILE) * K.TILE
        tab = tab[:n_free]
        if rows == "rotated":
            tab = torch.roll(tab, 3 * i + 2, dims=0)
        tabs.append(tab)
    got = K.any_hit_plain(K.Fields(*tabs), *args, NO_SKIP)
    assert torch.equal(got, K.any_hit_plain(kb.fields, *args, skip))
    jskip = None if skip == NO_SKIP else skip
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jd.occluded(o, d, limit,
                                            skip_target_id=jskip)))
    assert got.any() and not got.all()


def test_occluded_broadcast_limit_and_inactive_primitives(jscene, rays):
    o, d, _, _ = rays
    scene = carry(jscene)
    off = torch.zeros(scene.aabbs.count, dtype=torch.bool)
    off[::2] = True
    scene = scene.replace(aabbs=dataclasses.replace(scene.aabbs,
                                                    active=~off))
    occ = KernelBackend(scene).occluded(t(o), t(d), 10.0)
    ref = DenseBackend(scene).occluded(t(o), t(d), torch.full((R,), 10.0))
    assert torch.equal(occ, ref)
    # An inactive primitive never occludes.
    fields = prepare_fields(scene)
    grid = K.any_hit_grid(fields, t(o), t(d), torch.full((R,), 1e30), NO_SKIP)
    ns = scene.spheres.count
    assert not grid[:, ns:ns + scene.aabbs.count][:, off].any()


# ---------------------------------------------------------------------------
# B7: permeation_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skip", [None, 0, 1])
def test_permeation_loss_matches_pallas_and_dense(backends, rays, skip):
    kb, pb, jd = backends
    o, _, u, _ = rays
    loss = kb.permeation_loss(t(o), t(u), skip).numpy()
    jskip = skip if skip is not None else NO_SKIP
    np.testing.assert_allclose(loss, np.asarray(jd.permeation_loss(o, u,
                                                                   skip)),
                               rtol=1e-5, atol=1e-4)
    # The Pallas tier's approximate reciprocal (kernels.py::_fast_recip)
    # moves its own chords by up to ~3e-5 relative on these rays: held at
    # the echo tolerance of tests/test_forward_parity.py.
    np.testing.assert_allclose(loss, np.asarray(pb.permeation_loss(
        o, u, jskip)), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        loss, DenseBackend(kb.scene).permeation_loss(t(o), t(u),
                                                     skip).numpy(),
        rtol=1e-5, atol=1e-4)
    assert (loss > 0).any()


def test_chord_loss_is_b3_at_one_set(backends, rays):
    # B7's plain version restates B3's at S = 1 with per-ray origins.
    kb = backends[0]
    o, _, u, _ = rays
    for skip in (NO_SKIP, 0):
        np.testing.assert_allclose(
            K.chord_loss_plain(kb.fields, t(o), t(u), skip).numpy(),
            F.multi_chord_plain(kb.fields, t(o), [t(u)], (skip,))[:, 0]
            .numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# B8: the adjoint of permeation_loss
# ---------------------------------------------------------------------------


def with_densities(scene, dens, replace):
    """``scene`` with its three per-type density arrays replaced."""
    kinds = ("spheres", "aabbs", "obbs")
    return scene.replace(**{
        k: replace(getattr(scene, k), material=replace(
            getattr(scene, k).material, density=x))
        for k, x in zip(kinds, dens)})


def jax_chord_grads(jscene, o, d, g, skip):
    """jax.grad of sum(g x permeation_loss) with respect to o, d and the
    densities, through PallasBackend(differentiable=True,
    interpret=True): the chord_loss custom_vjp, whose backward is the
    JAX B8 kernel."""
    jskip = skip if skip is not None else NO_SKIP

    def f(o, d, *dens):
        sc = with_densities(jscene, dens, dataclasses.replace)
        be = PallasBackend(sc, interpret=True, differentiable=True)
        return jnp.sum(be.permeation_loss(o, d, jskip) * g)

    dens = [jscene.spheres.material.density, jscene.aabbs.material.density,
            jscene.obbs.material.density]
    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(jnp.asarray(o),
                                                jnp.asarray(d), *dens)


def port_chord_grads(scene, o, d, g, skip):
    """The same gradients through KernelBackend(differentiable=True):
    ChordLoss, B7 forward and B8 backward."""
    dens = [t(x.material.density, grad=True)
            for x in (scene.spheres, scene.aabbs, scene.obbs)]
    sc = with_densities(scene, dens, dataclasses.replace)
    ins = [t(o, grad=True), t(d, grad=True)]
    loss = KernelBackend(sc, differentiable=True).permeation_loss(*ins, skip)
    return torch.autograd.grad((loss * t(g)).sum(), ins + dens)


@pytest.mark.parametrize("skip", [None, 1])
def test_chord_loss_grads_match_jax(jscene, rays, skip):
    o, _, u, _ = rays
    g = np.random.default_rng(12).normal(size=(R,)).astype(np.float32)
    ref = jax_chord_grads(jscene, o, u, g, skip)
    got = port_chord_grads(carry(jscene), o, u, g, skip)
    for a, b in zip(got, ref):
        assert a.abs().sum() > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def tie_scene(spheres, aabbs):
    return JScene.build(spheres, aabbs, None, [[0.0, 9.0, 0.0]])


def test_chord_loss_grads_split_ties_as_jax():
    # Constructed ties: a ray along (1, 1, 1) through a cube centred on
    # the diagonal meets equal slab bounds on all three axes (t_near and
    # t_far tie three ways); a ray along z starting on a box face has
    # t_near = 0 (a tie in max(t_near, 0)); a ray along z starting on a
    # sphere's surface has t_enter = 0 (a tie in max(t_enter, 0)). jax.vjp
    # splits every tie evenly; so must the port, where B5's hand-closed
    # rule (one-hot) gives another gradient.
    js = tie_scene(JSpheres.build([[0.0, 0.0, -6.0]], [1.0]),
                   JAabbs.build([[5.0, 5.0, 5.0], [20.0, 0.0, 8.0]],
                                [[1.0, 1.0, 1.0], [2.0, 2.0, 1.0]]))
    s3 = np.float32(3.0 ** -0.5)
    o = np.array([[0.0, 0.0, 0.0], [20.0, 0.0, 7.0], [0.0, 0.0, -7.0]],
                 np.float32)
    d = np.array([[s3, s3, s3], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]],
                 np.float32)
    g = np.array([1.0, -0.5, 2.0], np.float32)
    ref = jax_chord_grads(js, o, d, g, None)
    got = port_chord_grads(carry(js), o, d, g, None)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)
    # The one-hot rule disagrees on these rays: the ties matter.
    fields = prepare_fields(carry(js))
    d_o, d_d, _ = F.multi_chord_bwd_plain(fields, t(o), [t(d)], (NO_SKIP,),
                                          t(g)[:, None])
    assert not np.allclose(d_o.numpy(), np.asarray(ref[0]), **GRAD)
    assert not np.allclose(d_d[0].numpy(), np.asarray(ref[1]), **GRAD)


def test_tangent_sphere_lanes_get_a_zero_gradient():
    # disc = 0 exactly (a ray grazing a sphere): the JAX adjoint divides
    # by sqrt(0); the port gives the limit, 0, as B5 does.
    js = tie_scene(JSpheres.build([[0.0, 1.0, 5.0]], [1.0]), None)
    o = np.zeros((1, 3), np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    grads = port_chord_grads(carry(js), o, d, np.ones((1,), np.float32),
                             None)
    for x in grads:
        assert torch.isfinite(x).all()
    assert not np.isfinite(np.asarray(jax_chord_grads(
        js, o, d, np.ones((1,), np.float32), None)[0])).all()


# ---------------------------------------------------------------------------
# The wrappers: no fallback, launch counts, empty scenes
# ---------------------------------------------------------------------------


WRAPPERS = (K.run_any_hit, K.run_chord_loss, K.run_chord_loss_bwd,
            C.run_calibrate)


def launches():
    return [w.launches for w in WRAPPERS]


def test_non_cpu_tensors_never_take_the_plain_version(backends,
                                                      monkeypatch):
    def no_library(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(build, "load", no_library)
    fields = backends[0].fields
    o = torch.zeros((4, 3), device="meta")
    g = torch.ones((4,), device="meta")
    before = launches()
    with pytest.raises(RuntimeError, match="any_hit"):
        K.run_any_hit(fields, o, o, g, NO_SKIP)
    with pytest.raises(RuntimeError, match="multi_chord"):
        K.run_chord_loss(fields, o, o, 0)
    with pytest.raises(RuntimeError, match="multi_chord_bwd"):
        K.run_chord_loss_bwd(fields, o, o, 0, g)
    with pytest.raises(RuntimeError, match="calibrate"):
        C.run_calibrate("fma4", 88, g, [g] * 6)
    assert launches() == before


def test_kernel_launches_and_arguments(backends, monkeypatch):
    # A stand-in library records what each wrapper passes to the C entry
    # points; B7 runs B3's kernel at one set, B8 its ray kernel and B4's.
    calls = []

    def ptr_ints(ptr, n):
        return tuple(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))[:n])

    class Lib:
        def any_hit(self, o, d, lim, R, *tables):
            calls.append(("B6", R, tables[0]))
            return 0

        def multi_chord(self, o, d, R, S, skips, *rest):
            calls.append(("B3", R, S, ptr_ints(skips, S)))
            return 0

        def chord_loss_bwd(self, o, d, g, R, skip, *rest):
            calls.append(("B8", R, skip))
            return 0

        def multi_chord_dens_bwd(self, rec_d, rec_inv, R, S, skips, *rest):
            calls.append(("B4", R, S, ptr_ints(skips, S)))
            return 0

        def calibrate(self, x, n, fields, prims, mix, ops, out, stream):
            calls.append(("B9", n, prims, mix, ops))
            return 0

    monkeypatch.setattr(build, "load", lambda name: Lib())
    monkeypatch.setattr(K, "table_args", lambda fields, dev: [0] * 6)
    # B6 walks the free rows of the skip target's tables: the stand-in
    # sees the skip as the first table argument.
    monkeypatch.setattr(K, "any_hit_args",
                        lambda fields, skip, dev: [skip] + [0] * 5)
    monkeypatch.setattr(F, "table_args", lambda fields, dev: [0] * 6)
    for mod in (K, F, C):
        monkeypatch.setattr(mod, "stream_of", lambda dev: 0)
    fields = backends[0].fields
    o = torch.zeros((5, 3), device="meta")
    g = torch.ones((5,), device="meta")
    before = launches()
    assert K.run_any_hit(fields, o, o, 3.0, 1).shape == (5,)
    assert K.run_chord_loss(fields, o, o, NO_SKIP).shape == (5,)
    d_o, d_d, dens = K.run_chord_loss_bwd(fields, o, o, 0, g)
    assert d_o.shape == d_d.shape == (5, 3)
    assert [tuple(x.shape) for x in dens] == [(n,) for n in fields.counts]
    x = torch.ones((16, 512), device="meta")
    assert C.run_calibrate("occl", 176, x, [g] * 6).shape == (16, 512)
    assert [a - b for a, b in zip(launches(), before)] == [1, 1, 2, 1]
    # B4 takes its ray records padded to whole tiles.
    assert calls == [("B6", 5, 1), ("B3", 5, 1, (NO_SKIP,)), ("B8", 5, 0),
                     ("B4", F.RAY_TILE_PAD, 1, (0,)),
                     ("B9", 16 * 512, 5, 1, 176)]


def test_plain_versions_count_no_launches_and_empty_scenes(backends,
                                                           rays):
    kb = backends[0]
    o, d, u, limit = rays
    before = launches()
    kb.occluded(t(o), t(d), t(limit))
    kb.permeation_loss(t(o), t(u))
    K.run_chord_loss_bwd(kb.fields, t(o), t(u), 0, torch.ones(R))
    assert launches() == before
    empty = KernelBackend(carry(j_random_scene(jax.random.key(1), 0, 0, 0,
                                               num_targets=1)),
                          differentiable=True)
    z = torch.zeros((4, 3))
    assert not empty.occluded(z, z + 1.0, 5.0).any()
    assert torch.equal(empty.permeation_loss(z, z + 1.0, 0), torch.zeros(4))


# ---------------------------------------------------------------------------
# B9: the calibration chain
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_roofline():
    """tools/roofline.py (the JAX tool), loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(REPO, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mix", C.MIXES)
def test_calibrate_plain_matches_jax(jax_roofline, monkeypatch, mix):
    # The JAX calibration kernel in the Pallas interpreter, its median
    # time replaced by the drained sum of its output.
    mod = jax_roofline
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call,
                                          interpret=True))
    monkeypatch.setattr(mod, "_med",
                        lambda fn, arg, iters=5: float(fn(arg)))
    prims = 16
    total, ops = mod.calibrate(mix, 88, blocks=1, prims=prims)
    fields = [torch.as_tensor(np.asarray(
        jnp.linspace(0.9, 1.1, prims).astype(jnp.float32) + 1e-3 * i))
        for i in range(6)]
    x = torch.full((8, 512), 0.5)
    out = C.run_calibrate(mix, 88, x, fields)
    assert ops == C.counted_ops(mix, 88, x.numel(), prims)
    np.testing.assert_allclose(float(out.double().sum()), total, rtol=1e-5)
    assert torch.isfinite(out).all()


# cuobjdump listings. B9's: the innermost backward branch that holds
# float32 instructions bounds the loop body (the staging loop before it
# holds none); predicated and labelled forms both parse.
SASS_B9 = """
        Function : _Z16calibrate_kernelILi1ELi88EEvPKfiS1_i9CalConstsPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0008*/                   LDG.E.128 R4, desc[UR8][R4.64] ;
        /*000c*/                   STS.128 [R16], R4 ;
        /*000e*/              @!P1 BRA 0x8 ;
        /*0010*/                   FMUL R2, R3, R4 ;
        .L_x_1:
        /*0020*/                   LDS.128 R8, [R5] ;
        /*0030*/                   FMUL R2, R2, R8 ;
        /*0040*/                   FADD R2, R2, 1.0000000116860974231e-07 ;
        /*0050*/                   FSETP.GT.AND P0, PT, R3, R4, PT ;
        /*0060*/                   FSEL R2, R2, R6, P0 ;
        /*0070*/                   SEL R6, R6, R2, P0 ;
        /*0080*/                   FMNMX R3, R3, R2, PT ;
        /*0090*/                   IADD3 R5, R5, 0x20, RZ ;
        /*00a0*/               @P1 BRA `(.L_x_1) ;
        /*00b0*/                   FADD R9, R2, R3 ;
        /*00c0*/                   BRA 0xc0 ;
"""

# B1's and B2's: a barrier wait loop (no float32), then per type a row
# loop whose forward branch (the sphere hit) stays inside it; B2 at S = 4
# and S = 5, of which a pattern picks one.
SASS_B1_B2 = """
        Function : _Z18closest_hit_kernelPKfS0_PKhi6StreamiiPfPi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        .L_x_3:
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R2 ;
        /*0020*/              @!P0 BRA `(.L_x_3) ;
        .L_x_4:
        /*0030*/                   LDS.128 R4, [R0] ;
        /*0040*/                   FADD R8, -R4, R20 ;
        /*0050*/                   FMUL R9, R8, R8 ;
        /*0060*/                   FSETP.GE.AND P1, PT, R9, RZ, PT ;
        /*0070*/                   BSSY B0, 0xa0 ;
        /*0080*/              @!P1 BRA 0x90 ;
        /*0090*/                   MUFU.RSQ R10, R9 ;
        /*00a0*/                   BSYNC B0 ;
        /*00b0*/                   IADD3 R0, R0, 0x20, RZ ;
        /*00c0*/                   ISETP.NE.AND P2, PT, R0, R3, PT ;
        /*00d0*/               @P2 BRA `(.L_x_4) ;
        .L_x_5:
        /*00e0*/                   LDS.128 R4, [R0] ;
        /*00f0*/                   FMNMX R8, R4, R5, PT ;
        /*0100*/                   FSEL R9, R8, +INF , P0 ;
        /*0110*/                   LOP3.LUT R2, R2, 0x1, RZ, 0xfc, !PT ;
        /*0120*/               @P2 BRA `(.L_x_5) ;
        /*0130*/                   EXIT ;
        Function : _Z20multi_any_hit_kernelILi4EEvPKfS1_S1_PKhi5Skips6StreamPh
        .L_x_6:
        /*0000*/                   FADD R8, -R4, R20 ;
        /*0010*/               @P2 BRA `(.L_x_6) ;
        Function : _Z20multi_any_hit_kernelILi5EEvPKfS1_S1_PKhi5Skips6StreamPh
        .L_x_7:
        /*0000*/                   LDS.64 R4, [R0] ;
        /*0010*/                   FSETP.GT.AND P0, PT, R4, RZ, PT ;
        /*0020*/                   FSETP.LT.OR P0, PT, R5, RZ, P0 ;
        /*0030*/                   PLOP3.LUT P0, PT, P0, P1, PT, 0x80, 0x0 ;
        /*0040*/               @P0 LOP3.LUT R2, R2, 0x10, RZ, 0xfc, !PT ;
        /*0050*/               @P2 BRA `(.L_x_7) ;
"""


# B4's: a barrier wait loop (no float32), then the ray loop of an AABB
# block: a uniform loop counter, the record head and the test of its live
# slot, whose forward branch (a ray without a cotangent) stays inside the
# loop, the set records, a primitive's rare branch; the S = 1 instance is
# not the one its pattern picks.
SASS_B4 = """
        Function : _Z27multi_chord_dens_bwd_kernelILi1EEvPKfS1_ii5SkipsS1_iS1_iS1_iiiPfS3_S3_
        /*0000*/                   FADD R8, -R4, R20 ;
        /*0010*/               @P2 BRA 0x0 ;
        Function : _Z27multi_chord_dens_bwd_kernelILi4EEvPKfS1_ii5SkipsS1_iS1_iS1_iiiPfS3_S3_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R2 ;
        /*0020*/              @!P0 BRA 0x10 ;
        /*0030*/                   UIMAD UR8, UR5, 0x50, UR14 ;
        /*0040*/                   UIADD3 UR5, UR5, 0x1, URZ ;
        /*0050*/                   UISETP.NE.AND UP0, UPT, UR5, 0x80, UPT ;
        /*0060*/                   LDS.128 R20, [UR8] ;
        /*0070*/                   FSETP.NEU.AND P0, PT, R23, RZ, PT ;
        /*0080*/              @!P0 BRA 0x130 ;
        /*0090*/                   LDS.128 R4, [UR8+0x10] ;
        /*00a0*/                   BSSY B0, 0x110 ;
        /*00b0*/              @!P4 BRA 0x100 ;
        /*00c0*/                   FADD R9, R24, -R20 ;
        /*00d0*/                   FMUL R10, R9, R4 ;
        /*00e0*/                   FMNMX R11, R10, R12, PT ;
        /*00f0*/                   FSEL R13, R11, RZ, P1 ;
        /*0100*/                   FFMA R38, R13, R7, R38 ;
        /*0110*/                   BSYNC B0 ;
        /*0120*/                   FADD R40, R40, R23 ;
        /*0130*/                   PLOP3.LUT P0, PT, PT, PT, UP0, 0x80, 0x0 ;
        /*0140*/               @P0 BRA 0x30 ;
        /*0150*/                   EXIT ;
"""

# B6's: the step loop holds the refill (warp vote, shuffle, the counter's
# atomic) and a row loop, so only the row loop is innermost; the pattern
# leaves out B2's kernel, whose name also ends in any_hit_kernel.
SASS_B6 = """
        Function : _Z20multi_any_hit_kernelILi5EEvPKfS1_S1_PKhi5Skips6StreamPh
        /*0000*/                   FADD R8, -R4, R20 ;
        /*0010*/               @P2 BRA 0x0 ;
        Function : _Z14any_hit_kernelPKfS0_S0_i6StreamPiPh
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   VOTE.ANY R2, PT, !P1 ;
        /*0020*/                   POPC R3, R2 ;
        /*0030*/               @P3 ATOMG.E.ADD.STRONG.GPU PT, R5, desc[UR6][R6.64], R4 ;
        /*0040*/                   SHFL.IDX PT, R5, R5, RZ, 0x1f ;
        /*0050*/                   LDS.128 R8, [R0] ;
        /*0060*/                   LDS.64 R12, [R0+0x10] ;
        /*0070*/                   FADD R14, R8, -R20 ;
        /*0080*/                   FMUL R15, R14, R24 ;
        /*0090*/                   FMNMX R16, R15, R17, !PT ;
        /*00a0*/                   FSETP.GEU.AND P2, PT, R16, R25, PT ;
        /*00b0*/                   SEL R18, RZ, 0x1, P2 ;
        /*00c0*/                   LOP3.LUT R19, R19, R18, RZ, 0xfc, !PT ;
        /*00d0*/               @P4 BRA 0x50 ;
        /*00e0*/                   BAR.RED.POPC RZ, 0x0, P5 ;
        /*00f0*/               @P6 BRA 0x10 ;
        /*0100*/                   EXIT ;
"""


@pytest.mark.parametrize("kernel", ["calibrate", "closest_hit",
                                    "multi_any_hit", "multi_chord_dens_bwd",
                                    "any_hit"])
def test_sass_loop_body_counts(kernel):
    if kernel == "calibrate":
        counts = C.loop_body_counts(SASS_B9)
        assert list(counts) == [("occl", 88)]
        fp32, hist = counts["occl", 88]
        assert fp32 == 6
        assert hist["LDS"] == 1 and hist["IADD3"] == 1 and hist["BRA"] == 1
        return
    if kernel in ("multi_chord_dens_bwd", "any_hit"):
        # The patterns chip_smoke.py's phase 2a reads.
        from audio_raytracer_tpu_torch.tools.roofline import LOOP_KERNELS

        key = "B4" if kernel == "multi_chord_dens_bwd" else "B6"
        name, pattern = LOOP_KERNELS[key]
        assert name == kernel
        bodies = C.loop_bodies(SASS_B4 if key == "B4" else SASS_B6, pattern)
        (fn, loops), = bodies.items()
        assert fn.startswith("_Z27multi_chord_dens_bwd_kernelILi4E"
                             if key == "B4" else "_Z14any_hit_kernel")
        got = [(lp["start"], lp["end"], lp["classes"]) for lp in loops]
        if key == "B4":
            # The wait loop holds no float32 instruction and is left out.
            assert got == [(0x30, 0x140, dict(fp32=7, int=1, mufu=0, lds=2,
                                               branch=5, other=3))]
        else:
            assert got == [(0x50, 0xd0, dict(fp32=5, int=1, mufu=0, lds=2,
                                              branch=1, other=0))]
        return
    pattern = {"closest_hit": r"closest_hit_kernel",
               "multi_any_hit": r"multi_any_hit_kernelILi5E"}[kernel]
    bodies = C.loop_bodies(SASS_B1_B2, pattern)
    assert len(bodies) == 1
    (name, loops), = bodies.items()
    assert kernel in name
    got = [(lp["start"], lp["end"], lp["classes"]) for lp in loops]
    if kernel == "closest_hit":
        # The wait loop holds no float32 instruction and is left out.
        assert got == [
            (0x30, 0xd0, dict(fp32=3, int=2, mufu=1, lds=1, branch=4,
                              other=0)),
            (0xe0, 0x120, dict(fp32=2, int=1, mufu=0, lds=1, branch=1,
                               other=0))]
    else:
        assert got == [(0x0, 0x50, dict(fp32=2, int=2, mufu=0, lds=1,
                                         branch=1, other=0))]


def test_any_hit_work_counts_pairs_up_to_the_first_occluder(backends,
                                                            rays):
    # B6's data-dependent op bound: per ray, the primitives in scan order
    # up to and including its first occluder, all of them if none.
    from audio_raytracer_tpu_torch.tools.roofline import any_hit_work

    fields = backends[0].fields
    o, d, _, limit = rays
    grid = K.any_hit_grid(fields, t(o), t(d), t(limit), NO_SKIP).numpy()
    want = np.zeros(3, np.int64)
    bounds = np.cumsum((0,) + fields.counts)
    for row in grid:
        n = int(np.argmax(row)) + 1 if row.any() else row.size
        want += np.clip(n - bounds[:3], 0, fields.counts)
    assert any_hit_work(fields, t(o), t(d), t(limit), NO_SKIP) == \
        tuple(want)
    assert 0 < want.sum() < R * fields.total


def test_any_hit_lockstep_recounts_lanes_times_the_longest_walk(backends,
                                                                rays):
    # B6's lock-step factor: a ray's walk is the counted operations (OPS)
    # of the primitives up to its first occluder in scan order; a group of
    # L rays in lock-step pays L x its longest walk.
    from audio_raytracer_tpu_torch.tools.roofline import any_hit_lockstep

    fields = backends[0].fields
    o, d, _, limit = rays
    grid = K.any_hit_grid(fields, t(o), t(d), t(limit), NO_SKIP).numpy()
    cost = np.repeat([K.OPS["sphere"], K.OPS["aabb"], K.OPS["obb"]],
                     fields.counts)
    occ = grid.any(axis=1)
    n = np.where(occ, grid.argmax(axis=1) + 1, grid.shape[1])
    walk = np.array([cost[:k].sum() for k in n], np.float64)
    got = any_hit_lockstep(fields, t(o), t(d), t(limit), NO_SKIP,
                           lanes=(1, 8, 32), log=lambda *a: None)
    assert got[1] == 1.0
    for L in (8, 32):
        w = walk.reshape(-1, L)
        assert got[L] == pytest.approx(L * w.max(axis=1).sum() / w.sum(),
                                       rel=1e-12)
        assert got[L] > 1.0
    assert got["never_occluded"] == pytest.approx(1.0 - occ.mean())
    for key, q in (("median_walk_occluded", 0.5), ("p90_walk_occluded",
                                                   0.9)):
        assert got[key] == pytest.approx(np.quantile(n[occ], q))


@pytest.mark.parametrize("sub", [1, 4])
def test_any_hit_rotation_recounts_walks_from_each_join(backends, rays, sub):
    # B6's refill factor: a ray that joins the cyclic row stream at row k
    # walks round the cycle from k up to and including its first occluder
    # (every row when none); averaged over joins at multiples of sub rows
    # and summed over rays, over the scan-order walks (k = 0).
    from audio_raytracer_tpu_torch.tools.roofline import any_hit_rotation

    fields = backends[0].fields
    o, d, _, limit = rays
    grid = K.any_hit_grid(fields, t(o), t(d), t(limit), NO_SKIP).numpy()
    cost = np.repeat([K.OPS["sphere"], K.OPS["aabb"], K.OPS["obb"]],
                     fields.counts).astype(np.float64)
    P = grid.shape[1]

    def walk(row, k):
        for n in range(P):
            if row[(k + n) % P]:
                return cost[(k + np.arange(n + 1)) % P].sum()
        return cost.sum()

    rotated = sum(np.mean([walk(r, k) for k in range(0, P, sub)])
                  for r in grid)
    scan = sum(walk(r, 0) for r in grid)
    got = any_hit_rotation(fields, t(o), t(d), t(limit), NO_SKIP, sub=sub,
                           log=lambda *a: None)
    assert got == pytest.approx(rotated / scan, rel=1e-9)
    assert got > 0.0