"""The port's bfloat16 tier (TraceConfig.compute_dtype="bfloat16"):
statistical parity with float32 and with the JAX package's bf16 tier.

The counterpart of ``tests/test_bf16.py``, at its sizes (4,096 rays, 64
primitives in a +/-20 cube, seed 7) and tolerances. On the CPU the port's
``KernelBackend(compute_dtype=torch.bfloat16)`` runs the plain versions
of B1-B3 on bfloat16 tensors: each geometry op rounds once, as the CUDA
kernels' bf16 instructions do, and the f32 islands of the JAX tier hold
the quadratic, the reciprocals, the compares and the sums. The JAX side
runs ``PallasBackend(interpret=True, compute_dtype=jnp.bfloat16)``, as
``tests/test_bf16.py`` does. XLA on the CPU may keep float32
intermediates inside a fused bf16 chain, so the two bf16 tiers are held
to each other by the same statistics as to float32, not bit for bit.
Measured on this fixture (the CPU, torch 2.13, JAX's interpreter): hit /
miss agreement 99.6 % with a median relative t error of 0.0 (75 % of the
hits equal), occlusion flags 99.9 % equal, chord sums with a median
relative error of 0.0 and totals 0.4 % apart; against float32 the port's
tier agrees on 98.5 % of hits (median t error 0.39 %), 99.8 % of flags,
chords 2.0 % median and 0.9 % in total.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.models.raytracer import random_scene
from audio_raytracer_tpu.ops.backend import NO_SKIP as J_NO_SKIP
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.ops.pallas import PallasBackend
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.models.raytracer import forward
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP, DenseBackend
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import KernelBackend
from audio_raytracer_tpu_torch.types import TraceConfig

torch.set_num_threads(1)

R = 4096
P = 64
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def jscene():
    return random_scene(jax.random.key(7), num_spheres=P // 4,
                        num_aabbs=P // 2, num_obbs=P // 4, num_targets=2,
                        extent=20.0, size_range=(0.5, 4.0))


@pytest.fixture(scope="module")
def scene(jscene):
    return scene_from_arrays(jax.tree.map(np.asarray, jscene), device="cpu")


@pytest.fixture(scope="module")
def rays():
    o = np.zeros((R, 3), np.float32) + np.array([0.3, 0.1, 0.2], np.float32)
    return o, np.asarray(fibonacci_directions(R))


def tt(x):
    return torch.as_tensor(np.array(x))


def sets(d):
    """The two ray sets of tests/test_bf16.py: d and -d."""
    return [d, -d]


def hit_stats(t16, tf):
    """(hit / miss agreement, median relative t error on common hits)."""
    t16, tf = np.asarray(t16), np.asarray(tf)
    agree = (np.isfinite(t16) == np.isfinite(tf)).mean()
    m = np.isfinite(t16) & np.isfinite(tf)
    return agree, np.median(np.abs(t16[m] - tf[m]) / np.abs(tf[m]))


def chord_stats(c16, cf):
    """(median relative error where cf > 0.1, relative error of the
    totals)."""
    c16, cf = np.asarray(c16), np.asarray(cf)
    m = cf > 0.1
    assert m.any()
    rel = np.abs(c16[m] - cf[m]) / cf[m]
    return np.median(rel), abs(c16.sum() - cf.sum()) / cf.sum()


# ---------------------------------------------------------------------------
# tests/test_bf16.py's five tests: the port's bf16 tier against its dense
# float32 tier
# ---------------------------------------------------------------------------


def test_bf16_closest_hit_statistics(scene, rays):
    o, d = tt(rays[0]), tt(rays[1])
    t16, _ = KernelBackend(scene, compute_dtype=BF16).local_closest(o, d)
    _, tf, _ = DenseBackend(scene).closest_hit(o, d)
    agree, med = hit_stats(t16, tf)
    assert agree >= 0.95, agree
    assert med < 0.01, med


def test_bf16_occlusion_statistics(scene, rays):
    o, d = tt(rays[0]), tt(rays[1])
    args = (o, sets(d), torch.full((R, 2), 10.0), (NO_SKIP, 0),
            torch.zeros((R, 2), dtype=torch.bool))
    occ16 = KernelBackend(scene, compute_dtype=BF16).multi_occluded(*args)
    occf = DenseBackend(scene).multi_occluded(*args)
    assert (occ16 == occf).float().mean() >= 0.98


def test_bf16_chord_statistics(scene, rays):
    o, d = tt(rays[0]), tt(rays[1])
    c16 = KernelBackend(scene, compute_dtype=BF16).multi_permeation_loss(
        o, sets(d), (0, 1))
    cf = DenseBackend(scene).multi_permeation_loss(o, sets(d), (0, 1))
    med, total = chord_stats(c16, cf)
    assert med < 0.05, med
    assert total < 0.05, total


def test_bf16_forward_end_to_end(scene, rays):
    """Both tiers with epsilon >= the bf16 position resolution at this
    world scale (~20 m * 2^-8 ~ 0.08), the tier's documented requirement,
    so that differences isolate to arithmetic precision."""
    d = tt(rays[1])
    origin = torch.tensor([0.3, 0.1, 0.2])
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = TraceConfig(ray_count=R, max_bounces=2, max_ray_life=60.0,
                          max_muffle_hit_distance=50.0, compute_dtype=dt,
                          epsilon=0.25)
        out[dt] = forward(origin, d, scene, cfg, backend="kernel",
                          device="cpu")[0]
    rf, rb = out["float32"], out["bfloat16"]
    mf, mb = rf.muffle_hits.sum(0).numpy(), rb.muffle_hits.sum(0).numpy()
    assert (np.abs(mb - mf) <= np.maximum(0.25 * mf, 25)).all(), (mf, mb)
    np.testing.assert_allclose(rb.permeation.sum(0).numpy(),
                               rf.permeation.sum(0).numpy(), rtol=0.05,
                               atol=1.0)
    ef, eb = float(rf.echo_distances.sum()), float(rb.echo_distances.sum())
    assert abs(eb - ef) / max(abs(ef), 1e-6) < 0.25


def test_f32_tier_unchanged_by_dtype_plumbing(scene, rays):
    """compute_dtype=torch.float32 is bit-identical to the engine without
    the argument, for B1, B2 and B3 (every rounding and widening is the
    identity in float32)."""
    o, d = tt(rays[0]), tt(rays[1])
    a = KernelBackend(scene, compute_dtype=torch.float32)
    b = KernelBackend(scene)
    for x, y in zip(a.local_closest(o, d), b.local_closest(o, d)):
        assert torch.equal(x, y)
    fields = b.fields
    args = (o, sets(d), torch.full((R, 2), 10.0), (NO_SKIP, 0),
            torch.zeros((R, 2), dtype=torch.bool))
    assert torch.equal(
        F.run_multi_any_hit(fields, *args, compute_dtype=torch.float32),
        F.run_multi_any_hit(fields, *args))
    assert torch.equal(
        F.run_multi_chord(fields, o, sets(d), (0, 1),
                          compute_dtype=torch.float32),
        F.run_multi_chord(fields, o, sets(d), (0, 1)))


# ---------------------------------------------------------------------------
# The port's bf16 tier against the JAX package's Pallas bf16 tier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bf16(jscene):
    return PallasBackend(jscene, interpret=True, compute_dtype=jnp.bfloat16)


def test_bf16_closest_hit_matches_jax_tier(scene, jax_bf16, rays):
    o, d = rays
    t16, _ = KernelBackend(scene, compute_dtype=BF16).local_closest(
        tt(o), tt(d))
    tj, _ = jax_bf16.local_closest(jnp.asarray(o), jnp.asarray(d))
    agree, med = hit_stats(t16, tj)
    assert agree >= 0.95, agree
    assert med < 0.01, med


def test_bf16_occlusion_matches_jax_tier(scene, jax_bf16, rays):
    o, d = rays
    lim = np.full((R, 2), 10.0, np.float32)
    init = np.zeros((R, 2), bool)
    occ16 = KernelBackend(scene, compute_dtype=BF16).multi_occluded(
        tt(o), [tt(x) for x in sets(d)], tt(lim), (NO_SKIP, 0), tt(init))
    occj = jax_bf16.multi_occluded(jnp.asarray(o),
                                   [jnp.asarray(x) for x in sets(d)],
                                   jnp.asarray(lim), (J_NO_SKIP, 0),
                                   jnp.asarray(init))
    assert (occ16.numpy() == np.asarray(occj)).mean() >= 0.98


def test_bf16_chords_match_jax_tier(scene, jax_bf16, rays):
    o, d = rays
    c16 = KernelBackend(scene, compute_dtype=BF16).multi_permeation_loss(
        tt(o), [tt(x) for x in sets(d)], (0, 1))
    cj = jax_bf16.multi_permeation_loss(
        jnp.asarray(o), [jnp.asarray(x) for x in sets(d)], (0, 1))
    med, total = chord_stats(c16, cj)
    assert med < 0.05, med
    assert total < 0.05, total


def test_bf16_departure_at_the_headline_extent_is_the_tiers():
    """At the headline's extent (+/-60, 4,096 primitives: JAX's
    random_scene(key(0), 1024, 2048, 1024, 4 targets), 2,048 rays, 4
    bounces, life 300, epsilon 0.25 >= 60 x 2^-8) the bf16 tier departs
    from float32 beyond test_bf16_forward_end_to_end's tolerances, in the
    JAX package's Pallas tier (interpret mode) as in the port's: bf16
    rounds |oc|^2 and h^2 (~10^4 here, an ulp of 64) before the sign
    tests subtract them, so spheres near a ray flip. Measured on this
    fixture (the CPU): muffle hits f32 [3520, 121, 127, 851], port bf16
    [3206, 76, 105, 765], JAX bf16 [3185, 75, 97, 728] (target 1: 37 %
    below float32 in both, over the 25 % bound); echo sums 99,731 f32,
    85,280 port bf16, 83,725 JAX bf16. The two bf16 tiers stay closer to
    each other than either is to float32."""
    from audio_raytracer_tpu.models.raytracer import forward as j_forward
    from audio_raytracer_tpu.types import TraceConfig as JConfig

    jscene = random_scene(jax.random.key(0), 1024, 2048, 1024,
                          num_targets=4, extent=60.0, size_range=(0.5, 4.0))
    scene = scene_from_arrays(jax.tree.map(np.asarray, jscene), device="cpu")
    R = 2048
    d = np.asarray(fibonacci_directions(R))
    kw = dict(ray_count=R, max_bounces=4, max_ray_life=300.0,
              max_muffle_hit_distance=250.0, epsilon=0.25)
    out = {}
    for dt in ("float32", "bfloat16"):
        res, _ = forward(torch.zeros(3), tt(d), scene,
                         TraceConfig(compute_dtype=dt, **kw),
                         backend="kernel", device="cpu")
        out[dt] = (res.muffle_hits.sum(0).numpy(),
                   float(res.echo_distances.sum()))
    res, _ = j_forward(jnp.zeros(3), jnp.asarray(d), jscene,
                       JConfig(compute_dtype="bfloat16", **kw),
                       backend="pallas_interpret")
    out["jax"] = (np.asarray(res.muffle_hits).sum(0),
                  float(np.asarray(res.echo_distances).sum()))
    (mf, ef), (mb, eb), (mj, ej) = out["float32"], out["bfloat16"], \
        out["jax"]
    # The departure from float32 is the tier's: the two bf16 tiers agree
    # far better with each other than with float32.
    assert abs(eb - ej) < 0.25 * abs(eb - ef), out
    assert np.abs(mb - mj).sum() < 0.25 * np.abs(mb - mf).sum(), out
    assert (np.abs(mb - mj) <= np.maximum(0.1 * mj, 10)).all(), out


def jax_scene(scene):
    """The JAX package's Scene with the fields of the port's ``scene``."""
    from audio_raytracer_tpu import types as JT

    def j(t):
        return jnp.asarray(t.numpy())

    def common(p):
        m = p.material
        return dict(center=j(p.center), target_id=j(p.target_id),
                    active=j(p.active), material=JT.Materials(
                        j(m.absorption), j(m.density), j(m.echo)))

    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    return JT.Scene(
        JT.Spheres(radius=j(sp.radius), **common(sp)),
        JT.Aabbs(half_extents=j(ab.half_extents), **common(ab)),
        JT.Obbs(half_extents=j(ob.half_extents), inv_rot=j(ob.inv_rot),
                **common(ob)),
        j(scene.target_positions))


def test_bf16_departure_on_the_smoke_headline_is_the_tiers():
    """chip_smoke.py's headline frame (the port's numpy random_scene(0,
    1024, 2048, 1024, 4 targets, extent 60), the listener at the origin,
    4 bounces, life 300, epsilon 0.25) departs in bf16 from float32
    beyond test_bf16_forward_end_to_end's bounds: on an NVIDIA H100 80GB
    HBM3 at 700 W (chip_smoke.py phase 17c) muffle hits f32 [7, 25417, 3,
    0] against bf16 [1472, 23389, 29349, 364], echo sums 12.05 % below.
    Here every 512th of its 1,048,576 directions (chip_smoke.py's
    BF16_WITNESS_STRIDE, whose card frame 17c holds to this CPU frame)
    goes through the port's tiers and the JAX package's Pallas tiers in
    interpret mode. Measured on the CPU: f32 [0, 52, 0, 0] in both
    packages; bf16 [2, 52, 67, 1] in the port, [1, 44, 60, 1] in JAX
    (target 2: 3.3 % and 2.9 % of the rays hear it, 2.8 % on the card's
    full frame, against none in f32); echo sums 99,200 f32, 87,379 port
    bf16 (11.9 % below), 87,966 JAX bf16 (11.3 % below). The departure is
    the tier's: JAX's bf16 tier makes it on the same inputs. Target 2
    lies inside sphere 732 (2.95 from its centre, radius 3.72), so no
    float32 path reaches it; bf16 rounds |oc|^2 (up to ~10^4 from a far
    hit point, an ulp of 64) before r^2 (13.8) is taken from it, and
    some paths miss that sphere."""
    from audio_raytracer_tpu.models.raytracer import forward as j_forward
    from audio_raytracer_tpu.types import TraceConfig as JConfig
    from audio_raytracer_tpu_torch.models.raytracer import random_scene
    from audio_raytracer_tpu_torch.ops.fibonacci import (
        fibonacci_directions as t_fibonacci,
    )

    scene = random_scene(0, 1024, 2048, 1024, num_targets=4, extent=60.0,
                         size_range=(0.5, 4.0), device="cpu")
    gap = (scene.spheres.center[732] - scene.target_positions[2]).norm()
    assert gap < scene.spheres.radius[732]  # target 2 inside sphere 732
    d = t_fibonacci(1 << 20, device="cpu")[::512].contiguous()
    kw = dict(ray_count=d.shape[0], max_bounces=4, max_ray_life=300.0,
              max_muffle_hit_distance=250.0, epsilon=0.25,
              num_reverb_bins=64)
    jscene, jd = jax_scene(scene), jnp.asarray(d.numpy())
    out = {}
    for dt in ("float32", "bfloat16"):
        res, _ = forward(torch.zeros(3), d, scene,
                         TraceConfig(compute_dtype=dt, **kw),
                         backend="kernel", device="cpu")
        out["port", dt] = (res.muffle_hits.sum(0).numpy(),
                           float(res.echo_distances.sum()))
        res, _ = j_forward(jnp.zeros(3), jd, jscene,
                           JConfig(compute_dtype=dt, **kw),
                           backend="pallas_interpret")
        out["jax", dt] = (np.asarray(res.muffle_hits).sum(0),
                          float(np.asarray(res.echo_distances).sum()))
    (mf, ef), (jf, jef) = out["port", "float32"], out["jax", "float32"]
    (mb, eb), (mj, ej) = out["port", "bfloat16"], out["jax", "bfloat16"]
    # The float32 tiers agree.
    assert (np.abs(mf - jf) <= 1).all(), out
    assert abs(ef - jef) <= 1e-4 * abs(jef), out

    def outside(m):  # test_bf16_forward_end_to_end's muffle bound
        return np.abs(m - mf) > np.maximum(0.25 * mf, 25)

    # Both bf16 tiers leave the bound, on the same targets, ...
    assert outside(mb).any() and (outside(mb) == outside(mj)).all(), out
    # ... stay near each other, ...
    assert (np.abs(mb - mj) <= np.maximum(0.1 * mj, 10)).all(), out
    # ... and their echo sums fall below float32's alike.
    assert eb < 0.95 * ef and ej < 0.95 * ef, out
    assert abs(eb - ej) < 0.25 * abs(eb - ef), out


# ---------------------------------------------------------------------------
# The plumbing
# ---------------------------------------------------------------------------


def test_torch_bf16_ops_round_once_each():
    """A bf16 ``a * b + c`` on the CPU rounds after the product and after
    the sum (two ops, two roundings: no fused multiply-add), which is
    what the kernels' mul.rn / add.rn do. With a = b = 1 + 2^-7 the
    product 1 + 2^-6 + 2^-14 rounds to 1 + 2^-6, so adding -(1 + 2^-7)
    gives 2^-7; one rounding of the exact a b + c would give 2^-7 +
    2^-14."""
    a = torch.tensor([1 + 2**-7], dtype=BF16)
    c = torch.tensor([-(1 + 2**-7)], dtype=BF16)
    assert float(a * a + c) == 2**-7
    exact = (1 + 2**-7) ** 2 - (1 + 2**-7)
    assert float(torch.tensor([exact]).to(BF16)) == 2**-7 + 2**-14


def test_trace_config_compute_dtypes():
    assert TraceConfig(compute_dtype="bfloat16").compute_torch_dtype == BF16
    assert TraceConfig().compute_torch_dtype == torch.float32
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        TraceConfig(compute_dtype="float16")


def test_wrappers_refuse_other_compute_types(scene, rays):
    o, d = tt(rays[0][:8]), tt(rays[1][:8])
    fields = KernelBackend(scene).fields
    with pytest.raises(ValueError, match="bfloat16"):
        K.run_closest_hit(fields, o, d, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        F.run_multi_chord(fields, o, [d], (0,), compute_dtype=torch.float64)
    with pytest.raises(ValueError, match="bfloat16"):
        KernelBackend(scene, compute_dtype=torch.float16)


def test_differentiable_forces_float32(scene, rays):
    o, d = tt(rays[0]), tt(rays[1])
    be = KernelBackend(scene, differentiable=True, compute_dtype=BF16)
    assert be.compute_dtype == torch.float32
    t_d, i_d = be.local_closest(o, d)
    t_f, i_f = KernelBackend(scene).local_closest(o, d)
    assert torch.equal(t_d, t_f) and torch.equal(i_d, i_f)


def test_single_set_protocol_stays_float32(scene, rays):
    """``occluded`` (B6) and ``permeation_loss`` (B7) run float32 in the
    bf16 engine, as the JAX package's single-set wrappers do."""
    o, d = tt(rays[0]), tt(rays[1])
    b16, f32 = KernelBackend(scene, compute_dtype=BF16), KernelBackend(scene)
    for skip in (None, 0):
        assert torch.equal(b16.occluded(o, d, 10.0, skip),
                           f32.occluded(o, d, 10.0, skip))
        assert torch.equal(b16.permeation_loss(o, d, skip),
                           f32.permeation_loss(o, d, skip))
    # The fused paths do take the tier.
    assert not torch.equal(b16.closest_t(o, d), f32.closest_t(o, d))


def test_forward_takes_the_tier_only_on_the_kernel_engine(scene, rays):
    d = tt(rays[1][:512])
    origin = torch.tensor([0.3, 0.1, 0.2])
    cfg = TraceConfig(ray_count=512, max_bounces=1, max_ray_life=60.0,
                      epsilon=0.25)
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    dense = [forward(origin, d, scene, c, backend="dense", device="cpu")[0]
             for c in (cfg, cfg16)]
    assert torch.equal(dense[0].echo_distances, dense[1].echo_distances)
    kern = [forward(origin, d, scene, c, backend="kernel", device="cpu")[0]
            for c in (cfg, cfg16)]
    assert not torch.equal(kern[0].echo_distances, kern[1].echo_distances)


# ---------------------------------------------------------------------------
# B1-bf16 and B2-bf16 read tables rounded once: each geometry field a
# bf16x2 word holding its bfloat16 rounding in both halves
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def owned_fields():
    """Tables of a scene whose targets own colliders and some of whose
    AABBs are inactive: the occlusion tables have free and owned parts
    and leave rows out; no type fills whole tiles."""
    from audio_raytracer_tpu_torch.models.raytracer import random_scene as tr

    sc = tr(3, 37, 150, 29, num_targets=3, extent=20.0,
            target_owned_colliders=True, device="cpu")
    act = torch.arange(150) % 3 != 0
    sc = sc.replace(aabbs=dataclasses.replace(sc.aabbs, active=act))
    return KernelBackend(sc).fields


def word_halves(tab, n):
    """(low, high) 16-bit halves of the words of tab's first n columns."""
    w = tab.view(torch.int32)[:, :n].to(torch.int64) & 0xFFFFFFFF
    return w & 0xFFFF, w >> 16


def bf16_bits(x):
    return x.to(BF16).view(torch.int16).to(torch.int64) & 0xFFFF


def bf16_table_pairs(fields):
    """(float32 table, bf16x2 table, real rows) of B1's three tables and
    of B2's for skips (NO_SKIP, 0, 2)."""
    out = list(zip(K.closest_tables(fields),
                   K.closest_tables(fields, BF16), fields.counts))
    for (tab, n_free, n_owned), (tab16, *_) in zip(
            K.occlusion_tables(fields, (NO_SKIP, 0, 2)),
            K.occlusion_tables(fields, (NO_SKIP, 0, 2), BF16)):
        out.append((tab, tab16, None))
    return out


def test_bf16x2_words_hold_the_rounded_geometry_in_both_halves(
        owned_fields):
    rounded = owned_fields.rounded(BF16)
    for tab, tab16, n_real in bf16_table_pairs(owned_fields):
        assert tab16.shape == tab.shape and tab16.dtype == torch.float32
        n = K.GEOMETRY_COLUMNS[tab.shape[1]]
        lo, hi = word_halves(tab16, n)
        assert torch.equal(lo, hi)
        assert torch.equal(lo, bf16_bits(tab[:, :n]))
        # What the kernel widens (fields.cuh BF16X2::half) is the float32
        # of the rounding.
        w = tab16.view(torch.int32)[:, :n]
        for half in ((w << 16), (w & -65536)):
            assert torch.equal(half.view(torch.float32),
                               tab[:, :n].to(BF16).float())
        if n_real is not None:  # B1's rows are the fields' rows
            geo = {K.SPH_W: rounded.sph, K.AABB_W: rounded.aabb,
                   K.OBB_W: rounded.obb}[tab.shape[1]]
            assert torch.equal(lo[:n_real], bf16_bits(geo[:, :n]))
        if tab.shape[1] == K.SPH_W:
            assert torch.equal(tab16[:, K.S_R2],
                               tab[:, K.S_R2].to(BF16).float())
            if n_real is not None:
                assert torch.equal(tab16[:n_real, K.S_R2],
                                   rounded.sph[:, K.S_R2].float())


def test_bf16x2_tables_keep_the_float32_columns(owned_fields):
    for tab, tab16, _ in bf16_table_pairs(owned_fields):
        first = {K.SPH_W: K.S_TGT}.get(tab.shape[1],
                                       K.GEOMETRY_COLUMNS[tab.shape[1]])
        # miss, target, density and padding columns: the same bits
        assert torch.equal(tab16.view(torch.int32)[:, first:],
                           tab.view(torch.int32)[:, first:])


def test_bf16x2_padding_rows_are_still_miss_rows(owned_fields):
    for tab, tab16, n_real in bf16_table_pairs(owned_fields):
        assert tab16.shape[0] % K.TILE == 0
        if n_real is None:
            # B2's tables: active rows, then padding (never hits)
            act = K.active_rows(tab)
            assert torch.equal(K.active_rows(tab16), act)
            pad = ~act
        else:
            pad = torch.arange(tab.shape[0]) >= n_real
            assert bool(pad.any())
            assert not bool(K.active_rows(tab16)[pad].any())
        miss = K.miss_row(tab.shape[1], "cpu")
        assert torch.equal(K.bf16x2_table(miss[None]).view(torch.int32)[0],
                           tab16[pad].view(torch.int32)[0])
        assert torch.equal(K.ids(tab16, {K.SPH_W: K.S_TGT, K.AABB_W: K.A_TGT,
                                         K.OBB_W: K.O_TGT}[tab.shape[1]])
                           [pad], torch.full((int(pad.sum()),), -1,
                                             dtype=torch.int32))


def test_bf16x2_tables_are_built_once_per_fields_dtype_and_skips(scene):
    fields = KernelBackend(scene).fields
    c16 = K.closest_tables(fields, BF16)
    assert K.closest_tables(fields, BF16) is c16
    assert K.closest_tables(fields) is not c16
    o16 = K.occlusion_tables(fields, (NO_SKIP, 1), BF16)
    assert K.occlusion_tables(fields, (1, NO_SKIP), BF16) is o16
    assert K.occlusion_tables(fields, (NO_SKIP, 0), BF16) is not o16
    assert K.occlusion_tables(fields, (NO_SKIP, 1)) is not o16
    keys = [k for k in fields.derived if isinstance(k, tuple) and BF16 in k]
    assert sorted(map(str, keys)) == sorted(map(str, [
        ("closest", BF16), ("occlusion", (NO_SKIP, 1), BF16),
        ("occlusion", (NO_SKIP, 0), BF16)]))
    # Other tables of the same scene build their own.
    assert K.closest_tables(KernelBackend(scene).fields, BF16) is not c16


def test_bf16_wrappers_take_the_plain_versions_on_the_cpu(scene, rays,
                                                           monkeypatch):
    from audio_raytracer_tpu_torch.ops.cuda import build

    def no_library(name):
        raise AssertionError(f"{name}: a CPU tensor built a kernel")

    monkeypatch.setattr(build, "load", no_library)
    fields = KernelBackend(scene).fields
    o, d = tt(rays[0][:300]), tt(rays[1][:300])
    alive = torch.arange(300) % 5 != 2
    before = (K.run_closest_hit.launches_bf16,
              F.run_multi_any_hit.launches_bf16)
    t, rank = K.run_closest_hit(fields, o, d, alive, compute_dtype=BF16)
    t_p, rank_p = K.closest_hit_plain(fields, o, d, alive, compute_dtype=BF16)
    assert torch.equal(t, t_p) and torch.equal(rank, rank_p)
    lim = torch.full((300, 2), 10.0)
    init = torch.zeros((300, 2), dtype=torch.bool)
    args = (fields, o, sets(d), lim, (NO_SKIP, 0), init)
    assert torch.equal(F.run_multi_any_hit(*args, compute_dtype=BF16),
                       F.multi_any_hit_plain(*args, compute_dtype=BF16))
    assert (K.run_closest_hit.launches_bf16,
            F.run_multi_any_hit.launches_bf16) == before
    assert [k for k in fields.derived
            if isinstance(k, tuple) and BF16 in k] == [("rounded", BF16)]


def bf16_up(x: float) -> int:
    """csrc/fields.cuh::bf16_up: the smallest bfloat16 at or above x."""
    u = int(np.float32(x).view(np.uint32))
    if x != x:
        return 0x7FC0
    return (u >> 16) + int((u & 0xFFFF) != 0 and not u >> 31)


def test_limit_rounded_up_decides_as_the_float32_compare():
    """B2-bf16 tests a slab's bfloat16 hit t against its float32 limit
    as t < bf16_up(limit), a packed bfloat16 compare: for every
    bfloat16 t the answer is the float32 compare's."""
    t = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(BF16)
    rng = np.random.default_rng(0)
    lims = np.concatenate([
        rng.standard_normal(300).astype(np.float32) * 100,
        np.frombuffer(rng.integers(0, 2**32, 300, dtype=np.uint32)
                      .astype(np.uint32).tobytes(), np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.3895314e38,
                  3.4028235e38, -3.4028235e38, 1e-45, -1e-45, 1.0,
                  1.00390625, 1.0039063], np.float32)])
    tf = t.float()
    for lim in lims:
        up = torch.tensor([bf16_up(float(lim))], dtype=torch.int32) \
            .to(torch.int16).view(BF16)
        assert torch.equal(tf < torch.tensor(float(lim)), t < up), lim


SASS_PACKED = """
        Function : _Z23calibrate_bf16x2_kernelILi1ELi88EEvPKjiPKfiPj
        .L_x_1:
        /*0000*/                   LDS.128 R4, [UR5] ;
        /*0010*/                   VHMNMX.BF16_V2 R2, R2, R4.reuse, R5.reuse, PT ;
        /*0020*/                   VHMNMX.BF16_V2 R9, R9, R4, R5, !PT ;
        /*0030*/                   HMNMX2.BF16_V2 R10, R10, R7, PT ;
        /*0040*/               @P1 BRA `(.L_x_1) ;
        Function : _Z23calibrate_bf16x2_kernelILi0ELi88EEvPKjiPKfiPj
        .L_x_2:
        /*0000*/                   LDS.64 R12, [UR5+0x10] ;
        /*0010*/                   HMUL2.BF16_V2 R2, R2, R4 ;
        /*0020*/                   HFMA2.BF16_V2 R2, R2, 1, 1, R6 ;
        /*0030*/                   PRMT R3, R2, 0x7632, R3 ;
        /*0040*/               @P1 BRA `(.L_x_2) ;
        Function : _Z16calibrate_kernelILi0ELi88EEvPKfiS1_i9CalConstsPf
        .L_x_3:
        /*0000*/                   FMUL R2, R2, R4 ;
        /*0010*/               @P1 BRA `(.L_x_3) ;
"""


def test_packed_loop_counts_count_a_fused_min_max_twice():
    """The packed calibration's loop bodies: a VHMNMX (ptxas's fusion of
    two chained min.bf16x2 or max.bf16x2) is two packed operations; the
    float32 calibration's loop bodies are not packed ones."""
    from audio_raytracer_tpu_torch.ops.cuda import calibrate as C

    counts = C.packed_loop_counts(SASS_PACKED)
    assert sorted(counts) == [("addmul", 88), ("minmax", 88)]
    assert counts["minmax", 88][0] == 5
    assert counts["addmul", 88][0] == 2
    assert counts["addmul", 88][1]["PRMT"] == 1
    (ops,) = [lp["ops"] for lps in C.loop_bodies(
        SASS_PACKED, r"ILi0ELi88E", C.PACKED_OPCODES).values() for lp in lps]
    assert C.packed_classes(ops) == dict(packed=2, VHMNMX=0, PRMT=1, F2F=0,
                                         F2FP=0)
    assert list(C.loop_body_counts(SASS_PACKED)) == [("fma4", 88)]


def _bf16_round(x: float) -> float:
    """x (a float64 that float32 holds exactly) rounded to bfloat16."""
    return float(torch.tensor(x, dtype=torch.float32).to(BF16).float())


@pytest.mark.parametrize("mix", ["add", "mul"])
def test_packed_calibration_chains_alone_round_each_step(mix):
    """The packed calibration's "add" and "mul" mixes (eight chains of
    add.rn.bf16x2 or mul.rn.bf16x2 alone) on the CPU: each step rounds
    the exact sum or product of two bfloat16 values to bfloat16, and the
    result is the eight chains summed left to right, as the kernel's."""
    from audio_raytracer_tpu_torch.ops.cuda import calibrate as C

    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(0.5, 1.5, 4), dtype=BF16)
    fields = [torch.tensor(rng.uniform(0.9, 1.1, 3), dtype=torch.float32)
              for _ in range(6)]
    got = C.run_calibrate_bf16x2(mix, 88, x, fields)
    assert torch.equal(got, C.calibrate_bf16x2_plain(mix, 88, x, fields))
    f = [[_bf16_round(float(t[p])) for t in fields] for p in range(3)]
    step = (lambda a, b: a + b) if mix == "add" else (lambda a, b: a * b)
    for lane, v0 in enumerate(x.float().tolist()):
        v = [v0] + [_bf16_round(v0 * _bf16_round(k))
                    for k in (1.1, 0.9, 1.2, 1.3, 0.8, 1.05, 0.95)]
        for p in range(3):
            for q in range(88 // 8):
                v = [_bf16_round(step(vk, f[p][q % 6])) for vk in v]
        want = v[0]
        for vk in v[1:]:
            want = _bf16_round(want + vk)
        assert float(got[lane]) == want, (mix, lane)
