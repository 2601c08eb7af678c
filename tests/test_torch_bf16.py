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
