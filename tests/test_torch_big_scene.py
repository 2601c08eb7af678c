"""Scenes past the Pallas SMEM budget, on the port, against the JAX package.

tests/test_pallas.py::TestChunkedBackend on the port. The JAX package
streams such scenes through ``ChunkedPallasBackend``
(ops/pallas/chunked.py), because Pallas keeps every primitive field in
SMEM; the port's kernels read their tables from global memory and take
any primitive count in one launch, so ``KernelBackend`` is held to the
behaviour ``chunked.py`` had. On its ``_big_scene`` (key 11; 12,000
spheres, AABBs and OBBs; 2 targets; extent 120; sizes (0.5, 3)):

- the port's ``KernelBackend`` (its kernels' plain versions on the CPU)
  against JAX's ``ChunkedPallasBackend(interpret=True)`` and
  ``DenseBackend`` at 128 rays, with that test's tolerances: closest-hit
  flags equal, t within 1e-5 / 1e-4, the winners' attributes within
  1e-6 (ties across what were chunk boundaries included), occlusion
  flags more than 99.9 % equal, chords within 5e-3 / 5e-2;
- the forward at 64 rays, 2 bounces, life 200, 2 accumulation batches,
  both engines against JAX's ``jnp`` tier, muffle within 1e-4 / 5e-3;
- the kernel engine's materials gradients, all finite and some nonzero,
  against JAX's dense autodiff;
- the 13,797-OBB scene of ``test_chunk_count_accounts_for_padding``
  (key 5), whose count broke the naive chunk count, through both
  engines' forward against JAX's ``jnp`` tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_raytracer_tpu import types as jtypes
from audio_raytracer_tpu.models import differentiable as jdiff
from audio_raytracer_tpu.models.raytracer import forward as j_forward
from audio_raytracer_tpu.models.raytracer import random_scene as j_random_scene
from audio_raytracer_tpu.ops.backend import NO_SKIP as J_NO_SKIP
from audio_raytracer_tpu.ops.backend import DenseBackend as JDense
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.ops.pallas import ChunkedPallasBackend
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.models import differentiable as tdiff
from audio_raytracer_tpu_torch.models import raytracer as tmodel
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import KernelBackend

torch.set_num_threads(1)

R = 128
ORIGIN = [0.3, -0.2, 0.4]
FWD = dict(ray_count=64, max_bounces=2, max_ray_life=200.0,
           num_accum_batches=2)
# tests/test_torch_train.py's gradient tolerance.
GRAD = dict(rtol=2e-4, atol=2e-6)


@pytest.fixture(scope="module")
def jbig():
    return j_random_scene(jax.random.key(11), num_spheres=12_000,
                          num_aabbs=12_000, num_obbs=12_000, num_targets=2,
                          extent=120.0, size_range=(0.5, 3.0))


@pytest.fixture(scope="module")
def big(jbig):
    return scene_from_arrays(jax.tree.map(np.asarray, jbig), device="cpu")


@pytest.fixture(scope="module")
def rays():
    d = np.array(fibonacci_directions(R))
    o = np.zeros((R, 3), np.float32) + np.float32(ORIGIN)
    return o, d


@pytest.fixture(scope="module")
def jax_protocol(jbig, rays):
    """JAX backend name -> (closest_hit, multi_occluded,
    multi_permeation_loss) on the 128 rays, each backend run once."""
    o, d = (jnp.asarray(x) for x in rays)
    dirs = [d, -d]
    limits = jnp.full((R, 2), 60.0)
    init = jnp.zeros((R, 2), bool)
    out = {}
    for name, be in (("chunked", ChunkedPallasBackend(jbig, interpret=True)),
                     ("dense", JDense(jbig))):
        hit, t, attrs = be.closest_hit(o, d)
        out[name] = (
            (np.asarray(hit), np.asarray(t),
             {k: np.asarray(v) for k, v in attrs.items()}),
            np.asarray(be.multi_occluded(o, dirs, limits, (J_NO_SKIP, 0),
                                         init)),
            np.asarray(be.multi_permeation_loss(o, dirs, (0, 1))))
    return out


def test_the_scene_is_past_the_smem_budget(jbig, big):
    from audio_raytracer_tpu.ops.pallas.chunked import num_chunks_required

    assert num_chunks_required(jbig) >= 3
    assert big.num_primitives == 36_000
    # One table per type, every row in one launch: 282 tiles of B1's.
    fields = KernelBackend(big).fields
    assert fields.counts == (12_000, 12_000, 12_000)
    assert sum(-(-n // K.TILE) for n in fields.counts) == 282


@pytest.fixture(scope="module")
def port_protocol(big, rays):
    o, d = (torch.as_tensor(x) for x in rays)
    be = KernelBackend(big)
    hit, t, attrs = be.closest_hit(o, d)
    occ = be.multi_occluded(o, [d, -d], torch.full((R, 2), 60.0),
                            (NO_SKIP, 0), torch.zeros((R, 2), dtype=bool))
    loss = be.multi_permeation_loss(o, [d, -d], (0, 1))
    return (hit.numpy(), t.numpy(), {k: v.numpy() for k, v in attrs.items()},
            occ.numpy(), loss.numpy())


@pytest.mark.parametrize("ref", ["chunked", "dense"])
def test_closest_hit_matches_jax(port_protocol, jax_protocol, ref):
    hit, t, attrs = port_protocol[:3]
    (hit_j, t_j, attrs_j), _, _ = jax_protocol[ref]
    np.testing.assert_array_equal(hit, hit_j)
    assert hit.sum() > 0
    np.testing.assert_allclose(t[hit], t_j[hit], rtol=1e-5, atol=1e-4)
    for k in ("kind", "echo", "absorption"):
        np.testing.assert_allclose(attrs[k][hit], attrs_j[k][hit], rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("ref", ["chunked", "dense"])
def test_occlusion_matches_jax(port_protocol, jax_protocol, ref):
    occ = port_protocol[3]
    occ_j = jax_protocol[ref][1]
    assert (occ == occ_j).mean() > 0.999
    assert 0 < occ.sum() < occ.size


@pytest.mark.parametrize("ref", ["chunked", "dense"])
def test_chords_match_jax(port_protocol, jax_protocol, ref):
    # Sums over hundreds of chords: float32 sums in another order.
    loss = port_protocol[4]
    np.testing.assert_allclose(loss, jax_protocol[ref][2], rtol=5e-3,
                               atol=5e-2)
    assert float(np.abs(loss).sum()) > 0.0


def obb_scene():
    # tests/test_pallas.py::test_chunk_count_accounts_for_padding's.
    return j_random_scene(jax.random.key(5), num_spheres=0, num_aabbs=0,
                          num_obbs=13_797, num_targets=1)


@pytest.fixture(scope="module")
def forwards(jbig):
    """Scene name -> (JAX scene, JAX jnp forward at FWD)."""
    cfg = jtypes.TraceConfig(**FWD)
    dirs = fibonacci_directions(FWD["ray_count"])
    out = {}
    for name, js in (("big", jbig), ("obb_13797", obb_scene())):
        out[name] = js, j_forward(jnp.zeros(3), dirs, js, cfg, backend="jnp")
    return out


@pytest.mark.parametrize("name", ["big", "obb_13797"])
@pytest.mark.parametrize("backend", ["kernel", "dense"])
def test_forward_matches_jax(forwards, name, backend):
    js, (jr, jsett) = forwards[name]
    scene = scene_from_arrays(jax.tree.map(np.asarray, js), device="cpu")
    dirs = torch.as_tensor(np.array(fibonacci_directions(FWD["ray_count"])))
    r, s = tmodel.forward(torch.zeros(3), dirs, scene,
                          ttypes.TraceConfig(**FWD), backend=backend,
                          device="cpu")
    np.testing.assert_allclose(s.muffle.numpy(), np.asarray(jsett.muffle),
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_array_equal(r.muffle_hits.numpy(),
                                  np.asarray(jr.muffle_hits))
    assert float((r.echo_distances != 0).float().mean()) > 0.0


@pytest.fixture(scope="module")
def jax_grads(jbig):
    """JAX's dense autodiff of tests/test_pallas.py's loss in the
    materials."""
    cfg = jtypes.TraceConfig(**FWD)
    target = jdiff.Loudness(muffle=jnp.full((2,), 0.3),
                            permeation=jnp.full((2,), 0.2),
                            reverb_energy=jnp.asarray(0.05))
    g = jax.grad(jdiff.loudness_loss)(
        jdiff.SceneParams.from_scene(jbig), jbig, jnp.zeros(3),
        fibonacci_directions(FWD["ray_count"]), cfg, target)
    return [np.asarray(x) for x in jax.tree.leaves(g)]


def test_materials_gradients_match_jax(big, jax_grads):
    params = tdiff.SceneParams.from_scene(big)
    leaves = params.leaves()
    for x in leaves:
        x.requires_grad_(True)
    target = tdiff.Loudness(muffle=torch.full((2,), 0.3),
                            permeation=torch.full((2,), 0.2),
                            reverb_energy=torch.tensor(0.05))
    loss = tdiff.loudness_loss(
        params, big, torch.zeros(3),
        torch.as_tensor(np.array(fibonacci_directions(FWD["ray_count"]))),
        ttypes.TraceConfig(**FWD), target, backend="kernel", device="cpu")
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().sum()) > 0 for g in grads)
    for g, ref in zip(grads, jax_grads):
        np.testing.assert_allclose(g.numpy(), ref, **GRAD)
