"""The port at the reference's 26-hit depth, against the JAX package.

tests/test_forward_parity.py::test_max_bounce_depth_26_hits on the port:
its scene (key 3; 4 / 10 / 4 primitives, 2 targets) and config (64
rays, ``max_bounces=25``, life 500, 2 accumulation batches), the
inspector's cap (Audio/AudioRayTracer.cs:11-15). The port's ``dense``
and ``kernel`` engines (the kernels' plain versions on the CPU) go
against JAX's ``jnp`` tier and the kernel engine also against
``pallas_interpret``, with that test's tolerances. At this depth a frame
runs B1 and B2 26 times: the kernel engine with ``compact_rays``,
ordered and unordered, is held to itself uncompacted with the invariants
of tests/test_torch_compaction.py, and one materials gradient of the
kernel engine to JAX's dense autodiff with tests/test_torch_train.py's
tolerance.
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
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch import types as ttypes
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.models import differentiable as tdiff
from audio_raytracer_tpu_torch.models import raytracer as tmodel
from audio_raytracer_tpu_torch.ops.cuda import kernels as K

torch.set_num_threads(1)

R = 64
CFG = dict(ray_count=R, max_bounces=25, max_ray_life=500.0,
           num_accum_batches=2)
H = 26
GRAD = dict(rtol=2e-4, atol=2e-6)


def room():
    """A closed room (six walls, a pillar, a sphere; absorption 0.02),
    where nearly half the rays bounce to the 26th hit: the reference's
    scene above sends most rays out of the scene within a few bounces."""
    centers = [[0, -2, 0], [0, 8, 0], [20, 3, 0], [-20, 3, 0], [0, 3, 20],
               [0, 3, -20], [0, 3, 6], [-8, 1, -9]]
    halves = [[20, .5, 20], [20, .5, 20], [.5, 6, 20], [.5, 6, 20],
              [20, 6, .5], [20, 6, .5], [8, 6, 1.5], [1.5, 3, 1.5]]
    n = len(centers)
    material = jtypes.Materials(absorption=jnp.full((n,), 0.02),
                                density=jnp.full((n,), 0.02),
                                echo=jnp.ones((n,)))
    aabbs = jtypes.Aabbs.build(jnp.asarray(centers, jnp.float32),
                               jnp.asarray(halves, jnp.float32),
                               material=material)
    spheres = jtypes.Spheres.build(jnp.asarray([[5.0, 2.0, -5.0]]),
                                   jnp.asarray([1.5]))
    return jtypes.Scene.build(spheres, aabbs, None, jnp.asarray(
        [[0.0, 2.0, 10.0], [10.0, 1.0, -12.0]]))


SCENES = {
    # tests/test_forward_parity.py::test_max_bounce_depth_26_hits's.
    "reference": lambda: j_random_scene(jax.random.key(3), num_spheres=4,
                                        num_aabbs=10, num_obbs=4,
                                        num_targets=2),
    "room": room,
}
ORIGINS = {"reference": [0.0, 0.0, 0.0], "room": [1.0, 1.0, -3.0]}


@pytest.fixture(scope="module")
def jscenes():
    return {name: make() for name, make in SCENES.items()}


@pytest.fixture(scope="module")
def scenes(jscenes):
    return {name: scene_from_arrays(jax.tree.map(np.asarray, js),
                                    device="cpu")
            for name, js in jscenes.items()}


@pytest.fixture(scope="module")
def dirs():
    return np.array(fibonacci_directions(R))


@pytest.fixture(scope="module")
def jax_runs(jscenes, dirs):
    """(scene, JAX backend) -> (TraceResult, TargetSettings), each made
    once."""
    runs = {}

    def get(name, backend):
        if (name, backend) not in runs:
            cfg = jtypes.TraceConfig(**CFG)
            assert cfg.max_hits_per_ray == H
            runs[name, backend] = j_forward(
                jnp.asarray(ORIGINS[name]), jnp.asarray(dirs), jscenes[name],
                cfg, collect_debug=backend == "jnp", backend=backend)
        return runs[name, backend]

    return get


def port(scenes, name, dirs, backend, collect_debug=False, **cfg):
    return tmodel.forward(torch.tensor(ORIGINS[name]), torch.as_tensor(dirs),
                          scenes[name], ttypes.TraceConfig(**{**CFG, **cfg}),
                          collect_debug=collect_debug, backend=backend,
                          device="cpu")


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("backend,jax_backend", [
    ("dense", "jnp"), ("kernel", "jnp"), ("kernel", "pallas_interpret")])
def test_26_hits_match_jax(scenes, dirs, jax_runs, name, backend,
                           jax_backend, monkeypatch):
    launches = []
    run = K.run_closest_hit
    monkeypatch.setattr(K, "run_closest_hit",
                        lambda *a, **kw: launches.append(1) or run(*a, **kw))
    r, s = port(scenes, name, dirs, backend)
    jr, js = jax_runs(name, jax_backend)
    assert tuple(r.echo_distances.shape) == (R, H)
    assert len(launches) == (H if backend == "kernel" else 0)
    for x in (s.muffle, s.reverb_strength, s.reverb_volume):
        assert bool(torch.isfinite(x).all())
    np.testing.assert_array_equal(r.muffle_hits.numpy(),
                                  np.asarray(jr.muffle_hits))
    np.testing.assert_allclose(s.muffle.numpy(), np.asarray(js.muffle),
                               rtol=1e-4, atol=1e-4)


def test_the_room_uses_the_depth(scenes, dirs, jax_runs):
    # Nearly half the rays of the room reach the 26th hit (29 of 64),
    # the others end early, and each ray's hit count and echoes are
    # JAX's.
    r, _ = port(scenes, "room", dirs, "kernel", collect_debug=True)
    jr, _ = jax_runs("room", "jnp")
    counts = r.hit_counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(jr.hit_counts))
    assert float((counts == H).mean()) > 0.4 and counts.min() < H
    np.testing.assert_allclose(r.echo_distances.numpy(),
                               np.asarray(jr.echo_distances), rtol=1e-4,
                               atol=1e-3)


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("unordered", [False, True])
def test_compaction_at_26_hits(scenes, dirs, name, unordered):
    # Ordered: the reorder is invisible. Unordered: echo rows permuted
    # within each bounce column, every reduction as in the ordered tier.
    debug = not unordered
    r_p, s_p = port(scenes, name, dirs, "kernel", collect_debug=debug)
    r_c, s_c = port(scenes, name, dirs, "kernel", collect_debug=debug,
                    compact_rays=True, compact_unordered=unordered)
    assert torch.equal(r_p.muffle_hits, r_c.muffle_hits)
    close(r_p.first_hit_t, r_c.first_hit_t)
    close(s_p.muffle, s_c.muffle)
    close(s_p.reverb_volume, s_c.reverb_volume)
    e_p = r_p.echo_distances.numpy().astype(np.float64)
    e_c = r_c.echo_distances.numpy().astype(np.float64)
    if unordered:
        close(np.sort(e_p, axis=0), np.sort(e_c, axis=0))
        close(e_p.sum(), e_c.sum(), rtol=1e-5)
    else:
        assert torch.equal(r_p.hit_counts, r_c.hit_counts)
        close(e_p, e_c)
        close(r_p.hit_points, r_c.hit_points)


@pytest.fixture(scope="module")
def jax_material_grads(jscenes, dirs):
    """JAX's dense autodiff of the loss in the materials at 26 hits."""
    cfg = jtypes.TraceConfig(**CFG)
    jscene = jscenes["reference"]
    params = jdiff.SceneParams.from_scene(jscene)
    target = jdiff.Loudness(muffle=jnp.full((2,), 0.4),
                            permeation=jnp.full((2,), 0.3),
                            reverb_energy=jnp.asarray(0.1))
    loss, g = jax.value_and_grad(jdiff.loudness_loss)(
        params, jscene, jnp.zeros(3), jnp.asarray(dirs), cfg, target)
    return float(loss), jax.tree.map(np.asarray, jax.tree.leaves(g))


def test_materials_gradient_at_26_hits(scenes, dirs, jax_material_grads):
    scene = scenes["reference"]
    params = tdiff.SceneParams.from_scene(scene)
    leaves = params.leaves()
    for x in leaves:
        x.requires_grad_(True)
    target = tdiff.Loudness(muffle=torch.full((2,), 0.4),
                            permeation=torch.full((2,), 0.3),
                            reverb_energy=torch.tensor(0.1))
    loss = tdiff.loudness_loss(params, scene, torch.zeros(3),
                               torch.as_tensor(dirs),
                               ttypes.TraceConfig(**CFG), target,
                               backend="kernel", device="cpu")
    grads = torch.autograd.grad(loss, leaves)
    jloss, jgrads = jax_material_grads
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    assert len(grads) == len(jgrads) == 9
    assert sum(float(g.abs().sum()) for g in grads) > 0.0
    for g, ref in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), ref, **GRAD)


def test_compaction_skips_dead_lanes_at_depth(scenes, dirs, monkeypatch):
    # With compact_rays every bounce after the first hands B1 its rays
    # alive-first: the alive mask it sees is a prefix.
    seen = []
    run = K.run_closest_hit

    def spy(fields, o, d, alive=None, *a, **kw):
        if alive is not None:
            seen.append(alive.clone())
        return run(fields, o, d, alive, *a, **kw)

    monkeypatch.setattr(K, "run_closest_hit", spy)
    port(scenes, "room", dirs, "kernel", compact_rays=True)
    assert len(seen) == H
    for alive in seen[1:]:
        n = int(alive.sum())
        assert bool(alive[:n].all()) and not bool(alive[n:].any())
    assert int(seen[-1].sum()) < int(seen[1].sum())

