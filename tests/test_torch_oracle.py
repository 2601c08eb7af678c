"""The port held to the scalar NumPy oracle.

``audio_raytracer_tpu_torch/utils/oracle.py`` is the port's own copy of
the JAX package's ``utils/oracle.py``; the first tests hold the copy to
the original, exactly. The others run the port's ``forward`` with
``collect_debug=True`` on the dense tier and on the kernel backend (the
CUDA kernels' plain versions on the CPU) and hold it to the oracle within
the limits of the JAX runner's ``_oracle_gate``
(``audio_raytracer_tpu/conformance.py:57-139``): echo within rtol 1e-4 /
atol 1e-3 on more than 99.5 % of (ray, bounce) slots, hit counts equal on
more than 99 % of rays, muffle flips within 0.5 % of the slots,
permeation within rtol 1e-4 / atol 1e-2, muffle within rtol 1e-3 / atol
3e-3, reverb strength and volume within rtol 2e-2 / atol 3e-3.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from audio_raytracer_tpu.utils import oracle as j_oracle
from audio_raytracer_tpu_torch.models import raytracer as tmodel
from audio_raytracer_tpu_torch.types import TraceConfig
from audio_raytracer_tpu_torch.utils import oracle as t_oracle

torch.set_num_threads(1)

# Two accumulation batches exercise the permeation overwrite per batch;
# the lower permeation effectiveness keeps the muffle off its clamp at 0.
CFG = TraceConfig(ray_count=256, max_bounces=3, max_ray_life=150.0,
                  num_accum_batches=2, num_reverb_bins=16,
                  permeation_effectiveness=0.25)


def mixed_scene():
    """Spheres, AABBs and OBBs around two targets; AABB 0 encloses target
    0 and is owned by it, so target 0's muffle rays must skip it."""
    sc = tmodel.random_scene(6, num_spheres=6, num_aabbs=8, num_obbs=6,
                             num_targets=2, extent=12.0,
                             size_range=(1.0, 3.5), device="cpu")
    ab = sc.aabbs
    center, tid = ab.center.clone(), ab.target_id.clone()
    center[0], tid[0] = sc.target_positions[0], 0
    return sc.replace(aabbs=dataclasses.replace(ab, center=center,
                                                target_id=tid))


def run_oracle(mod, osc, dirs, cfg):
    """oracle_trace, oracle_permeation and oracle_process of ``mod``."""
    otr = mod.oracle_trace(osc, np.zeros(3), dirs, cfg.max_hits_per_ray,
                           cfg.max_ray_life, cfg.max_muffle_hit_distance,
                           cfg.num_accum_batches)
    operm = mod.oracle_permeation(osc, np.zeros(3), dirs,
                                  cfg.permeation_strength_per_ray,
                                  cfg.num_accum_batches)
    oproc = mod.oracle_process(
        otr["echo"], otr["muffle_hits"], operm, osc.target_positions,
        cfg.ray_count, cfg.max_hits_per_ray, cfg.muffle_effectiveness,
        cfg.permeation_strength_per_ray, cfg.permeation_effectiveness,
        cfg.max_reverb_distance)
    return otr, operm, oproc


@pytest.fixture(scope="module")
def reference():
    """(scene, directions, oracle outputs) of the mixed scene."""
    scene = mixed_scene()
    dirs = tmodel.demo_inputs(CFG, device="cpu")[1]
    osc = t_oracle.from_scene(scene)
    return scene, dirs, run_oracle(t_oracle, osc, dirs.numpy(), CFG)


def test_scene_has_an_owned_collider_that_matters(reference):
    scene, dirs, _ = reference
    assert int((scene.aabbs.target_id == 0).sum()) == 1
    osc = t_oracle.from_scene(scene)
    # Without the skip, target 0 would be muffled by its own collider.
    unowned = dataclasses.replace(osc, aabb_target=np.full_like(
        osc.aabb_target, -1))
    small = TraceConfig(ray_count=32, max_bounces=0)
    d = dirs.numpy()[::8]
    owned = run_oracle(t_oracle, osc, d, small)[0]["muffle_hits"]
    blocked = run_oracle(t_oracle, unowned, d, small)[0]["muffle_hits"]
    assert owned[:, 0].sum() > 0 and blocked[:, 0].sum() == 0


def as_arrays(x):
    """A port scene as numpy arrays in the same structure: what the JAX
    oracle's ``from_scene`` reads (attributes and ``np.asarray``)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return types.SimpleNamespace(**{f.name: as_arrays(getattr(x, f.name))
                                    for f in dataclasses.fields(x)})


@pytest.fixture(scope="module")
def scene_pair():
    """(numpy arrays, the port's Scene) of one scene with padding and
    target-owned colliders."""
    sc = tmodel.random_scene(4, num_spheres=5, num_aabbs=6, num_obbs=5,
                             num_targets=2, extent=10.0,
                             size_range=(1.0, 3.0),
                             target_owned_colliders=True, device="cpu")
    active = sc.obbs.active.clone()
    active[1] = False  # a padding entry that from_scene must drop
    sc = sc.replace(obbs=dataclasses.replace(sc.obbs, active=active))
    return as_arrays(sc), sc


def test_from_scene_matches_the_jax_oracle(scene_pair):
    arrays, scene = scene_pair
    ours = t_oracle.from_scene(scene)
    theirs = j_oracle.from_scene(arrays)
    for f in dataclasses.fields(t_oracle.OracleScene):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert len(ours.obb_center) == scene.obbs.count - 1


def test_oracle_copy_matches_the_jax_oracle_exactly(scene_pair):
    arrays, _ = scene_pair
    osc = j_oracle.from_scene(arrays)
    ours = t_oracle.OracleScene(**dataclasses.asdict(osc))
    cfg = TraceConfig(ray_count=48, max_bounces=2, max_ray_life=100.0,
                      num_accum_batches=2)
    dirs = tmodel.demo_inputs(cfg, device="cpu")[1].numpy()
    got = run_oracle(t_oracle, ours, dirs, cfg)
    want = run_oracle(j_oracle, osc, dirs, cfg)
    for part_got, part_want in zip(got, want):
        if isinstance(part_got, dict):
            assert part_got.keys() == part_want.keys()
            for k in part_got:
                np.testing.assert_array_equal(part_got[k], part_want[k],
                                              err_msg=k)
        else:
            np.testing.assert_array_equal(part_got, part_want)
    assert got[0]["hit_counts"].sum() > 0 and got[0]["echo"].any()


@pytest.mark.parametrize("backend", ["dense", "kernel"])
def test_forward_matches_the_oracle(reference, backend):
    scene, dirs, (otr, operm, oproc) = reference
    result, settings = tmodel.forward(torch.zeros(3), dirs, scene, CFG,
                                      collect_debug=True, backend=backend,
                                      device="cpu")
    echo = result.echo_distances.numpy().astype(np.float64)
    match = np.isclose(echo, otr["echo"], rtol=1e-4, atol=1e-3)
    assert match.mean() > 0.995, 1 - match.mean()
    hc = result.hit_counts.numpy() == otr["hit_counts"]
    assert hc.mean() > 0.99, 1 - hc.mean()
    budget = max(1, int(0.005 * CFG.ray_count * CFG.max_hits_per_ray))
    flips = np.abs(result.muffle_hits.numpy().astype(np.int64)
                   - otr["muffle_hits"]).sum()
    assert flips <= budget
    np.testing.assert_allclose(result.permeation.numpy(), operm, rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(settings.muffle.numpy(), oproc["muffle"],
                               rtol=1e-3, atol=3e-3)
    for k in ("reverb_strength", "reverb_volume"):
        np.testing.assert_allclose(float(getattr(settings, k)), oproc[k],
                                   rtol=2e-2, atol=3e-3)
    # The scene exercises every path the gates read.
    assert otr["hit_counts"].max() == CFG.max_hits_per_ray
    assert (otr["muffle_hits"] > 0).all()
    assert (operm < CFG.ray_count).sum() >= 3  # chords with a loss
    assert ((oproc["muffle"] > 0) & (oproc["muffle"] < 1)).all()
