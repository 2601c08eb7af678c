"""The frozen reference against the program's plain tiers on the CPU, at
small sizes: the dense tier's forward and the scalar NumPy oracle."""

import numpy as np
import pytest
import torch

from harness import scene
from reference import frame as reference

CFG = dict(ray_count=500, max_bounces=4, max_ray_life=125.0,
           max_muffle_hit_distance=250.0, muffle_effectiveness=1.0,
           permeation_effectiveness=0.5, permeation_strength_per_ray=1.0,
           max_reverb_distance=35.0, num_accum_batches=1, epsilon=1e-4,
           num_reverb_bins=32, ir_max_distance=125.0)


def owned(layout: dict) -> dict:
    """The layout with its first two spheres owned by targets 0 and 1
    and moved onto them (the skip path)."""
    out = dict(layout)
    out["sph_owner"] = layout["sph_owner"].clone()
    out["sph_owner"][:2] = torch.tensor([0, 1])
    c = layout["sph_center"].clone()
    c[:2] = layout["targets"][:2]
    out["sph_center"] = c
    return out


def port_forward(layout, origin, cfg):
    from audio_raytracer_tpu_torch.models.raytracer import forward
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu_torch.types import TraceConfig

    tc = TraceConfig(**cfg)
    return forward(torch.as_tensor(origin), fibonacci_directions(
        tc.ray_count, device="cpu"), scene.port_scene(layout), tc,
        backend="dense", device="cpu")


@pytest.mark.parametrize("seed,batches,own", [(11, 1, False), (12, 4, True),
                                              (13, 3, True)])
def test_reference_agrees_with_the_dense_tier(seed, batches, own):
    lay = scene.random_layout(seed, 8, 58, 45, 2, 30.0, (0.5, 3.0), "cpu")
    lay = owned(lay) if own else lay
    cfg = dict(CFG, num_accum_batches=batches)
    origin = [1.0, 2.0, -3.0]
    res, st = port_forward(lay, origin, cfg)
    ref = reference.frame(lay, origin, cfg, "cpu")
    # The kernel-vs-dense limits of the program's own card checks: the
    # tiers round their ray tests differently, so a grazing ray may
    # decide otherwise.
    match = torch.isclose(res.echo_distances, ref["echo_distances"],
                          rtol=1e-4, atol=1e-3).float().mean()
    assert float(match) > 0.995
    torch.testing.assert_close(st.muffle, ref["muffle"], rtol=1e-3,
                               atol=5e-3)
    torch.testing.assert_close(st.reverb_volume, ref["reverb_volume"],
                               rtol=1e-3, atol=2e-3)
    torch.testing.assert_close(st.reverb_strength, ref["reverb_strength"],
                               rtol=1e-2, atol=2e-3)
    torch.testing.assert_close(res.permeation, ref["permeation"],
                               rtol=1e-4, atol=1e-2)
    assert torch.equal(st.perceived_position, ref["perceived_position"])
    top = ref["reverb_ir"].abs().max()
    assert float((res.reverb_ir - ref["reverb_ir"]).abs().max() / top) < 0.05


def test_reference_agrees_with_the_scalar_oracle():
    from audio_raytracer_tpu_torch.utils import oracle

    lay = owned(scene.random_layout(21, 4, 6, 5, 2, 10.0, (0.5, 2.0),
                                    "cpu"))
    cfg = dict(CFG, ray_count=64, num_accum_batches=2)
    origin = np.array([0.5, -1.0, 0.25])
    ref = reference.frame(lay, origin, cfg, "cpu")
    osc = oracle.from_scene(scene.port_scene(lay))
    dirs = reference.fibonacci_directions(64, "cpu").double().numpy()
    tr = oracle.oracle_trace(osc, origin, dirs, 5, 125.0, 250.0, 2)
    perm = oracle.oracle_permeation(osc, origin, dirs, 1.0, 2)
    assert np.array_equal(tr["muffle_hits"], ref["muffle_hits"].numpy())
    np.testing.assert_allclose(ref["echo_distances"].numpy(), tr["echo"],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ref["permeation"].numpy(), perm, rtol=1e-5,
                               atol=1e-3)
    pr = oracle.oracle_process(tr["echo"], tr["muffle_hits"], perm,
                               osc.target_positions, 64, 5, 1.0, 1.0, 0.5,
                               35.0)
    np.testing.assert_allclose(ref["muffle"].numpy(), pr["muffle"],
                               atol=1e-5)
    assert float(ref["reverb_volume"]) == pytest.approx(pr["reverb_volume"],
                                                        abs=1e-6)
    assert float(ref["reverb_strength"]) == pytest.approx(
        pr["reverb_strength"], rel=1e-5)


def test_counts_follow_the_trace():
    lay = scene.random_layout(5, 8, 58, 45, 2, 30.0, (0.5, 3.0), "cpu")
    ref = reference.frame(lay, [0.0, 0.0, 0.0], dict(CFG, ray_count=200),
                          "cpu")
    c = ref["counts"]
    assert c["alive"][0] == 200
    hits = (ref["echo_distances"] != 0).sum(0)
    for k in range(5):
        assert c["live"][k] <= c["alive"][k]
        # Every live hit opens the echo set and at most T muffle sets.
        assert c["live"][k] <= c["open_pairs"][k] <= 3 * c["live"][k]
        assert int(hits[k]) <= c["live"][k]
        if k:
            assert c["alive"][k] <= c["live"][k - 1]
