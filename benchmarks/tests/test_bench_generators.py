"""The traffic generators repeat for a seed and differ between seeds."""

import pytest
import torch

from harness import scene

SIZES = dict(spheres=8, aabbs=58, obbs=45, targets=2, extent=30.0,
             size_range=(0.5, 3.0))


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 17, 3_000_000_000,
                                  -5])
def test_layout_repeats_for_a_seed(seed):
    a = scene.random_layout(seed, **SIZES, device="cpu")
    b = scene.random_layout(seed, **SIZES, device="cpu")
    assert same(a, b)
    assert not same(a, scene.random_layout(seed + 1, **SIZES, device="cpu"))


def test_layout_follows_its_distributions():
    lay = scene.random_layout(7, **SIZES, device="cpu")
    assert lay["sph_center"].shape == (8, 3)
    assert lay["aabb_half"].shape == (58, 3)
    assert lay["obb_inv_rot"].shape == (45, 4)
    assert lay["targets"].shape == (2, 3)
    for k in ("sph_center", "aabb_center", "obb_center"):
        assert lay[k].abs().max() <= 30.0
    assert lay["targets"].abs().max() <= 24.0
    for k in ("sph_radius", "aabb_half", "obb_half"):
        assert 0.5 <= lay[k].min() and lay[k].max() <= 3.0
    q = lay["obb_inv_rot"]
    assert torch.allclose(q.norm(dim=-1), torch.ones(45), atol=1e-6)
    for k in ("sph", "aabb", "obb"):
        m = lay[f"{k}_mat"]
        assert (m[:, 0] <= 0.3).all() and (m[:, 1] >= 0.2).all()
        assert (lay[f"{k}_owner"] == -1).all()


def test_listener_path_repeats_and_walks_at_its_speed():
    a = scene.waypoint_path(99, 600, 8, 20.0, 0.1)
    assert torch.equal(a, scene.waypoint_path(99, 600, 8, 20.0, 0.1))
    assert not torch.equal(a, scene.waypoint_path(98, 600, 8, 20.0, 0.1))
    steps = (a[1:] - a[:-1]).norm(dim=-1)
    # At most the step; shorter only where the path turns at a waypoint.
    assert steps.max() <= 0.1 + 1e-5
    assert (steps > 0.09).float().mean() > 0.95
    assert a.abs().max() <= 20.0


def test_mover_walks_its_loop_on_the_fixed_step():
    offsets = [[0, 0, 0], [8, 0, 0], [8, 0, -8], [0, 0, -8]]
    c, moved = scene.mover_centres([1.0, 2.0, 3.0], offsets, 600, 60, 50,
                                   3.0)
    assert (c, moved) == scene.mover_centres([1.0, 2.0, 3.0], offsets, 600,
                                             60, 50, 3.0)
    c = torch.tensor(c)
    assert torch.equal(c[0], torch.tensor([1.0, 2.0, 3.0]))
    # 50 fixed steps a second at 60 ticks: 5 ticks in 6 see a move.
    assert moved[0] and sum(moved[1:]) == 599 * 5 // 6
    # A move is one or (never at 50 Hz under 60) more fixed steps of
    # 3 / 50 m; a tick without one keeps the centre.
    steps = (c[1:] - c[:-1]).norm(dim=-1)
    assert torch.all(steps[~torch.tensor(moved[1:])] == 0)
    assert steps.max() <= 0.06 + 1e-5
    assert (steps[torch.tensor(moved[1:])] > 0.05).float().mean() > 0.95
    # It stays on its square: y fixed, x in [1, 9], z in [-5, 3].
    assert torch.all(c[:, 1] == 2.0)
    assert c[:, 0].min() >= 1.0 - 1e-5 and c[:, 0].max() <= 9.0 + 1e-5
    assert c[:, 2].min() >= -5.0 - 1e-5 and c[:, 2].max() <= 3.0 + 1e-5


def test_fixed_steps_count_the_engines_updates():
    assert scene.fixed_steps(7, 60, 50) == [0, 0, 1, 2, 3, 4, 5]
    assert scene.fixed_steps(4, 60, 60) == [0, 1, 2, 3]
