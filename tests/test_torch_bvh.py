"""B1's bounding-volume hierarchy (``ops/cuda/kernels.py::closest_bvh``,
the tree kernel of ``csrc/closest_hit.cu``).

The CPU tests hold the build: every primitive's world box inside its
leaf's, every node's inside its parent's, inactive rows as empty leaves,
shapes that follow the row counts alone, the ranks a permutation of the
scan indices, no host wait, and no culled winner: the brute-force winner
of ``closest_hit_plain`` (and every primitive tied with it) lies under a
chain of nodes that the kernel's node test, as written here in plain
PyTorch, enters at or before its t. The tests marked ``card`` hold the
tree kernel to the tiled kernel bit for bit in t and rank and skip
without a CUDA device; this file imports nothing of the JAX package, so
on the card they run alone:

    python -m pytest tests/test_torch_bvh.py -m card --noconftest -q
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from audio_raytracer_tpu_torch.models.frame_graph import (
    FrameGraph,
    engine_state,
    launch_counters,
)
from audio_raytracer_tpu_torch.models.raytracer import (
    demo_inputs,
    forward,
    random_scene,
)
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import (
    KernelBackend,
    prepare_fields,
)
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.types import (
    Aabbs,
    Obbs,
    Scene,
    Spheres,
    TraceConfig,
)

CPU = torch.device("cpu")
INF = float("inf")


def with_inactive(scene: Scene, seed: int, share: float = 0.2) -> Scene:
    """``scene`` with a seeded share of each type's primitives inactive."""
    rng = np.random.default_rng(seed)
    parts = {}
    for name in ("spheres", "aabbs", "obbs"):
        p = getattr(scene, name)
        keep = torch.as_tensor(rng.random(p.count) >= share,
                               device=p.active.device)
        parts[name] = dataclasses.replace(p, active=p.active & keep)
    return scene.replace(**parts)


def twice(x):
    """A tensor, or a dataclass of tensors, concatenated with itself."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x])
    return type(x)(*(twice(getattr(x, k.name))
                     for k in dataclasses.fields(x)))


def duplicated(scene: Scene) -> Scene:
    """``scene`` with each type's primitives twice over: every hit has a
    twin at a higher rank with the very same t."""
    parts = {}
    for name in ("spheres", "aabbs", "obbs"):
        p = getattr(scene, name)
        parts[name] = type(p)(*(twice(getattr(p, k.name))
                                for k in dataclasses.fields(p)))
    return scene.replace(**parts)


def edge_scene(device, copies: int = 200) -> Scene:
    """Ties across types and the slab's edge cases: an AABB [0, 1]^3, an
    OBB (identity rotation) [0, 2] x [0, 1] x [0, 1] and a sphere of
    radius 1 at (-1, 0.5, 0.5), all three touching the plane x = 0; an
    OBB turned 90 degrees about z over the AABB; a sphere and a box
    twice; then ``copies`` seeded groups of the same shapes spread over a
    +-40 cube, so that the scene takes the tree."""
    rng = np.random.default_rng(7)
    shift = np.concatenate([np.zeros((1, 3)),
                            rng.uniform(-40, 40, (copies, 3))]
                           ).astype(np.float32)
    s = math.sqrt(0.5)
    sph_c = np.concatenate([shift + [-1.0, 0.5, 0.5],
                            shift + [-1.0, 0.5, 0.5]])
    sph_r = np.ones(len(sph_c), np.float32)
    ab_c = np.concatenate([shift + [0.5, 0.5, 0.5],
                           shift + [0.5, 0.5, 0.5]])
    ab_h = np.full((len(ab_c), 3), 0.5, np.float32)
    ob_c = np.concatenate([shift + [1.0, 0.5, 0.5], shift + [0.5, 0.5, 0.5]])
    ob_h = np.concatenate([np.tile([1.0, 0.5, 0.5], (len(shift), 1)),
                           np.tile([0.5, 0.5, 0.5], (len(shift), 1))])
    ob_q = np.concatenate([np.tile([0.0, 0.0, 0.0, 1.0], (len(shift), 1)),
                           np.tile([0.0, 0.0, s, s], (len(shift), 1))])
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return Scene.build(
        Spheres.build(f(sph_c), sph_r, device=device),
        Aabbs.build(f(ab_c), ab_h, device=device),
        Obbs.build(f(ob_c), f(ob_h), f(ob_q), device=device),
        np.zeros((1, 3), np.float32), device=device)


def edge_rays(device, n: int = 4096):
    """Rays at the edge scene's first group: axis-parallel (signed zero
    components, both signs), from inside each primitive, grazing the
    shared plane x = 0 and the faces y = 0 and y = 1, at the shared face
    from outside, and seeded ones through it; with the first of every
    eight lanes dead."""
    rng = np.random.default_rng(11)
    axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1], [1, -0.0, 0.0],
                     [-0.0, 0.0, -1]], np.float32)
    starts = np.array([[-5, 0.5, 0.5], [0.5, 0.5, 0.5], [1.0, 0.5, 0.5],
                       [-1.0, 0.5, 0.5], [0.0, 0.5, -3.0], [0.0, 0.0, 0.5],
                       [0.0, 1.0, 0.5], [-5, 0.2, 0.3], [0.0, -3.0, 0.5],
                       [0.5, 0.0, -2.0], [2.0, 1.0, 0.5]], np.float32)
    o = [np.repeat(starts, len(axes), 0)]
    d = [np.tile(axes, (len(starts), 1))]
    k = n - len(o[0])
    o.append(rng.uniform(-3, 3, (k, 3)).astype(np.float32))
    d.append(rng.normal(size=(k, 3)).astype(np.float32))
    o, d = np.concatenate(o), np.concatenate(d)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = np.ones(n, bool)
    alive[::8] = False
    t = lambda x: torch.as_tensor(x, device=device).contiguous()  # noqa
    return t(o), t(d.astype(np.float32)), t(alive)


def loop_scene(device) -> Scene:
    """The Sample Scene's 111 colliders as the loop cells lay them out
    (``random_scene(key, 8, 58, 45, num_targets=2)``)."""
    return random_scene(0, 8, 58, 45, num_targets=2, device=device)


def bounce_rays(seed: int, R: int, extent: float, device):
    g = np.random.default_rng(seed)
    o = g.uniform(-extent, extent, (R, 3)).astype(np.float32)
    d = g.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device))


SCENES = {
    "random": lambda dev: random_scene(0, 160, 320, 160, num_targets=2,
                                       extent=30.0, size_range=(0.5, 4.0),
                                       device=dev),
    "inactive": lambda dev: with_inactive(random_scene(
        1, 160, 320, 160, num_targets=2, extent=30.0, device=dev), 3),
    "duplicated": lambda dev: duplicated(random_scene(
        2, 80, 160, 80, num_targets=2, extent=30.0, device=dev)),
    "edge": edge_scene,
}


# ---------------------------------------------------------------------------
# The plain node test and the tree's layout
# ---------------------------------------------------------------------------


def node_boxes(rec: torch.Tensor) -> torch.Tensor:
    """[nodes, 6] (lo xyz, hi xyz) of every node in heap order: the root
    from the header, node j >= 1 from its parent's record."""
    return torch.cat([rec[0:1, :6], rec[1:].reshape(-1, 6)])


def first_leaf(L: int) -> int:
    """The heap index of the tree's first leaf."""
    return L - 1


def parent(j):
    return (j - 1) // 2


def node_entry(box, o, d, w, scale, best):
    """The kernel's ``box_enter`` in plain PyTorch: per ray (o, d [n, 3])
    and box (lo, hi [n, 6]) the entry t and whether the ray enters the box
    widened by its slack at or before ``best``."""
    s = w * (o.abs().amax(-1, keepdim=True) + scale) if w > 0 \
        else torch.zeros_like(o[:, :1])
    inv = K.safe_inv(d)
    # bound x inv - (o +- s) x inv, rounded once as the fma rounds it.
    a = (box[:, :3].double() * inv - ((o + s) * inv).double()).float()
    b = (box[:, 3:].double() * inv - ((o - s) * inv).double()).float()
    neg = inv < 0
    tn = torch.where(neg, b, a).amax(-1)
    tf = torch.where(neg, a, b).amin(-1)
    return tn, (tn <= tf) & (tf >= 0) & (tn <= best)




# ---------------------------------------------------------------------------
# CPU: the build
# ---------------------------------------------------------------------------


def world_boxes(scene: Scene):
    """[P, 6] float64 world boxes in scan order, computed apart from the
    build: sphere centre ± radius, AABB centre ± half extents, the OBB's
    eight corners through the inverse of its table's rotation rows."""
    f = prepare_fields(scene)
    sp = f.sph.double()
    r = sp[:, 3].clamp(min=0).sqrt()[:, None]
    out = [torch.cat([sp[:, :3] - r, sp[:, :3] + r], 1)]
    out.append(f.aabb[:, :6].double())
    ob = f.obb.double()
    minv = torch.linalg.inv(ob[:, 6:15].reshape(-1, 3, 3))
    signs = torch.tensor([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                          for z in (-1, 1)], dtype=torch.float64)
    corners = ob[:, None, :3] + torch.einsum(
        "njk,nck->ncj", minv, signs[None] * ob[:, None, 3:6])
    out.append(torch.cat([corners.amin(1), corners.amax(1)], 1))
    return torch.cat(out), torch.cat([K.active_rows(t) for t in
                                      (f.sph, f.aabb, f.obb)])


@pytest.mark.parametrize("name", list(SCENES))
def test_leaves_hold_their_primitives_and_nodes_their_children(name):
    scene = SCENES[name](CPU)
    fields = prepare_fields(scene)
    boxes, active = world_boxes(scene)
    rec, slots, L = K.closest_bvh(fields)
    nodes = node_boxes(rec).double()
    # Each leaf as the kernel widens it for a ray from the origin, the
    # least slack it takes (none where w is 0: a box of AABBs holds
    # its AABB's own bounds).
    s = float(rec[0, 7]) * float(rec[0, 6])
    leaves = nodes[first_leaf(L):]
    leaf = torch.cat([leaves[:, :3] - s, leaves[:, 3:] + s], 1)
    ranks = slots.long()
    assert torch.equal(ranks[:fields.total].sort().values,
                       torch.arange(fields.total))
    act = active[ranks[:fields.total]]
    mine, theirs = leaf[:fields.total][act], boxes[ranks[:fields.total]][act]
    assert (mine[:, :3] <= theirs[:, :3]).all()
    assert (mine[:, 3:] >= theirs[:, 3:]).all()
    child = torch.arange(1, len(nodes))
    up, kids = nodes[parent(child)], nodes[child]
    empty = (kids[:, :3] > kids[:, 3:]).any(-1)
    assert ((up[:, :3] <= kids[:, :3]).all(-1) | empty).all()
    assert ((up[:, 3:] >= kids[:, 3:]).all(-1) | empty).all()


def test_inactive_rows_are_leaves_never_entered():
    scene = SCENES["inactive"](CPU)
    fields = prepare_fields(scene)
    _, active = world_boxes(scene)
    assert (~active).sum() > 50
    o, d = bounce_rays(3, 512, 30.0, CPU)
    rec, slots, L = K.closest_bvh(fields)
    leaf = node_boxes(rec)[first_leaf(L):]
    for slot, rank in enumerate(slots.tolist()):
        if rank != K.INT_MAX and not active[rank]:
            box = leaf[slot].expand(len(o), 6)
            assert (box[:, :3] == INF).all() and (box[:, 3:] == -INF).all()
            _, entered = node_entry(box, o, d, float(rec[0, 7]),
                                    float(rec[0, 6]), INF)
            assert not entered.any()


def test_shapes_follow_the_row_counts_alone():
    one = prepare_fields(SCENES["random"](CPU))
    two = prepare_fields(with_inactive(random_scene(
        9, 160, 320, 160, num_targets=3, extent=5.0, device=CPU), 4, 0.6))
    def shapes(fields):
        return [(tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                else x for x in K.closest_bvh(fields)]

    assert shapes(one) == shapes(two)


@pytest.mark.parametrize("name", list(SCENES))
def test_the_slots_hold_every_scan_rank_once(name):
    fields = prepare_fields(SCENES[name](CPU))
    slots = K.closest_bvh(fields)[1]
    ranks = slots[slots != K.INT_MAX].sort().values
    assert torch.equal(ranks, torch.arange(fields.total, dtype=torch.int32))


@pytest.mark.parametrize("name", list(SCENES))
def test_no_winner_lies_under_a_culled_node(name):
    """Every primitive whose t equals a ray's brute-force best t (the
    winner and its ties) lies under a chain of nodes, root to leaf, each
    entered by the kernel's node test at or before that t."""
    scene = SCENES[name](CPU)
    fields = prepare_fields(scene)
    if name == "edge":
        o, d, _ = edge_rays(CPU, 1024)
    else:
        o, d = bounce_rays(5, 1024, 30.0, CPU)
    t_win, rank = K.closest_hit_plain(fields, o, d)
    grid = K.closest_grid(fields, o, d)
    ties = (grid == t_win[:, None]) & torch.isfinite(t_win)[:, None]
    assert (ties.sum(1) >= 1).sum() == torch.isfinite(t_win).sum()
    if name == "duplicated":
        assert (ties.sum(1) >= 2).sum() == torch.isfinite(t_win).sum()
    rec, slots, L = K.closest_bvh(fields)
    nodes = node_boxes(rec)
    leaf_of = torch.empty(fields.total, dtype=torch.long)
    leaf_of[slots[:fields.total].long()] = torch.arange(fields.total)
    checked = 0
    for r, p in ties.nonzero().tolist():
        j = first_leaf(L) + int(leaf_of[p])
        chain = [j]
        while j:
            j = parent(j)
            chain.append(j)
        n = len(chain)
        tn, entered = node_entry(nodes[chain], o[r].expand(n, 3),
                                 d[r].expand(n, 3), float(rec[0, 7]),
                                 float(rec[0, 6]), float(t_win[r]))
        assert entered.all(), (r, p, tn, t_win[r])
        checked += 1
    assert checked >= (torch.isfinite(t_win)).sum()


class HostWaits(TorchDispatchMode):
    """Records the ops that wait for the device or copy host data to it:
    a tensor made from host data, a value read back, a selection whose
    size comes from the device."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = name == "aten.index.Tensor" and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        if bool_index or name.split(".")[1] in (
                "lift_fresh", "_local_scalar_dense", "nonzero",
                "masked_select", "item"):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def threshold_scene(seed: int) -> Scene:
    """A scene of ``K.BVH_MIN_ROWS`` rows, the least that B1 walks a tree
    for, a fifth of them inactive."""
    n = K.BVH_MIN_ROWS // 4
    return with_inactive(random_scene(seed, n, 2 * n, n, num_targets=2,
                                      extent=20.0, device=CPU), seed)


def test_the_build_waits_for_nothing():
    scene = threshold_scene(1)
    eng = KernelBackend(scene)
    assert K.takes_bvh(eng.fields)
    with HostWaits() as mode:
        K.closest_bvh(eng.fields)
    assert not mode.seen, mode.seen
    fresh = KernelBackend(scene)
    before = K.host_syncs
    fresh.build_tables([])
    assert K.host_syncs == before
    assert "bvh" in fresh.fields.derived
    assert "closest" not in fresh.fields.derived


def test_the_rule_takes_the_tree_at_the_bake_and_tiles_at_the_sample_scene():
    bake = prepare_fields(random_scene(0, 1024, 2048, 1024, num_targets=8,
                                       extent=60.0, device=CPU))
    assert bake.total == 4096 and K.takes_bvh(bake)
    assert not K.takes_bvh(bake, torch.bfloat16)
    sample = prepare_fields(loop_scene(CPU))
    assert sample.total == 111 and not K.takes_bvh(sample)


def test_the_tree_counter_is_a_launch_counter():
    assert (K.run_closest_hit, "launches_bvh") in launch_counters()


def test_a_refill_builds_the_tree_in_its_span():
    """The frame graph's engine carries the tree (built by
    ``build_tables``, so the warm-up builds nothing lazily), a refill
    copies a new scene's tree in, inside ``art.refill.bvh``."""
    cfg = TraceConfig(ray_count=32, max_bounces=1, num_reverb_bins=8)
    o, d = demo_inputs(cfg, device=CPU)
    fg = FrameGraph(cfg, device=CPU)
    scenes = [threshold_scene(k) for k in range(3)]
    fg(o, d, scenes[0])
    fg(o, d, scenes[1])
    state = engine_state(fg._engine)
    assert any("'bvh'" in k for k in state)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        fg(o, d, scenes[2])
    names = [e.name for e in prof.events()]
    assert "art.refill.bvh" in names
    fresh = KernelBackend(scenes[2])
    fresh.build_tables([])
    (rec, slots, _), (rec2, slots2, _) = (fg._engine.fields.derived["bvh"],
                                          fresh.fields.derived["bvh"])
    assert torch.equal(rec, rec2) and torch.equal(slots, slots2)


def test_the_diagnostic_runs_on_the_card_alone():
    fields = prepare_fields(SCENES["random"](CPU))
    o, d = bounce_rays(0, 8, 30.0, CPU)
    with pytest.raises(ValueError, match="card"):
        K.closest_hit_bvh_visits(fields, o, d)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def same_bits(fields, o, d, alive=None, label=""):
    """The tree kernel (``K._run_tree``, whatever the row count) and the
    tiled kernel (``K._run_tiled``), bit for bit in t and rank, and where
    the rule takes the tree, ``run_closest_hit`` with them; returns the
    diagnostic's visits."""
    before = K.run_closest_hit.launches_bvh
    t, rank = K._run_tree(fields, o, d, alive)
    assert K.run_closest_hit.launches_bvh == before + (o.shape[0] > 0)
    t0, rank0 = K._run_tiled(fields, o, d, alive)
    t1, rank1, visits = K.closest_hit_bvh_visits(fields, o, d, alive)
    got = [(t, rank), (t1, rank1)]
    if K.takes_bvh(fields):
        got.append(K.run_closest_hit(fields, o, d, alive))
    torch.cuda.synchronize()
    for tt, rr in got:
        bad = (tt.view(torch.int32) != t0.view(torch.int32)) | (rr != rank0)
        assert not bad.any(), (label, int(bad.sum()), bad.nonzero()[:4])
    return visits


@pytest.mark.card
@pytest.mark.parametrize("name", list(SCENES) + ["bake"])
def test_the_build_kernels_equal_the_plain_build(name):
    need_card()
    dev = torch.device("cuda")
    scene = random_scene(0, 1024, 2048, 1024, num_targets=8, extent=60.0,
                         size_range=(0.5, 4.0), device=dev) \
        if name == "bake" else SCENES[name](dev)
    fields = prepare_fields(scene)
    rec, slots, L = K.closest_bvh(fields)
    box, codes, w = K.bvh_boxes(fields)
    order = torch.sort(codes, stable=True).indices
    rec0, slots0 = K.bvh_tree(box, order, w)
    torch.cuda.synchronize()
    assert L == K.bvh_leaves(fields.total)
    assert torch.equal(rec.view(torch.int32), rec0.view(torch.int32))
    assert torch.equal(slots, slots0)


@pytest.mark.card
def test_the_tree_equals_the_tiles_on_a_bake_frames_bounces(monkeypatch):
    need_card()
    dev = torch.device("cuda")
    cfg = TraceConfig(ray_count=1 << 20, max_bounces=4, max_ray_life=300.0,
                      max_muffle_hit_distance=250.0, num_reverb_bins=64)
    scene = random_scene(0, 1024, 2048, 1024, num_targets=8, extent=60.0,
                         size_range=(0.5, 4.0), device=dev)
    calls = []
    local = KernelBackend.local_closest

    def spy(self, o, d, alive=None):
        calls.append((self.fields, o.float().contiguous().clone(),
                      d.float().contiguous().clone(),
                      None if alive is None else alive.clone()))
        return local(self, o, d, alive)

    monkeypatch.setattr(KernelBackend, "local_closest", spy)
    origin = torch.tensor([3.0, -2.0, 1.5], device=dev)
    dirs = fibonacci_directions(cfg.ray_count, device=dev)
    forward(origin, dirs, scene, cfg, backend=KernelBackend(scene),
            device=dev)
    monkeypatch.setattr(KernelBackend, "local_closest", local)
    assert len(calls) == 5
    for i, (fields, o, d, alive) in enumerate(calls):
        visits = same_bits(fields, o, d, alive, f"bounce {i}")
        live = alive if alive is not None else torch.ones_like(o[:, 0],
                                                               dtype=bool)
        assert (visits[~live] == 0).all()
        mean = visits[live].float().mean(0)
        # A few dozen nodes and a few primitives a ray, not 4,096.
        assert mean[0] < 400 and mean[1] < 40, mean


@pytest.mark.card
def test_the_tree_equals_the_tiles_at_36002_primitives():
    need_card()
    dev = torch.device("cuda")
    scene = random_scene(11, 12_000, 12_000, 12_000, num_targets=2,
                         extent=120.0, size_range=(0.5, 3.0),
                         target_owned_colliders=True, device=dev)
    fields = prepare_fields(scene)
    assert fields.total == 36_002
    o, d = bounce_rays(2, 65_536, 120.0, dev)
    same_bits(fields, o, d, label="36,002")


@pytest.mark.card
@pytest.mark.parametrize("name", list(SCENES))
def test_the_tree_equals_the_tiles_on_edge_cases(name):
    need_card()
    dev = torch.device("cuda")
    fields = prepare_fields(SCENES[name](dev))
    o, d, alive = edge_rays(dev) if name == "edge" else (
        *bounce_rays(6, 8192, 30.0, dev), None)
    visits = same_bits(fields, o, d, alive, name)
    if alive is not None:
        assert (visits[~alive] == 0).all()


@pytest.mark.card
def test_a_bake_frame_takes_the_tree_and_the_sample_scene_the_tiles():
    need_card()
    dev = torch.device("cuda")
    cfg = TraceConfig(ray_count=1 << 16, max_bounces=4, max_ray_life=300.0,
                      num_reverb_bins=64)
    o, d = demo_inputs(cfg, device=dev)
    bake = random_scene(0, 1024, 2048, 1024, num_targets=8, extent=60.0,
                        size_range=(0.5, 4.0), device=dev)
    fg = FrameGraph(cfg, device=dev)
    for k in range(3):  # the warm-up, the capture, a replay
        before = (K.run_closest_hit.launches, K.run_closest_hit.launches_bvh)
        fg(o, d, bake)
        assert (K.run_closest_hit.launches - before[0],
                K.run_closest_hit.launches_bvh - before[1]) == (5, 5)
    loop = TraceConfig(ray_count=500, max_bounces=4, max_ray_life=125.0,
                       num_reverb_bins=32)
    o, d = demo_inputs(loop, device=dev)
    sample = loop_scene(dev)
    fg = FrameGraph(loop, device=dev)
    for k in range(3):
        before = (K.run_closest_hit.launches, K.run_closest_hit.launches_bvh)
        fg(o, d, sample)
        assert (K.run_closest_hit.launches - before[0],
                K.run_closest_hit.launches_bvh - before[1]) == (5, 0)
