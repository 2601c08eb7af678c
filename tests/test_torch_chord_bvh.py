"""B3 through B1's tree (``ops/cuda/fused.py::takes_chord_bvh``, the tree
kernel ``multi_chord_kernel<S, COUNT>`` of ``csrc/multi_chord.cu``).

The CPU tests hold the rule (the tree at the materials step's shape, the
tiles or the split at one ray, at the Sample Scene's 111 rows and in the
bfloat16 tier), the launch counter, and no culled crossing: on first-hit
offset points toward several target sets, every primitive whose chord is
positive and not skipped lies under a chain of nodes, root to leaf, each
entered by the kernel's node test with no upper t (``node_entry`` of
``test_torch_bvh.py`` at t = +inf). The tests marked ``card`` hold the
tree kernel to the tiled kernel bit for bit on every ray and set, and a
captured materials step on the tree to one on the tiles; they skip
without a CUDA device. This file imports nothing of the JAX package, so
on the card they run alone:

    python -m pytest tests/test_torch_chord_bvh.py -m card --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_bvh import (
    SCENES,
    bounce_rays,
    edge_rays,
    first_leaf,
    loop_scene,
    node_boxes,
    node_entry,
    parent,
)

from audio_raytracer_tpu_torch.models import differentiable as D
from audio_raytracer_tpu_torch.models.frame_graph import launch_counters
from audio_raytracer_tpu_torch.models.raytracer import random_scene
from audio_raytracer_tpu_torch.ops import intersect
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import prepare_fields
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.types import TraceConfig

CPU = torch.device("cpu")
INF = float("inf")
EPS = 1e-4  # TraceConfig.epsilon: the offset of a first hit's point


def bake_scene(device):
    """The bake's and the materials step's level: 4,096 rows, 8 targets."""
    return random_scene(0, 1024, 2048, 1024, num_targets=8, extent=60.0,
                        size_range=(0.5, 4.0), device=device)


def offset_points(fields, o, d):
    """The loudness map's permeation origins: each ray's first hit backed
    off by EPS along the ray (the ray's origin, so backed off, where it
    misses)."""
    t, _ = K.run_closest_hit(fields, o, d)
    t = torch.where(torch.isfinite(t), t, 0.0)
    return ((o + d * t[:, None]) - d * EPS).contiguous()


def toward(points, off):
    """The unit directions from each offset point to each point."""
    out = []
    for p in points:
        v = p - off
        out.append((v / intersect.safe_norm(v)[:, None]).contiguous())
    return out


def chord_sets(scene, fields, o, d, extra: int = 2, seed: int = 0):
    """(offset points, directions, skips) of first-hit-like permeation
    rays: toward each of the scene's targets (skipping the colliders it
    owns), toward ``extra`` seeded points (skipping none), and along the
    rays themselves (their signed zeros and grazes kept)."""
    off = offset_points(fields, o, d)
    g = np.random.default_rng(seed)
    ext = float(off.abs().amax())
    pts = torch.as_tensor(g.uniform(-ext, ext, (extra, 3)).astype(np.float32),
                          device=off.device)
    targets = scene.target_positions.to(off.device)
    dirs = toward(list(targets) + list(pts), off) + [d.contiguous()]
    skips = tuple(range(len(targets))) + (NO_SKIP,) * (extra + 1)
    return off, dirs, skips


# ---------------------------------------------------------------------------
# CPU: the rule, the counter
# ---------------------------------------------------------------------------


def test_the_rule_takes_the_tree_at_the_materials_shape():
    bake = prepare_fields(bake_scene(CPU))
    R = 1 << 20
    assert bake.total == 4096 and F.takes_chord_bvh(bake, R)
    assert F.takes_chord_bvh(bake, F.CHORD_BVH_MIN_RAYS)
    assert not F.takes_chord_bvh(bake, F.CHORD_BVH_MIN_RAYS - 1)
    # The forward frame's one ray a permeation batch keeps the split
    # kernel, the bfloat16 tier its tiles, the Sample Scene its tiles.
    assert not F.takes_chord_bvh(bake, 1)
    assert F.chord_splits(1, bake.total, 132) == (1, F.MAX_CLUSTER)
    assert not F.takes_chord_bvh(bake, R, torch.bfloat16)
    sample = prepare_fields(loop_scene(CPU))
    assert sample.total == 111 and not F.takes_chord_bvh(sample, R)


def test_the_tree_counter_is_a_launch_counter():
    assert (F.run_multi_chord, "launches_bvh") in launch_counters()


def test_the_diagnostic_runs_on_the_card_alone():
    fields = prepare_fields(SCENES["random"](CPU))
    o, d = bounce_rays(0, 8, 30.0, CPU)
    with pytest.raises(ValueError, match="card"):
        F.multi_chord_bvh_visits(fields, o, [d], (NO_SKIP,))


# ---------------------------------------------------------------------------
# CPU: no culled crossing
# ---------------------------------------------------------------------------


def crossing_grid(fields, o, d, skip):
    """[R, P] bool in scan order: the chord of primitive p along the
    unbounded ray r is positive and valid and p is not owned by ``skip``
    (B3's row tests, ``fused.multi_chord_plain``'s arithmetic)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    cols = []
    sph = fields.sph
    c = F._sphere_chord(*F._sphere_oc(sph, ox, oy, oz), dx, dy, dz)
    cols.append(c["hit"] & (c["t_exit"] >= 0.0) & (c["chord"] > 0.0)
                & (K.ids(sph, K.S_TGT) != skip))
    for kind, tab, miss, tcol in (("aabb", fields.aabb, K.A_MISS, K.A_TGT),
                                  ("obb", fields.obb, K.O_MISS, K.O_TGT)):
        terms = K.box_terms(fields, kind, ox, oy, oz)
        inv = K.box_inv_dirs(fields, kind, dx, dy, dz)
        *_, chord, meet = F._box_chord(terms, inv)
        cols.append(meet & (chord > 0.0) & (K.ids(tab, tcol) != skip)
                    & (tab[:, miss] == 0.0))
    return torch.cat(cols, 1)


@pytest.mark.parametrize("name", list(SCENES))
def test_no_crossing_lies_under_a_culled_node(name):
    """Every (ray, set, primitive) with a positive chord that is not
    skipped lies under a chain of nodes, root to leaf, each entered by the
    kernel's node test with no upper t, so the unbounded walk reaches its
    leaf and adds its term."""
    scene = SCENES[name](CPU)
    fields = prepare_fields(scene)
    if name == "edge":
        o, d, _ = edge_rays(CPU, 1024)
    else:
        o, d = bounce_rays(5, 1024, 30.0, CPU)
    off, dirs, skips = chord_sets(scene, fields, o, d)
    rec, slots, L = K.closest_bvh(fields)
    nodes = node_boxes(rec)
    w, scale = float(rec[0, 7]), float(rec[0, 6])
    leaf_of = torch.empty(fields.total, dtype=torch.long)
    leaf_of[slots[:fields.total].long()] = torch.arange(fields.total)
    depth = L.bit_length() - 1
    checked = 0
    for dd, skip in zip(dirs, skips):
        pairs = crossing_grid(fields, off, dd, skip).nonzero()
        r, p = pairs[:, 0], pairs[:, 1]
        chain = [first_leaf(L) + leaf_of[p]]
        for _ in range(depth):
            chain.append(parent(chain[-1]))
        chain = torch.stack(chain, 1)  # [pairs, depth + 1], leaf to root
        assert (chain[:, -1] == 0).all()
        n = chain.shape[1]
        _, entered = node_entry(nodes[chain.reshape(-1)],
                                off[r].repeat_interleave(n, 0),
                                dd[r].repeat_interleave(n, 0), w, scale, INF)
        bad = ~entered.view(-1, n).all(1)
        assert not bad.any(), (name, skip, pairs[bad][:4])
        checked += len(pairs)
    # Every ray crosses something on average: the check is not vacuous.
    assert checked >= len(o), checked


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def tiled(fields, o, dirs, skips):
    """B3's tiled kernel, one thread per ray over every row in scan order
    (``chord_splits``' (BLOCK, 1)), whatever the shapes."""
    lib, R = F.build.load("multi_chord"), o.shape[0]
    parts = []
    for g in F.set_groups(len(dirs)):
        out = torch.empty((R, g.stop - g.start), device=o.device)
        F.launch_multi_chord(lib, fields, o, F._stack_dirs(dirs[g]),
                             skips[g], out, (F.BLOCK, 1))
        parts.append(out)
    return torch.cat(parts, 1)


def same_bits(fields, o, dirs, skips, label=""):
    """The tree kernel (the diagnostic's launch, whatever the shapes) and
    the tiled kernel bit for bit on every ray and set, and where the rule
    takes the tree, ``run_multi_chord`` with them; returns the visits."""
    want = tiled(fields, o, dirs, skips)
    got, visits = F.multi_chord_bvh_visits(fields, o, dirs, skips)
    outs = [got]
    if F.takes_chord_bvh(fields, o.shape[0]):
        before = F.run_multi_chord.launches_bvh
        outs.append(F.run_multi_chord(fields, o, dirs, skips))
        assert F.run_multi_chord.launches_bvh - before == \
            len(F.set_groups(len(dirs)))
    torch.cuda.synchronize()
    for out in outs:
        bad = out.view(torch.int32) != want.view(torch.int32)
        assert not bad.any(), (label, int(bad.sum()), bad.nonzero()[:4],
                               out[bad][:4], want[bad][:4])
    return visits


@pytest.mark.card
def test_the_tree_equals_the_tiles_at_the_materials_shape():
    need_card()
    dev = torch.device("cuda")
    scene = bake_scene(dev)
    fields = prepare_fields(scene)
    o = torch.tensor([3.0, -2.0, 1.5], device=dev).expand(1 << 20, 3)
    d = fibonacci_directions(1 << 20, device=dev)
    off = offset_points(fields, o.contiguous(), d)
    dirs = toward(list(scene.target_positions), off)
    assert len(dirs) == 8 and F.takes_chord_bvh(fields, off.shape[0])
    visits = same_bits(fields, off, dirs, tuple(range(8)), "materials")
    mean = visits.float().mean((0, 1))
    # Tens of nodes, a few rows and terms a (ray, set), not 4,096 rows.
    assert mean[0] < 1000 and mean[1] < 64 and mean[2] < 16, mean
    assert (visits[..., 2] <= visits[..., 1]).all()


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
    off, dirs, skips = chord_sets(scene, fields, o, d)
    visits = same_bits(fields, off, dirs, skips, "36,002")
    # Dense crossings overflow the list: the further walks are exact too.
    assert visits[..., 3].any()


@pytest.mark.card
@pytest.mark.parametrize("name", list(SCENES))
def test_the_tree_equals_the_tiles_on_edge_cases(name):
    """Rays from inside primitives, grazing shared faces, along axes with
    signed zero components (the 1e-12 nudge), inactive rows and owned
    primitives skipped, and twins at equal ranks' terms."""
    need_card()
    dev = torch.device("cuda")
    scene = SCENES[name](dev)
    fields = prepare_fields(scene)
    o, d = edge_rays(dev)[:2] if name == "edge" else bounce_rays(
        6, 8192, 30.0, dev)
    off, dirs, skips = chord_sets(scene, fields, o, d, extra=3)
    # The rays' own origins too: inside and on the primitives' faces.
    dirs.append(d.contiguous())
    skips += (0,)
    same_bits(fields, off, dirs, skips, f"{name} offsets")
    same_bits(fields, o.contiguous(), dirs, skips, f"{name} origins")


def materials_steps(monkeypatch, min_rays, n=3):
    """Three materials steps of a StepGraph (the warm-up, the capture, a
    replay), each from the same tensors, on the bake's level at 262,144
    rays (where the tiles run one thread a ray, ``chord_splits``' (BLOCK,
    1)), with B3's tree rule at ``min_rays``: per step B3's own output
    inside the step, the loss, the map (no impulse response: its
    ``index_add_`` adds in another order each run), the gradients and the
    tensors after it; and B3's tree launches."""
    dev = torch.device("cuda")
    monkeypatch.setattr(F, "CHORD_BVH_MIN_RAYS", min_rays)
    # B3's output, kept by a copy that the capture records, so every
    # replay refreshes it.
    b3 = []
    for name in ("launch_chord_bvh", "launch_multi_chord"):
        def spy(lib, fields, o, stacked, skips, out, *a,
                launch=getattr(F, name)):
            launch(lib, fields, o, stacked, skips, out, *a)
            b3.append(out.clone())

        monkeypatch.setattr(F, name, spy)
    cfg = TraceConfig(ray_count=1 << 18, max_bounces=4, max_ray_life=300.0,
                      max_muffle_hit_distance=250.0, num_reverb_bins=0)
    scene = bake_scene(dev)
    dirs = fibonacci_directions(cfg.ray_count, device=dev)
    origin = torch.tensor([3.0, -2.0, 1.5], device=dev)
    with torch.no_grad():
        target = D.loudness_map(torch.tensor([-4.0, 5.0, 2.0], device=dev),
                                dirs, scene, cfg, device=dev)
    params = D.SceneParams.from_scene(scene)
    params = dataclasses.replace(params, **{
        k: dataclasses.replace(m, density=m.density * 0.6)
        for k, m in (("sphere", params.sphere), ("aabb", params.aabb),
                     ("obb", params.obb))})
    step, init = D.make_train_step(cfg, optimizer=D.adam(1e-2), device=dev,
                                   return_map=True)
    assert step.__class__.__name__ == "StepGraph"
    opt = init(params)
    leaves = params.leaves()
    start = [x.detach().clone() for x in leaves]
    before = F.run_multi_chord.launches_bvh
    exact, close = [], []
    for _ in range(n):
        # Each step from the same tensors: an update carries the last
        # bits of its gradients into the next step's densities.
        with torch.no_grad():
            for x, x0 in zip(leaves, start):
                x.copy_(x0)
        b3.clear()  # the target's map, or the last call's
        _, _, loss, pred = step(params, opt, scene, origin, dirs, target)
        keep = b3[-1] if b3 else keep
        exact.append([keep.clone(), loss.clone()]
                     + [getattr(pred, f).clone() for f in
                        ("muffle", "permeation", "reverb_energy")])
        close.append([x.grad.clone() for x in leaves]
                     + [x.detach().clone() for x in leaves])
    torch.cuda.synchronize()
    return exact, close, F.run_multi_chord.launches_bvh - before


@pytest.mark.card
def test_a_captured_materials_step_on_the_tree_equals_one_on_the_tiles(
        monkeypatch):
    """B3's output inside the step, the loss and the map bit for bit. The
    gradients and the tensors after Adam are not: B4's atomicAdd across
    spans and autograd's accumulating index backward add the same inputs
    in another order each run. So the tiles run twice, and at each step
    the tree's gap to either tiles run may be at most four times the
    largest gap between the two tiles runs at any step (a step's tensors
    after Adam hang on the steps before it, so only like steps are
    compared), with a floor of 2^-20 of the tensor's largest where the
    tiles happened to agree with themselves: a fault of the tree would
    stand far above that."""
    need_card()
    tree, tree_g, n_tree = materials_steps(monkeypatch, 1)
    tiles, tiles_g, n_tiles = materials_steps(monkeypatch, 1 << 30)
    again, again_g, n_again = materials_steps(monkeypatch, 1 << 30)
    assert (n_tree, n_tiles, n_again) == (3, 0, 0)
    assert tree[0][0].shape == (1 << 18, 8)
    for k, (a, b) in enumerate(zip(tree, tiles)):
        for i, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), \
                (k, i)

    def apart(x, y):
        return float((x - y).abs().max())

    for i in range(len(tiles_g[0])):
        steps = list(zip(tree_g, tiles_g, again_g))
        spread = max(apart(b[i], c[i]) for _, b, c in steps)
        scale = max(float(b[i].abs().max()) for _, b, _ in steps)
        gap = max(max(apart(a[i], b[i]), apart(a[i], c[i]))
                  for a, b, c in steps)
        assert gap <= max(4.0 * spread, 2.0 ** -20 * scale), \
            (i, gap, spread, scale)
