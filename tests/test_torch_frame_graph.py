"""The compiled frame (``models/frame_graph.py::FrameGraph``) on the CPU.

On the CPU the frame graph has no CUDA graph: its warm-up and its
"replays" run the frame closure on its static buffers, so the refill of a
new snapshot into those buffers, the key, the copy out and the launch
bookkeeping run here as they run on the card. The frames are held bit for
bit to a fresh eager ``forward`` on each scene, and to the JAX package's
jitted ``make_forward`` (``backend="jnp"``) within the tolerances of
tests/test_torch_forward.py. The scenes are JAX registry snapshots,
drawn from a numpy seed and carried across with
``convert.scene_from_arrays``; one AABB moves between snapshots.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from audio_raytracer_tpu.models.raytracer import make_forward as j_make_forward
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.runtime import SceneRegistry as JRegistry
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch.convert import scene_from_arrays
from audio_raytracer_tpu_torch.models import raytracer as tmodel
from audio_raytracer_tpu_torch.models.frame_graph import (
    FrameGraph,
    frame_skip_sets,
)
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import KernelBackend
from audio_raytracer_tpu_torch.runtime import AsyncRaytraceLoop, SceneRegistry
from audio_raytracer_tpu_torch.types import TraceConfig, tensors_of

torch.set_num_threads(1)

CPU = "cpu"
SNAPSHOTS = 4

CONFIGS = {
    "float32": dict(ray_count=96, max_bounces=3, max_ray_life=150.0,
                    num_accum_batches=2, num_reverb_bins=24),
    "bfloat16": dict(ray_count=96, max_bounces=3, max_ray_life=150.0,
                     num_reverb_bins=24, compute_dtype="bfloat16",
                     epsilon=0.05),
    "compact_unordered": dict(ray_count=96, max_bounces=4,
                              max_ray_life=90.0, num_reverb_bins=24,
                              compact_rays=True, compact_unordered=True),
    "compact_ordered": dict(ray_count=96, max_bounces=4, max_ray_life=90.0,
                            num_accum_batches=3, compact_rays=True),
    "collect_debug": dict(ray_count=64, max_bounces=2, max_ray_life=150.0),
}
# The configs whose frames also return the debug outputs.
DEBUG = {"collect_debug"}


def fill(reg, seed=13, targets=3):
    """A numpy-drawn room into ``reg`` (either package's registry):
    spheres, AABBs and OBBs around the origin, the first sphere and OBB
    owned by targets. Returns the handles of the AABBs."""
    rng = np.random.default_rng(seed)

    def mat():
        return tuple(float(x) for x in (rng.uniform(0.0, 0.3),
                                        rng.uniform(0.2, 2.0),
                                        rng.uniform(0.5, 2.0)))

    def pos():
        return rng.uniform(-10.0, 10.0, 3).tolist()

    t = [reg.add_target(rng.uniform(-7.0, 7.0, 3).tolist())
         for _ in range(targets)]
    for i in range(5):
        reg.add_sphere(pos(), float(rng.uniform(0.5, 2.0)), mat(),
                       t[0] if i == 0 else -1)
    aabbs = [reg.add_aabb(pos(), rng.uniform(0.5, 3.0, 3).tolist(), mat())
             for _ in range(9)]
    for i in range(6):
        q = rng.normal(size=4)
        reg.add_obb(pos(), rng.uniform(0.5, 2.5, 3).tolist(),
                    (q / np.linalg.norm(q)).tolist(), mat(),
                    t[1] if i == 0 else -1)
    # A wall between the listener and the first target, so that moving
    # it changes every output.
    aabbs.insert(0, reg.add_aabb([0.0, 0.0, 4.0], [6.0, 6.0, 0.5],
                                 (0.05, 3.0, 1.5)))
    return aabbs


def move(reg, handle, i):
    """The wall of ``fill`` slid along x (tick i)."""
    reg.update_aabb(handle, [3.0 * i, 0.0, 4.0], [6.0, 6.0, 0.5],
                    (0.05, 3.0, 1.5))


def carried(jreg):
    """A JAX registry snapshot as a port scene on the CPU."""
    return scene_from_arrays(jax.tree.map(np.asarray, jreg.snapshot()),
                             device=CPU)


@pytest.fixture
def jreg():
    r = JRegistry()
    yield r
    r.close()


def moving_snapshots(jreg, n=SNAPSHOTS):
    """n (JAX snapshot, port scene) pairs, the wall moved between them."""
    wall = fill(jreg)[0]
    out = []
    for i in range(n):
        move(jreg, wall, i)
        js = jreg.snapshot()
        out.append((js, scene_from_arrays(jax.tree.map(np.asarray, js),
                                          device=CPU)))
    return out


def inputs(cfg, i):
    origin = torch.tensor([0.3 * i, 0.5, -0.2 * i])
    return origin, torch.as_tensor(np.array(
        fibonacci_directions(cfg.ray_count)))


def eager(origin, dirs, scene, cfg, collect_debug=False):
    with torch.no_grad():
        return tmodel.forward(origin, dirs, scene, cfg,
                              collect_debug=collect_debug, backend="kernel",
                              device=CPU)


def assert_same_frame(got, want):
    """Every tensor of (result, settings) equal, bit for bit."""
    for a, b in zip(got, want):
        ta, tb = list(tensors_of(a)), list(tensors_of(b))
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_frames_equal_eager_forward_bit_for_bit(jreg, name):
    cfg, debug = TraceConfig(**CONFIGS[name]), name in DEBUG
    step = FrameGraph(cfg, collect_debug=debug, device=CPU)
    frames = []
    for i, (_, scene) in enumerate(moving_snapshots(jreg)):
        origin, dirs = inputs(cfg, i)
        got = step(origin, dirs, scene)
        assert_same_frame(got, eager(origin, dirs, scene, cfg, debug))
        frames.append(got)
    assert (step.warmups, step.captures, step.replays, step.refills) == (
        1, 1, SNAPSHOTS - 1, SNAPSHOTS)
    # The moved wall changes the frame, so the refill has teeth.
    for (ra, sa), (rb, sb) in zip(frames, frames[1:]):
        assert not torch.equal(ra.echo_distances, rb.echo_distances)
        assert not (torch.equal(sa.muffle, sb.muffle) and torch.equal(
            sa.reverb_strength, sb.reverb_strength))


@pytest.mark.parametrize("name", ["float32", "compact_unordered"])
def test_graph_frames_match_jax_make_forward(jreg, name):
    kw = CONFIGS[name]
    cfg, jcfg = TraceConfig(**kw), JConfig(**kw)
    step = FrameGraph(cfg, device=CPU)
    jstep = j_make_forward(jcfg, backend="jnp")
    for i, (js, scene) in enumerate(moving_snapshots(jreg)):
        origin, dirs = inputs(cfg, i)
        r, s = step(origin, dirs, scene)
        jr, jsett = jstep(jnp.asarray(origin.numpy()), jnp.asarray(
            dirs.numpy()), js)
        np.testing.assert_array_equal(r.muffle_hits.numpy(),
                                      np.asarray(jr.muffle_hits))
        np.testing.assert_allclose(s.muffle.numpy(), np.asarray(jsett.muffle),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r.permeation.numpy(),
                                   np.asarray(jr.permeation), rtol=1e-5,
                                   atol=1e-3)
        # Unordered compaction permutes rows within each bounce column.
        a, b = r.echo_distances.numpy(), np.asarray(jr.echo_distances)
        if cfg.compact_unordered:
            a, b = np.sort(a, axis=0), np.sort(b, axis=0)
        assert np.isclose(a, b, rtol=1e-4, atol=1e-3).mean() > 0.995
        for k in ("reverb_strength", "reverb_volume"):
            np.testing.assert_allclose(float(getattr(s, k)),
                                       float(getattr(jsett, k)), rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_allclose(r.reverb_ir.numpy(),
                                   np.asarray(jr.reverb_ir), rtol=1e-3,
                                   atol=1e-2)
    assert step.replays == SNAPSHOTS - 1


def test_key_holds_while_a_box_moves(jreg):
    cfg = TraceConfig(**CONFIGS["float32"])
    step = FrameGraph(cfg, device=CPU)
    keys = []
    for i, (_, scene) in enumerate(moving_snapshots(jreg)):
        step(*inputs(cfg, i), scene)
        keys.append(step.key)
    assert all(k == keys[0] for k in keys)
    assert step.captures == 1 and step.warmups == 1


def grow(reg, aabbs):
    # Past the padded capacity of 16 AABBs (10 added by fill).
    for i in range(8):
        reg.add_aabb([20.0 + i, 0.0, 0.0], [0.5, 0.5, 0.5])


def deactivate(reg, aabbs):
    reg.remove(aabbs[3])  # swap-back: one padded row goes inactive


def take_ownership(reg, aabbs):
    reg.update_aabb(aabbs[2], [5.0, 5.0, 5.0], [1.0, 1.0, 1.0],
                    (0.1, 1.0, 1.0), target_id=2)


@pytest.mark.parametrize("mutate", [grow, deactivate, take_ownership],
                         ids=lambda f: f.__name__)
def test_key_changes_and_the_frame_starts_over(jreg, mutate):
    cfg = TraceConfig(**CONFIGS["float32"])
    step = FrameGraph(cfg, device=CPU)
    aabbs = fill(jreg)
    for i in range(3):
        move(jreg, aabbs[0], i)
        step(*inputs(cfg, i), carried(jreg))
    before = step.key
    mutate(jreg, aabbs)
    scene = carried(jreg)
    if mutate is not grow:  # the padded shapes hold; the row counts move
        assert [tuple(t.shape) for t in tensors_of(scene)] == \
            [s for s, _ in before[2][1]]
    for i in range(3, 6):
        move(jreg, aabbs[0], i)
        scene = carried(jreg)
        origin, dirs = inputs(cfg, i)
        assert_same_frame(step(origin, dirs, scene),
                          eager(origin, dirs, scene, cfg))
    assert step.key != before
    # One warm-up and one capture per key; the second and third calls of
    # each replayed.
    assert (step.warmups, step.captures, step.replays) == (2, 2, 4)


def test_held_settings_survive_later_frames(jreg):
    cfg = TraceConfig(**CONFIGS["float32"])
    step = FrameGraph(cfg, device=CPU)
    snaps = moving_snapshots(jreg, 5)
    held = []
    for i, (_, scene) in enumerate(snaps):
        r, s = step(*inputs(cfg, i), scene)
        held.append(((r, s), [t.clone() for t in tensors_of((r, s))]))
    # Frames k + 1 and k + 2 (and the refills before them) left the
    # outputs of frame k as they were.
    for (r, s), copies in held:
        for t, c in zip(tensors_of((r, s)), copies):
            assert torch.equal(t, c)
    for (r, s), _ in held:
        assert s.perceived_position.data_ptr() != \
            step._scene.target_positions.data_ptr()
        assert r.echo_distances.data_ptr() != \
            step._out[0].echo_distances.data_ptr()


class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: a replay
    launches nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_capture_takes_back_its_counts_and_replays_add_them(jreg,
                                                            monkeypatch):
    """A capture enqueues nothing: the counts the captured frame made are
    taken back, and each replay adds them again."""
    cfg = TraceConfig(**CONFIGS["float32"])
    H = cfg.max_hits_per_ray
    step = FrameGraph(cfg, device=CPU)
    frame = step._frame

    def counted():  # the counts the wrappers make on the card
        K.run_closest_hit.launches += H
        return frame()

    monkeypatch.setattr(step, "_frame", counted)
    monkeypatch.setattr(step, "_capturing", True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(K.run_closest_hit, "launches", 0)
    snaps = moving_snapshots(jreg, 3)
    step(*inputs(cfg, 0), snaps[0][1])  # the warm-up counts as it runs
    assert K.run_closest_hit.launches == H
    step(*inputs(cfg, 1), snaps[1][1])  # capture (taken back), replay
    assert step._launches == {(K.run_closest_hit, "launches"): H}
    assert K.run_closest_hit.launches == 2 * H
    step(*inputs(cfg, 2), snaps[2][1])
    assert K.run_closest_hit.launches == 3 * H
    assert step._graph.replays == step.replays == 2


def test_a_table_built_inside_the_frame_raises(jreg, monkeypatch):
    # The bfloat16 plain versions read rounded tables: built lazily by
    # the frame, a refill would leave them stale (and a capture fail).
    cfg = TraceConfig(**CONFIGS["bfloat16"])
    monkeypatch.setattr(KernelBackend, "build_tables", lambda self, s: None)
    step = FrameGraph(cfg, device=CPU)
    with pytest.raises(RuntimeError, match="lazily"):
        step(*inputs(cfg, 0), moving_snapshots(jreg, 1)[0][1])


class HostTraffic(TorchDispatchMode):
    """Records the ops a CUDA graph capture refuses: a tensor made from
    host data (its copy to the card), a value read back to the host, and
    the selections whose size waits for the device."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bool_index = name == "aten.index.Tensor" and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        if bool_index or name.split(".")[1] in (
                "lift_fresh", "_local_scalar_dense", "nonzero",
                "masked_select"):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_captured_frame_makes_no_host_traffic(jreg, name):
    cfg, debug = TraceConfig(**CONFIGS[name]), name in DEBUG
    step = FrameGraph(cfg, collect_debug=debug, device=CPU)
    snaps = moving_snapshots(jreg, 2)
    step(*inputs(cfg, 0), snaps[0][1])
    step(*inputs(cfg, 1), snaps[1][1])  # the key's capture on the card
    with HostTraffic() as mode:
        step._frame()  # what a capture records
    assert not mode.seen, mode.seen


def test_frame_skip_sets_are_the_traces_b2_launches():
    assert frame_skip_sets(2) == [(NO_SKIP, 0, 1)]
    sets = frame_skip_sets(18)
    assert sets == [(NO_SKIP, *range(15)), (15, 16, 17)]


def test_the_loop_refills_only_a_new_snapshot(monkeypatch):
    reg = SceneRegistry()
    try:
        wall = fill(reg)[0]
        loop = AsyncRaytraceLoop(reg, TraceConfig(ray_count=32),
                                 compute_async=False, device=CPU)
        graph = loop.graph_frames
        loop.tick([0, 0, 0])
        loop.tick([0.5, 0, 0])  # the same snapshot: no refill
        assert graph.refills == 1 and graph.replays == 1
        engine = graph._engine
        move(reg, wall, 1)
        loop.tick([0, 0, 0])  # a new snapshot: refilled, same engine
        assert graph.refills == 2 and graph._engine is engine
        assert graph._source is reg.snapshot(device=CPU)
        assert loop._engine is None  # no eager engine beside the graph
    finally:
        reg.close()


def test_graph_loop_harvests_what_the_eager_loop_harvests():
    regs = [SceneRegistry(), SceneRegistry()]
    try:
        walls = [fill(r)[0] for r in regs]
        cfg = TraceConfig(ray_count=64, max_bounces=3, max_ray_life=150.0,
                          num_reverb_bins=16)
        loops = [AsyncRaytraceLoop(r, cfg, compute_async=False, device=CPU,
                                   graph=g) for r, g in zip(regs, (True,
                                                                   False))]
        assert loops[1].graph_frames is None
        for i in range(6):
            outs = []
            for reg, wall, loop in zip(regs, walls, loops):
                if i % 2:
                    move(reg, wall, i)
                outs.append((loop.tick([0.2 * i, 0.0, 0.1]), loop.reverb_ir))
            (a, ir_a), (b, ir_b) = outs
            assert (a is None) == (b is None)
            if a is not None:
                assert_same_frame((a,), (b,))
                assert torch.equal(ir_a, ir_b)
        graph = loops[0].graph_frames
        assert loops[0].frames_dispatched == 6
        assert graph.replays == 6 - graph.warmups and graph.captures == 1
    finally:
        for r in regs:
            r.close()


def test_make_forward_routes_only_the_cards_kernel_frames(monkeypatch):
    cfg = TraceConfig(ray_count=8)
    assert not isinstance(tmodel.make_forward(cfg, device=CPU), FrameGraph)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert isinstance(tmodel.make_forward(cfg), FrameGraph)
    assert not isinstance(tmodel.make_forward(cfg, backend="dense"),
                          FrameGraph)
    engine = KernelBackend(tmodel.random_scene(0, 2, 2, 2, device=CPU))
    assert not isinstance(tmodel.make_forward(cfg, backend=engine),
                          FrameGraph)
