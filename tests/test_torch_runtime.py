"""The port's runtime: native registry and async frame loop, on the CPU.

Mirrors tests/test_runtime.py (TestRegistry, TestAsyncLoop) on
``audio_raytracer_tpu_torch.runtime``: double-buffer publication,
swap-back removal with handle stability, target removal with collider
ownership fixup, dynamic collider updates and the frame loop. The parity
tests apply one mutation script to the JAX registry and the port's and
hold the snapshots equal field by field, exactly; and the harvested
settings and impulse response of the port's loop to the JAX loop's
(``backend="jnp"``, ``compute_async=False``) within the tolerances of
tests/test_torch_forward.py. The meshed loop is tested in
tests/test_torch_runtime_mesh.py.
"""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from audio_raytracer_tpu.runtime import AsyncRaytraceLoop as JLoop
from audio_raytracer_tpu.runtime import SceneRegistry as JRegistry
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu_torch.runtime import (
    AsyncRaytraceLoop,
    SceneRegistry,
    native,
)
from audio_raytracer_tpu_torch.types import TraceConfig

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture
def reg():
    r = SceneRegistry()
    yield r
    r.close()


def snap(r):
    return r.snapshot(device=CPU)


class TestRegistry:
    def test_add_and_snapshot(self, reg):
        reg.add_sphere([0, 0, 5], 1.0, material=(0.1, 1.0, 2.0))
        reg.add_aabb([1, 2, 3], [1, 1, 1])
        reg.add_obb([4, 5, 6], [2, 1, 1], [0, 0, 0, 1])
        reg.add_target([0, 1, 0])
        scene = snap(reg)
        assert reg.counts() == (1, 1, 1, 1)
        assert bool(scene.spheres.active[0])
        assert not bool(scene.spheres.active[1])  # padding inactive
        np.testing.assert_allclose(scene.spheres.center[0].numpy(),
                                   [0, 0, 5])
        assert float(scene.spheres.material.echo[0]) == 2.0
        np.testing.assert_allclose(scene.target_positions.numpy(),
                                   [[0, 1, 0]])
        # OBB padding carries the identity rotation.
        np.testing.assert_array_equal(scene.obbs.inv_rot[1:].numpy(),
                                      [[0, 0, 0, 1]] * 7)
        assert scene.spheres.target_id.dtype == torch.int32
        assert snap(reg) is scene  # cached while the version holds

    def test_double_buffer_publication(self, reg):
        h = reg.add_sphere([0, 0, 5], 1.0)
        s1 = snap(reg)
        v1 = reg.version
        reg.update_sphere(h, [9, 9, 9], 2.0)
        assert reg.version == v1  # not yet published
        s2 = snap(reg)  # publishes
        assert reg.version == v1 + 1
        np.testing.assert_allclose(s2.spheres.center[0].numpy(), [9, 9, 9])
        # The earlier snapshot is immutable.
        np.testing.assert_allclose(s1.spheres.center[0].numpy(), [0, 0, 5])

    def test_swap_back_removal_keeps_handles_valid(self, reg):
        h0 = reg.add_aabb([0, 0, 0], [1, 1, 1])
        reg.add_aabb([1, 1, 1], [1, 1, 1])
        h2 = reg.add_aabb([2, 2, 2], [1, 1, 1])
        reg.remove(h0)  # h2 swaps into slot 0
        reg.update_aabb(h2, [9, 9, 9], [2, 2, 2])
        scene = snap(reg)
        assert reg.counts()[1] == 2
        centers = scene.aabbs.center[:2].numpy().tolist()
        assert [9, 9, 9] in centers and [1, 1, 1] in centers
        with pytest.raises(KeyError):
            reg.update_aabb(h0, [0, 0, 0], [1, 1, 1])
        with pytest.raises(KeyError):
            reg.remove(h0)

    def test_handle_reuse_after_remove(self, reg):
        h0 = reg.add_sphere([0, 0, 1], 1.0)
        reg.remove(h0)
        h1 = reg.add_sphere([0, 0, 2], 1.0)
        reg.update_sphere(h1, [0, 0, 3], 1.5)
        scene = snap(reg)
        np.testing.assert_allclose(scene.spheres.center[0].numpy(),
                                   [0, 0, 3])
        assert float(scene.spheres.radius[0]) == 1.5

    def test_target_removal_fixes_collider_ownership(self, reg):
        t0 = reg.add_target([0, 0, 0])
        t1 = reg.add_target([5, 0, 0])
        reg.add_sphere([0, 0, 0], 0.5, target_id=t0)
        reg.add_sphere([5, 0, 0], 0.5, target_id=t1)
        reg.remove_target(t0)  # t1 swaps into index 0
        scene = snap(reg)
        # owner of removed target -> -1; owner of moved target -> new index
        assert sorted(scene.spheres.target_id[:2].tolist()) == [-1, 0]
        np.testing.assert_allclose(scene.target_positions.numpy(),
                                   [[5, 0, 0]])

    def test_moving_target_position_sync(self, reg):
        t0 = reg.add_target([0, 0, 3])
        s1 = snap(reg)
        v1 = reg.version
        reg.set_target_position(t0, [5, 0, 3])
        np.testing.assert_allclose(s1.target_positions.numpy(), [[0, 0, 3]])
        s2 = snap(reg)
        assert reg.version == v1 + 1
        np.testing.assert_allclose(s2.target_positions.numpy(), [[5, 0, 3]])
        with pytest.raises(KeyError):
            reg.set_target_position(t0 + 1, [0, 0, 0])
        with pytest.raises(KeyError):
            reg.set_target_position(-1, [0, 0, 0])

    def test_static_shapes_under_growth(self, reg):
        for i in range(6):
            reg.add_sphere([0, 0, float(i + 2)], 0.5)
        cap1 = snap(reg).spheres.count
        reg.add_sphere([0, 0, 50.0], 0.5)
        assert snap(reg).spheres.count == cap1  # 7 <= 8: same capacity
        for i in range(4):
            reg.add_sphere([0, 0, 60.0 + i], 0.5)
        s3 = snap(reg)
        assert s3.spheres.count == cap1 * 2  # grew by a power of two
        assert int(s3.spheres.active.sum()) == 11

    def test_snapshot_defaults_to_the_card(self, reg, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            reg.snapshot()


def mutation_script(r):
    """One script of adds, updates, removals and target moves; yields
    after each stage so both registries can be snapshot there."""
    t = [r.add_target(p) for p in ([0, 0, 6], [4, 1, -3], [-5, 2, 2])]
    hs = [r.add_sphere([i - 4.0, 0.5 * i, 7.0], 0.4 + 0.1 * i,
                       material=(0.05 * i, 1.0 + i, 0.5 + 0.1 * i),
                       target_id=t[i % 3] if i < 3 else -1)
          for i in range(9)]
    ha = [r.add_aabb([3.0 * i - 6, -2, 5], [1, 0.5 + 0.1 * i, 0.7],
                     material=(0.1, 2.0, 1.5)) for i in range(5)]
    ho = [r.add_obb([i - 2.0, 3, -4], [0.8, 1.2, 0.6],
                    [0.0, np.sin(0.3 * i), 0.0, np.cos(0.3 * i)],
                    material=(0.2, 0.5, 1.0), target_id=t[1])
          for i in range(3)]
    yield
    r.update_aabb(ha[1], [0, 0, 3], [5, 5, 0.5], material=(0.0, 5.0, 1.0))
    r.remove(hs[0])
    r.remove(ha[3])
    r.set_target_position(t[2], [1, 1, 1])
    yield
    r.remove_target(t[0])
    r.remove(ho[0])
    r.add_sphere([0, 9, 0], 2.0, target_id=0)
    r.update_obb(ho[2], [7, 7, 7], [1, 1, 1], [0, 0, 0, 1])
    yield
    for h in hs[1:]:
        r.remove(h)
    yield


def test_snapshots_equal_the_jax_registry_field_by_field(reg):
    jreg = JRegistry()
    try:
        stages = 0
        for _ in zip(mutation_script(reg), mutation_script(jreg)):
            ours, theirs = snap(reg), jax.tree.map(np.asarray,
                                                   jreg.snapshot())
            assert reg.counts() == jreg.counts()
            for kind in ("spheres", "aabbs", "obbs"):
                a, b = getattr(ours, kind), getattr(theirs, kind)
                for f in dataclasses.fields(a):
                    x, y = getattr(a, f.name), getattr(b, f.name)
                    if f.name == "material":
                        pairs = [(getattr(x, m), getattr(y, m))
                                 for m in ("absorption", "density", "echo")]
                    else:
                        pairs = [(x, y)]
                    for u, v in pairs:
                        assert str(u.dtype).split(".")[-1] == str(v.dtype)
                        np.testing.assert_array_equal(
                            u.numpy(), v, err_msg=f"{kind}.{f.name}")
            np.testing.assert_array_equal(ours.target_positions.numpy(),
                                          theirs.target_positions)
            stages += 1
        assert stages == 4
    finally:
        jreg.close()


def test_parallel_builds_publish_one_whole_library(tmp_path, monkeypatch):
    # Builders serialize on a file lock and rename a finished file into
    # place, so concurrent first uses (parallel test workers) never load
    # a half-written library.
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    path = native.lib_path()
    errors = []

    def build():
        try:
            native._build(path)
        except Exception as e:  # noqa: BLE001 - collected and asserted
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([os.path.basename(path), "audio_rt_scene.lock"])


class TestAsyncLoop:
    def test_frame_loop_produces_settings(self, reg):
        reg.add_aabb([0, 0, 6], [2, 2, 1], material=(0.1, 1.0, 1.0))
        reg.add_sphere([3, 0, 3], 1.0)
        reg.add_target([0, 0, 3])
        cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=100.0)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False, device=CPU)

        assert loop.tick([0.0, 0.0, 0.0]) is None  # nothing harvested yet
        settings = loop.tick([0.0, 0.0, 0.0])
        assert settings is not None and settings.muffle.shape == (1,)
        assert 0.0 <= float(settings.muffle[0]) <= 1.0
        assert loop.frames_dispatched == 2 and loop.frames_harvested == 1
        assert loop.raytracer_ms > 0.0 and loop.reverb_ir is None

    def test_async_mode_on_the_cpu_harvests_every_frame(self, reg):
        reg.add_aabb([0, 0, 6], [2, 2, 1])
        reg.add_target([0, 0, 3])
        loop = AsyncRaytraceLoop(reg, TraceConfig(ray_count=32), device=CPU)
        for _ in range(4):
            loop.tick([0, 0, 0])
        assert loop.frames_dispatched == 4 and loop.frames_harvested == 3

    def test_one_engine_per_snapshot(self, reg):
        # The eager frames' engine (graph=False); the graph's refills are
        # held in tests/test_torch_frame_graph.py.
        h = reg.add_aabb([0, 0, 6], [2, 2, 1])
        reg.add_target([0, 0, 3])
        loop = AsyncRaytraceLoop(reg, TraceConfig(ray_count=32), device=CPU,
                                 graph=False)
        loop.tick([0, 0, 0])
        engine = loop._engine
        loop.tick([0.5, 0, 0])  # same snapshot: same engine
        assert loop._engine is engine
        reg.update_aabb(h, [0, 0, 7], [2, 2, 1])
        loop.tick([0, 0, 0])  # new snapshot: new engine
        assert loop._engine is not engine
        assert loop._engine.scene is reg.snapshot(device=CPU)

    def test_dynamic_collider_updates_flow_through(self, reg):
        # Moving-platform analog: a wall oscillates between blocking the
        # target and not (PlatformMover.cs exercising the re-bake path).
        h = reg.add_aabb([0, 0, 3], [5, 5, 0.5], material=(0.0, 5.0, 1.0))
        reg.add_target([0, 0, 6])
        cfg = TraceConfig(ray_count=128, max_bounces=1, max_ray_life=100.0)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False, device=CPU)

        loop.tick([0, 0, 0])
        blocked = loop.tick([0, 0, 0])
        reg.update_aabb(h, [100, 0, 3], [5, 5, 0.5],
                        material=(0.0, 5.0, 1.0))  # move the wall away
        loop.tick([0, 0, 0])
        open_ = loop.tick([0, 0, 0])
        assert float(blocked.muffle[0]) != float(open_.muffle[0])

    def test_moving_target_flows_through(self, reg):
        reg.add_aabb([0, 0, 3], [5, 5, 0.5], material=(0.0, 5.0, 1.0))
        t = reg.add_target([0, 0, 6])
        cfg = TraceConfig(ray_count=128, max_bounces=1, max_ray_life=100.0)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False, device=CPU)

        loop.tick([0, 0, 0])
        behind = loop.tick([0, 0, 0])
        reg.set_target_position(t, [0, 0, -6])  # wall no longer between
        loop.tick([0, 0, 0])
        moved = loop.tick([0, 0, 0])
        np.testing.assert_allclose(behind.perceived_position.numpy(),
                                   [[0, 0, 6]])
        np.testing.assert_allclose(moved.perceived_position.numpy(),
                                   [[0, 0, -6]])
        assert float(behind.muffle[0]) != float(moved.muffle[0])

    def test_live_reconfigure(self, reg):
        # The editor failsafe re-alloc (Audio/AudioRayTracer.cs:110-133).
        reg.add_aabb([0, 0, 6], [4, 4, 1], material=(0.1, 1.0, 1.0))
        reg.add_target([0, 0, 3])
        cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=100.0)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False, device=CPU)
        loop.tick([0, 0, 0])
        before = loop.tick([0, 0, 0])
        assert before is not None and loop._directions.shape == (64, 3)

        cfg2 = dataclasses.replace(cfg, ray_count=128, max_bounces=4,
                                   num_reverb_bins=16)
        loop.reconfigure(cfg2)
        # In-flight frame (old config) dropped; latest stays available.
        assert loop._in_flight is None
        assert loop.tick([0, 0, 0]) is before
        after = loop.tick([0, 0, 0])
        assert loop._directions.shape == (128, 3)
        assert after.muffle.shape == (1,)
        assert 0.0 <= float(after.muffle[0]) <= 1.0
        assert loop.reverb_ir is not None and loop.reverb_ir.shape == (16,)

        dirs = loop._directions  # an unchanged config is a no-op
        loop.reconfigure(dataclasses.replace(cfg2))
        assert loop._directions is dirs

    def test_loop_defaults_to_the_card(self, reg, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            AsyncRaytraceLoop(reg, TraceConfig(ray_count=8))


def test_loop_harvests_what_the_jax_loop_harvests(reg):
    jreg = JRegistry()
    try:
        cfg_kw = dict(ray_count=128, max_bounces=3, max_ray_life=150.0,
                      num_reverb_bins=16)
        ours = AsyncRaytraceLoop(reg, TraceConfig(**cfg_kw),
                                 compute_async=False, device=CPU)
        theirs = JLoop(jreg, JConfig(**cfg_kw), backend="jnp",
                       compute_async=False)
        origins = [[0, 0, 0], [0.3, 0.1, -0.2], [0.6, 0.2, -0.4],
                   [0.9, 0.3, -0.6], [1.2, 0.4, -0.8]]
        script = zip(mutation_script(reg), mutation_script(jreg))
        compared = 0
        for origin in origins:
            next(script, None)
            a, b = ours.tick(origin), theirs.tick(origin)
            assert (a is None) == (b is None)
            if a is None:
                continue
            np.testing.assert_allclose(a.muffle.numpy(),
                                       np.asarray(b.muffle), rtol=1e-5,
                                       atol=1e-5)
            for k in ("reverb_strength", "reverb_volume"):
                np.testing.assert_allclose(float(getattr(a, k)),
                                           float(getattr(b, k)), rtol=1e-4,
                                           atol=1e-4)
            np.testing.assert_array_equal(a.perceived_position.numpy(),
                                          np.asarray(b.perceived_position))
            np.testing.assert_allclose(ours.reverb_ir.numpy(),
                                       np.asarray(theirs.reverb_ir),
                                       rtol=1e-3, atol=1e-2)
            compared += 1
        assert compared == 4
        assert ours.frames_harvested == theirs.frames_harvested == 4
    finally:
        jreg.close()
