"""The port's scene documents against the JAX package's, on the CPU.

Mirrors TestSceneFormat, TestShippedScenes and TestSceneValidation of
tests/test_demo.py on ``audio_raytracer_tpu_torch.demo``, and holds the
port to the JAX package on the same documents: the registry each
builds is snapshotted field by field (exactly), the animations step to
the same positions over 20 steps (atol 1e-6), the validation errors
carry the same text, the gallery files are the same bytes, and the
quaternion functions the documents use agree (atol 1e-6).
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_raytracer_tpu.demo as j_demo
import audio_raytracer_tpu_torch.demo as t_demo
from audio_raytracer_tpu import materials as j_materials
from audio_raytracer_tpu.demo import scene_format as J
from audio_raytracer_tpu.demo.scene_schema import (
    SceneValidationError as JValidationError,
)
from audio_raytracer_tpu.ops import quaternion as jq
from audio_raytracer_tpu.types import TraceConfig as JConfig
from audio_raytracer_tpu.utils import logging as j_logging
from audio_raytracer_tpu_torch import materials as t_materials
from audio_raytracer_tpu_torch.demo.sample_scene import sample_scene_dict
from audio_raytracer_tpu_torch.demo.scene_format import (
    _euler_deg_to_inv_quat_xyzw,
    build_registry,
    load_scene_file,
)
from audio_raytracer_tpu_torch.demo.scene_player import simulate
from audio_raytracer_tpu_torch.demo.scene_schema import (
    _TRACE_FIELDS,
    SceneValidationError,
)
from audio_raytracer_tpu_torch.ops import quaternion as tq
from audio_raytracer_tpu_torch.types import TraceConfig
from audio_raytracer_tpu_torch.utils import logging as t_logging

torch.set_num_threads(1)

CPU = "cpu"
GALLERY = ("corridor.json", "listening_room.json")


def gallery_path(package, name):
    return os.path.join(os.path.dirname(package.__file__), "scenes", name)


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("fn", ["multiply", "from_euler_zxy", "pack_xyz",
                                "unpack_xyz"])
def test_quaternion_functions_match_jax(fn):
    # Tolerance: atol 1e-6, float32 rounding of unit-scale products.
    rng = np.random.default_rng(3)
    a, b = unit_quats(rng, 64), unit_quats(rng, 64)
    if fn == "multiply":
        args = (a, b)
    elif fn == "from_euler_zxy":
        args = (rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32),)
    elif fn == "pack_xyz":
        args = (a,)
    else:
        args = (np.array(jq.pack_xyz(jnp.asarray(a))),)
    got = getattr(tq, fn)(*(torch.as_tensor(x) for x in args)).numpy()
    want = np.asarray(getattr(jq, fn)(*(jnp.asarray(x) for x in args)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_pack_unpack_round_trip_is_the_same_rotation():
    q = torch.as_tensor(unit_quats(np.random.default_rng(4), 32))
    back = tq.unpack_xyz(tq.pack_xyz(q))
    v = torch.tensor([0.3, -1.2, 2.0])
    torch.testing.assert_close(tq.rotate(back, v), tq.rotate(q, v),
                               atol=1e-5, rtol=0)


def test_euler_matches_jax_scene_format():
    rng = np.random.default_rng(5)
    for euler in rng.uniform(-180.0, 180.0, (16, 3)).tolist():
        np.testing.assert_allclose(_euler_deg_to_inv_quat_xyzw(euler),
                                   J._euler_deg_to_inv_quat_xyzw(euler),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# TestSceneFormat of tests/test_demo.py
# ---------------------------------------------------------------------------


class TestSceneFormat:
    def test_sample_scene_builds(self):
        loaded = build_registry(sample_scene_dict(ray_count=32))
        loaded.registry.snapshot(device=CPU)  # publish the job batch
        counts = loaded.registry.counts()
        assert counts[3] == 2
        assert counts[0] == 4  # spheres (2 + 2 target-owned)
        assert counts[1] == 10  # aabbs incl. platform
        assert counts[2] == 3
        # Platform mover + the orbiting "radio" source (whose owned
        # collider rides the target animation automatically).
        assert len(loaded.animations) == 2
        assert len(loaded.animations[1].owned) == 1
        assert loaded.cfg.ray_count == 32
        loaded.registry.close()

    def test_roundtrip_via_file(self, tmp_path):
        doc = sample_scene_dict(ray_count=16)
        path = tmp_path / "scene.json"
        path.write_text(json.dumps(doc))
        loaded = load_scene_file(str(path))
        assert loaded.target_names == ["radio", "speaker"]
        loaded.registry.close()

    def test_euler_quat_matches_quaternion_module(self):
        euler = [30.0, 45.0, -20.0]
        got = np.asarray(_euler_deg_to_inv_quat_xyzw(euler))
        expect = tq.inverse(tq.from_euler_zxy(
            torch.deg2rad(torch.tensor(euler)))).numpy()
        np.testing.assert_allclose(got, expect, atol=1e-6)

    def test_single_waypoint_animation_holds(self):
        # A one-waypoint mover is valid (go there, then hold).
        doc = {
            "trace": {"ray_count": 8},
            "colliders": [{"type": "sphere", "center": [0, 0, 4],
                           "radius": 1}],
            "targets": [{"position": [0, 3, 0]}],
            "animations": [{"collider": 0, "speed": 2.0,
                            "waypoints": [[0, 0, 8]]}],
        }
        loaded = build_registry(doc)
        anim = loaded.animations[0]
        for _ in range(6):
            anim.step(loaded.registry, 0.5)
        np.testing.assert_allclose(anim.position, [0, 0, 8], atol=1e-6)
        anim.step(loaded.registry, 0.5)  # holds, no IndexError
        np.testing.assert_allclose(anim.position, [0, 0, 8], atol=1e-6)
        loaded.registry.close()

    def test_mover_starts_from_authored_position(self):
        # The mover moves FROM the authored center toward waypoints[0]
        # (PlatformMover.cs:18-27), never teleporting to waypoints[0].
        doc = {
            "trace": {"ray_count": 8},
            "colliders": [{"type": "aabb", "center": [0, 0, 0],
                           "half_extents": [1, 1, 1]}],
            "targets": [{"position": [0, 3, 0]}],
            "animations": [{"collider": 0, "speed": 1.0,
                            "waypoints": [[10, 0, 0], [0, 10, 0]]}],
        }
        loaded = build_registry(doc)
        anim = loaded.animations[0]
        anim.step(loaded.registry, 1.0)
        np.testing.assert_allclose(anim.position, [1, 0, 0], atol=1e-6)
        loaded.registry.close()

    def test_material_resolution(self):
        doc = {
            "materials": {"custom": {"absorption": 0.5, "density": 2.0,
                                     "echo": 0.1}},
            "colliders": [
                {"type": "sphere", "center": [0, 0, 5], "radius": 1,
                 "material": "custom"},
                {"type": "sphere", "center": [0, 0, 9], "radius": 1,
                 "material": "concrete"},
                {"type": "sphere", "center": [0, 0, 13], "radius": 1,
                 "material": [0.9, 0.8, 0.7]},
            ],
            "targets": [{"position": [0, 5, 0]}],
        }
        loaded = build_registry(doc)
        scene = loaded.registry.snapshot(device=CPU)
        ab = scene.spheres.material.absorption[:3].numpy()
        np.testing.assert_allclose(sorted(ab), [0.25, 0.5, 0.9], atol=1e-6)
        loaded.registry.close()


def test_material_presets_equal_jax():
    assert t_materials.MATERIAL_PRESETS == j_materials.MATERIAL_PRESETS


# ---------------------------------------------------------------------------
# TestShippedScenes of tests/test_demo.py
# ---------------------------------------------------------------------------


class TestShippedScenes:
    def test_gallery_loads_and_simulates(self):
        for name in GALLERY:
            loaded = load_scene_file(gallery_path(t_demo, name))
            history = simulate(loaded, frames=4, dt=0.1, verbose=False,
                               device=CPU)
            assert np.isfinite(history["muffle"]).all(), name
            loaded.registry.close()

    def test_corridor_door_occludes_and_listener_walks(self):
        loaded = load_scene_file(gallery_path(t_demo, "corridor.json"))
        assert loaded.listener_animation is not None
        history = simulate(loaded, frames=10, dt=0.2, verbose=False,
                           device=CPU)
        # The listener walked down the corridor (+z from -18).
        assert history["listener"][-1][2] > history["listener"][0][2] + 3
        loaded.registry.close()


@pytest.mark.parametrize("name", GALLERY)
def test_gallery_files_are_the_jax_packages(name):
    with open(gallery_path(t_demo, name), "rb") as a, \
            open(gallery_path(j_demo, name), "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# TestSceneValidation of tests/test_demo.py, with the JAX package's text
# ---------------------------------------------------------------------------


def base_doc():
    return {
        "trace": {"ray_count": 16},
        "colliders": [{"type": "sphere", "center": [0, 0, 4],
                       "radius": 1, "material": "concrete"}],
        "targets": [{"position": [0, 3, 0], "name": "t"}],
    }


def _set(*path_and_value):
    *path, value = path_and_value

    def edit(doc):
        node = doc
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return edit


def _append_obb(doc):
    doc["colliders"].append({"type": "obb", "center": [3, 0, 0],
                             "half_extents": [1, 1, 1],
                             "quat_xyzw": [1, 1, 1, 1]})


INVALID = [
    ("unknown_top_level_key", _set("colliderz", []), "scene.colliderz"),
    ("typod_trace_key", _set("trace", "ray_cout", 5),
     "scene.trace.ray_cout"),
    ("out_of_range_trace_value", _set("trace", "max_ray_life", -10.0),
     "scene.trace.max_ray_life"),
    ("unknown_material_name",
     _set("colliders", 0, "material", "concrete_typo"),
     "scene.colliders[0].material"),
    ("absorption_out_of_range",
     _set("materials", {"hot": {"absorption": 1.5}}),
     "scene.materials.hot.absorption"),
    ("negative_radius", _set("colliders", 0, "radius", -1.0),
     "scene.colliders[0].radius"),
    ("unknown_collider_key", _set("colliders", 0, "half_extents", [1, 1, 1]),
     "scene.colliders[0].half_extents"),
    ("bad_quat_norm", _append_obb, "scene.colliders[1].quat_xyzw"),
    ("target_index_out_of_range", _set("colliders", 0, "target", 3),
     "scene.colliders[0].target"),
    ("animation_bad_reference",
     _set("animations", [{"collider": 7, "waypoints": [[0, 0, 0]]}]),
     "scene.animations[0].collider"),
    ("animation_empty_waypoints",
     _set("animations", [{"collider": 0, "waypoints": []}]),
     "scene.animations[0].waypoints"),
    ("bad_vector_shape", _set("targets", 0, "position", [0, 3]),
     "scene.targets[0].position"),
    ("listener_waypoints_validated",
     _set("listener", {"position": [0, 0, 0], "speed": 2.0,
                       "waypoints": [[1, 2]]}),
     "scene.listener.waypoints[0]"),
    ("listener_speed_validated",
     _set("listener", {"position": [0, 0, 0], "speed": -1.0,
                       "waypoints": [[1, 2, 3]]}),
     "scene.listener.speed"),
]


class TestSceneValidation:
    def test_valid_doc_passes(self):
        build_registry(base_doc()).registry.close()

    @pytest.mark.parametrize("edit,fragment",
                             [c[1:] for c in INVALID],
                             ids=[c[0] for c in INVALID])
    def test_invalid_doc_names_the_path_as_jax_does(self, edit, fragment):
        doc = base_doc()
        edit(doc)
        with pytest.raises(SceneValidationError) as ours:
            build_registry(doc)
        assert fragment in str(ours.value), str(ours.value)
        with pytest.raises(JValidationError) as theirs:
            J.build_registry(doc)
        assert str(ours.value) == str(theirs.value)

    def test_trace_keys_are_the_jax_config_fields(self):
        assert _TRACE_FIELDS == {f.name for f in dataclasses.fields(JConfig)}
        assert _TRACE_FIELDS == {f.name
                                 for f in dataclasses.fields(TraceConfig)}

    def test_bfloat16_document_is_refused_not_traced_in_float32(self):
        # The bfloat16 tier is ported: a bfloat16 document keeps its tier
        # (never silently float32); a compute type neither package has is
        # refused by TraceConfig.
        doc = base_doc()
        doc["trace"]["compute_dtype"] = "bfloat16"
        loaded = build_registry(doc)
        assert loaded.cfg.compute_torch_dtype == torch.bfloat16
        loaded.registry.close()
        doc["trace"]["compute_dtype"] = "float16"
        with pytest.raises(ValueError, match="bfloat16"):
            build_registry(doc)


# ---------------------------------------------------------------------------
# The registry a document builds, and its animations, against JAX
# ---------------------------------------------------------------------------


def mixed_doc():
    """Euler and quaternion OBBs, target-owned colliders of every type,
    and animations of a collider, of a target (with its owned colliders)
    and of the listener."""
    c, s = math.cos(math.radians(20.0)), math.sin(math.radians(20.0))
    return {
        "trace": {"ray_count": 32, "max_bounces": 2},
        "listener": {"position": [0, 1, 0], "speed": 2.5,
                     "waypoints": [[4, 1, 0], [4, 1, 4], [0, 1, 0]]},
        "materials": {"felt": {"absorption": 0.6, "density": 0.3}},
        "colliders": [
            {"type": "obb", "center": [5, 1, 2], "half_extents": [1, 2, 0.5],
             "euler_deg": [10, 35, -15], "material": "felt"},
            {"type": "obb", "center": [-4, 1, 3], "half_extents": [2, 1, 1],
             "quat_xyzw": [0.0, s, 0.0, c],
             "material": "steel"},
            {"type": "aabb", "center": [0, -1, 0],
             "half_extents": [10, 0.5, 10], "material": "concrete"},
            {"type": "sphere", "center": [6, 1, 6], "radius": 0.5,
             "target": 0},
            {"type": "aabb", "center": [6, 2, 6],
             "half_extents": [0.3, 0.3, 0.3], "target": 0},
            {"type": "obb", "center": [-6, 1, -6],
             "half_extents": [0.4, 0.4, 0.4], "euler_deg": [0, 45, 0],
             "target": 1, "material": [0.1, 2.0, 0.5]},
        ],
        "targets": [{"position": [6, 1, 6], "name": "a"},
                    {"position": [-6, 1, -6], "name": "b"}],
        "animations": [
            {"collider": 2, "speed": 1.0,
             "waypoints": [[0, -1, 3], [0, -1, -3]]},
            {"target": 0, "speed": 4.0,
             "waypoints": [[6, 1, -6], [-6, 1, 6]]},
        ],
    }


def gallery_doc(name):
    with open(gallery_path(t_demo, name)) as f:
        return json.load(f)


DOCS = {
    "sample": lambda: sample_scene_dict(ray_count=32),
    "corridor": lambda: gallery_doc("corridor.json"),
    "listening_room": lambda: gallery_doc("listening_room.json"),
    "mixed": mixed_doc,
}


def assert_snapshots_equal(ours, theirs):
    """The port's CPU snapshot against the JAX snapshot (numpy leaves),
    field by field, exactly."""
    for kind in ("spheres", "aabbs", "obbs"):
        a, b = getattr(ours, kind), getattr(theirs, kind)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            pairs = ([(getattr(x, m), getattr(y, m))
                      for m in ("absorption", "density", "echo")]
                     if f.name == "material" else [(x, y)])
            for u, v in pairs:
                assert str(u.dtype).split(".")[-1] == str(v.dtype)
                np.testing.assert_array_equal(u.numpy(), v,
                                              err_msg=f"{kind}.{f.name}")
    np.testing.assert_array_equal(ours.target_positions.numpy(),
                                  theirs.target_positions)


@pytest.fixture(params=sorted(DOCS))
def both_loaded(request):
    doc = DOCS[request.param]()
    ours, theirs = build_registry(doc), J.build_registry(doc)
    yield ours, theirs
    ours.registry.close()
    theirs.registry.close()


def test_registry_snapshot_equals_jax(both_loaded):
    ours, theirs = both_loaded
    assert ours.target_names == theirs.target_names
    assert ours.handles == theirs.handles
    np.testing.assert_array_equal(ours.listener_position,
                                  theirs.listener_position)
    for f in dataclasses.fields(TraceConfig):
        assert getattr(ours.cfg, f.name) == getattr(theirs.cfg, f.name)
    assert_snapshots_equal(ours.registry.snapshot(device=CPU),
                           jax.tree.map(np.asarray,
                                        theirs.registry.snapshot()))
    assert ours.registry.counts() == theirs.registry.counts()


def test_animations_step_as_jax_does(both_loaded):
    # 20 steps of every animation (colliders, targets and their owned
    # colliders, the listener); positions within atol 1e-6 and the
    # snapshots after the steps equal.
    ours, theirs = both_loaded
    assert [type(a).__name__ for a in ours.animations] == \
        [type(a).__name__ for a in theirs.animations]
    dt = 0.25
    for _ in range(20):
        for a, b in zip(ours.animations, theirs.animations):
            a.step(ours.registry, dt)
            b.step(theirs.registry, dt)
            np.testing.assert_allclose(a.position, b.position, atol=1e-6)
        if ours.listener_animation is not None:
            np.testing.assert_allclose(ours.listener_animation.step(dt),
                                       theirs.listener_animation.step(dt),
                                       atol=1e-6)
    assert (ours.listener_animation is None) == \
        (theirs.listener_animation is None)
    assert_snapshots_equal(ours.registry.snapshot(device=CPU),
                           jax.tree.map(np.asarray,
                                        theirs.registry.snapshot()))


# ---------------------------------------------------------------------------
# utils/logging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("enabled", [False, True])
def test_logging_prints_what_the_jax_logger_prints(enabled, monkeypatch,
                                                    capsys):
    out = []
    for mod in (t_logging, j_logging):
        monkeypatch.setattr(mod, "ENABLED", enabled)
        mod.log("frame %d", 3)
        mod.warn("slow: %.1f ms", 17.25)
        mod.error("lost %s", "device")
        out.append(capsys.readouterr())
    assert out[0] == out[1]
    assert ("[audio-rt] frame 3" in out[0].err) == enabled
    assert "[audio-rt:error] lost device" in out[0].err
