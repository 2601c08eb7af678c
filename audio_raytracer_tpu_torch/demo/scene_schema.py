"""Scene-document validation: fail fast, with path-precise errors.

The counterpart of ``audio_raytracer_tpu/demo/scene_schema.py``, with the
same checks and messages.

The reference enforces authoring-time failsafes in the editor —
staticness-consistency checks (Audio/Colliders/AudioCollider.cs:95-118),
curve-bake validation (DataTypes/NativeSampledAnimationCurve.cs:39-48),
buffer re-allocation on inspector change (Audio/AudioRayTracer.cs:110-133)
— because bad authoring otherwise fails silently at runtime. The JSON
scene format is this framework's authoring surface, so it gets the same
class of failsafe: ``validate_scene_doc`` checks every section against
the schema documented in demo/scene_format.py BEFORE any registry state
is built, and raises ``SceneValidationError`` naming the exact document
path (e.g. ``scene.colliders[3].half_extents``) instead of letting a
typo'd key default silently or explode deep inside a traced frame.
The allowed ``trace`` keys are ``TraceConfig``'s fields; a document
asking for ``compute_dtype: "bfloat16"`` runs the kernels' bfloat16
tier, and ``TraceConfig`` itself refuses any other compute type
(ValueError).
"""

from __future__ import annotations

import dataclasses
import math

from audio_raytracer_tpu_torch.materials import MATERIAL_PRESETS
from audio_raytracer_tpu_torch.types import TraceConfig


class SceneValidationError(ValueError):
    """A scene document violates the schema; message carries the path."""


def _fail(path: str, msg: str):
    raise SceneValidationError(f"{path}: {msg}")


def _check_keys(obj: dict, allowed: set, path: str):
    if not isinstance(obj, dict):
        _fail(path, f"must be an object, got {type(obj).__name__}")
    unknown = set(obj) - allowed
    if unknown:
        _fail(f"{path}.{sorted(unknown)[0]}",
              f"unknown key (allowed: {sorted(allowed)})")


def _check_number(v, path: str, lo=None, hi=None, positive=False):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        _fail(path, f"must be a number, got {v!r}")
    if not math.isfinite(v):
        _fail(path, f"must be finite, got {v!r}")
    if positive and v <= 0:
        _fail(path, f"must be > 0, got {v!r}")
    if lo is not None and v < lo:
        _fail(path, f"must be >= {lo}, got {v!r}")
    if hi is not None and v > hi:
        _fail(path, f"must be <= {hi}, got {v!r}")


def _check_vec(v, path: str, n=3, positive=False):
    if (not isinstance(v, (list, tuple))) or len(v) != n:
        _fail(path, f"must be a list of {n} numbers, got {v!r}")
    for i, x in enumerate(v):
        _check_number(x, f"{path}[{i}]", positive=positive)


_TRACE_FIELDS = {f.name for f in dataclasses.fields(TraceConfig)}
# Ranges mirror the reference's inspector [Range] constraints on the
# orchestrator fields (Audio/AudioRayTracer.cs:9-35); counts must be
# positive for static-shape tracing.
_TRACE_RANGES = {
    "ray_count": dict(lo=1),
    "max_bounces": dict(lo=0),
    "max_ray_life": dict(positive=True),
    "max_muffle_hit_distance": dict(positive=True),
    "muffle_effectiveness": dict(lo=0.0),
    "permeation_effectiveness": dict(lo=0.0),
    "permeation_strength_per_ray": dict(positive=True),
    "max_reverb_distance": dict(positive=True),
    "num_reverb_bins": dict(lo=0),
    "ir_max_distance": dict(positive=True),
    "num_accum_batches": dict(lo=1),
    "epsilon": dict(positive=True),
}

_MATERIAL_FIELDS = {"absorption", "density", "echo"}


def _check_material_values(m: dict, path: str):
    _check_keys(m, _MATERIAL_FIELDS, path)
    if "absorption" in m:
        # Absorption drains life as a fraction of MaxRayLife per bounce
        # (AudioRaytracerJobBatched.cs:531); outside [0,1] is authoring
        # error. Density / echo are open-ended multipliers (the shipped
        # Wood asset uses density 5).
        _check_number(m["absorption"], f"{path}.absorption", lo=0.0, hi=1.0)
    for k in ("density", "echo"):
        if k in m:
            _check_number(m[k], f"{path}.{k}", lo=0.0)


def _check_material_ref(spec, materials: dict, path: str):
    if spec is None:
        return
    if isinstance(spec, str):
        if spec not in materials and spec not in MATERIAL_PRESETS:
            known = sorted(set(materials) | set(MATERIAL_PRESETS))
            _fail(path, f"unknown material {spec!r} (known: {known})")
        return
    if isinstance(spec, (list, tuple)):
        if len(spec) != 3:
            _fail(path, f"inline material must be [absorption, density, "
                        f"echo], got {spec!r}")
        _check_number(spec[0], f"{path}[0]", lo=0.0, hi=1.0)
        _check_number(spec[1], f"{path}[1]", lo=0.0)
        _check_number(spec[2], f"{path}[2]", lo=0.0)
        return
    _fail(path, f"must be a material name or [a, d, e] list, got {spec!r}")


_COLLIDER_KEYS = {
    "sphere": {"type", "center", "radius", "material", "target"},
    "aabb": {"type", "center", "half_extents", "material", "target"},
    "obb": {"type", "center", "half_extents", "material", "target",
            "euler_deg", "quat_xyzw"},
}


def _check_collider(c, i: int, materials: dict, num_targets: int):
    path = f"scene.colliders[{i}]"
    if not isinstance(c, dict) or "type" not in c:
        _fail(path, "must be an object with a 'type' key")
    kind = c["type"]
    if kind not in _COLLIDER_KEYS:
        _fail(f"{path}.type",
              f"unknown collider type {kind!r} "
              f"(allowed: {sorted(_COLLIDER_KEYS)})")
    _check_keys(c, _COLLIDER_KEYS[kind], path)
    if "center" not in c:
        _fail(f"{path}.center", "required")
    _check_vec(c["center"], f"{path}.center")
    if kind == "sphere":
        if "radius" not in c:
            _fail(f"{path}.radius", "required")
        _check_number(c["radius"], f"{path}.radius", positive=True)
    else:
        if "half_extents" not in c:
            _fail(f"{path}.half_extents", "required")
        _check_vec(c["half_extents"], f"{path}.half_extents", positive=True)
    if kind == "obb":
        if "euler_deg" in c and "quat_xyzw" in c:
            _fail(f"{path}.quat_xyzw",
                  "give euler_deg OR quat_xyzw, not both")
        if "euler_deg" in c:
            _check_vec(c["euler_deg"], f"{path}.euler_deg")
        if "quat_xyzw" in c:
            _check_vec(c["quat_xyzw"], f"{path}.quat_xyzw", n=4)
            norm = math.sqrt(sum(float(x) ** 2 for x in c["quat_xyzw"]))
            if abs(norm - 1.0) > 1e-3:
                _fail(f"{path}.quat_xyzw",
                      f"must be a unit quaternion (|q| = {norm:.4f})")
    _check_material_ref(c.get("material"), materials, f"{path}.material")
    if "target" in c:
        t = c["target"]
        if isinstance(t, bool) or not isinstance(t, int):
            _fail(f"{path}.target", f"must be a target index, got {t!r}")
        if not (t == -1 or 0 <= t < num_targets):
            _fail(f"{path}.target",
                  f"index {t} out of range (scene has {num_targets} "
                  f"targets)")


def _check_waypoints(a: dict, path: str):
    if "waypoints" not in a:
        _fail(f"{path}.waypoints", "required")
    wps = a["waypoints"]
    if not isinstance(wps, (list, tuple)) or len(wps) < 1:
        _fail(f"{path}.waypoints",
              f"must be a non-empty list of [x, y, z] points, got {wps!r}")
    for k, wp in enumerate(wps):
        _check_vec(wp, f"{path}.waypoints[{k}]")
    if "speed" in a:
        _check_number(a["speed"], f"{path}.speed", positive=True)


def _check_animation(a, i: int, num_colliders: int, num_targets: int):
    path = f"scene.animations[{i}]"
    _check_keys(a, {"collider", "target", "waypoints", "speed"}, path)
    has_c, has_t = "collider" in a, "target" in a
    if has_c == has_t:
        _fail(path, "must reference exactly one of 'collider' or 'target'")
    if has_c:
        c = a["collider"]
        if isinstance(c, bool) or not isinstance(c, int) \
                or not 0 <= c < num_colliders:
            _fail(f"{path}.collider",
                  f"index {c!r} out of range (scene has {num_colliders} "
                  f"colliders)")
    else:
        t = a["target"]
        if isinstance(t, bool) or not isinstance(t, int) \
                or not 0 <= t < num_targets:
            _fail(f"{path}.target",
                  f"index {t!r} out of range (scene has {num_targets} "
                  f"targets)")
    _check_waypoints(a, path)


def validate_scene_doc(doc: dict):
    """Validate a scene document against the schema; raises
    SceneValidationError (a ValueError) naming the offending path."""
    _check_keys(doc, {"trace", "listener", "materials", "colliders",
                      "targets", "animations"}, "scene")

    trace = doc.get("trace", {})
    _check_keys(trace, _TRACE_FIELDS, "scene.trace")
    for k, v in trace.items():
        if k in _TRACE_RANGES:
            if k in ("ray_count", "max_bounces", "num_reverb_bins",
                     "num_accum_batches"):
                if isinstance(v, bool) or not isinstance(v, int):
                    _fail(f"scene.trace.{k}", f"must be an integer, "
                                              f"got {v!r}")
            _check_number(v, f"scene.trace.{k}", **_TRACE_RANGES[k])

    listener = doc.get("listener", {})
    _check_keys(listener, {"position", "waypoints", "speed"},
                "scene.listener")
    if "position" in listener:
        _check_vec(listener["position"], "scene.listener.position")
    if "waypoints" in listener or "speed" in listener:
        _check_waypoints(listener, "scene.listener")

    materials = doc.get("materials", {})
    if not isinstance(materials, dict):
        _fail("scene.materials", "must be an object of named materials")
    for name, m in materials.items():
        _check_material_values(m, f"scene.materials.{name}")

    targets = doc.get("targets", [])
    if not isinstance(targets, list):
        _fail("scene.targets", "must be a list")
    for i, t in enumerate(targets):
        _check_keys(t, {"position", "name"}, f"scene.targets[{i}]")
        if "position" not in t:
            _fail(f"scene.targets[{i}].position", "required")
        _check_vec(t["position"], f"scene.targets[{i}].position")
        if "name" in t and not isinstance(t["name"], str):
            _fail(f"scene.targets[{i}].name",
                  f"must be a string, got {t['name']!r}")

    colliders = doc.get("colliders", [])
    if not isinstance(colliders, list):
        _fail("scene.colliders", "must be a list")
    for i, c in enumerate(colliders):
        _check_collider(c, i, materials, len(targets))

    animations = doc.get("animations", [])
    if not isinstance(animations, list):
        _fail("scene.animations", "must be a list")
    for i, a in enumerate(animations):
        _check_animation(a, i, len(colliders), len(targets))
