"""JSON scene format: the framework's answer to Unity scene/prefab YAML.

The counterpart of ``audio_raytracer_tpu/demo/scene_format.py``: the same
documents build the same registry, on the port's native
``SceneRegistry``, whose ``snapshot(device=...)`` places the scene on a
device (the card unless the caller asks for ``device="cpu"``).

A scene file declares materials, colliders (AABB / OBB / sphere), audio
targets, the listener, the trace config, and waypoint animations (the
PlatformMover analog — dynamic colliders exercising the re-bake path).

Schema (all sections optional except colliders/targets):

{
  "trace":     {TraceConfig fields...},
  "listener":  {"position": [x,y,z],
                "waypoints": [[..],[..]]?, "speed": units_per_second?},
  "materials": {"name": {"absorption": a, "density": d, "echo": e}, ...},
  "colliders": [
    {"type": "aabb",   "center": [..], "half_extents": [..],
     "material": "name" | [a,d,e], "target": idx?},
    {"type": "obb",    ..., "euler_deg": [x,y,z] | "quat_xyzw": [..]},
    {"type": "sphere", "center": [..], "radius": r, ...}
  ],
  "targets":   [{"position": [..], "name": "..."}],
  "animations": [
    {"collider": index_into_colliders, "waypoints": [[..],[..]],
     "speed": units_per_second},
    {"target": index_into_targets, "waypoints": [[..],[..]],
     "speed": units_per_second}
  ]
}

A "target" animation moves an audio SOURCE (the AudioTargetRT.cs:53-62
per-frame position sync, published via AudioTargetManager.cs:105-122):
the new position feeds the muffle/permeation rays and comes back out as
TargetSettings.perceived_position for the DSP pan. Colliders owned by
the target ("target": idx on the collider) ride along automatically
with their authored offset preserved — the co-located AudioTargetRT +
AudioCollider GameObject moving as one transform.

"listener.waypoints" gives the LISTENER a scripted movement path (the
PlayerController.cs:6-81 analog for a headless framework: authored
waypoints instead of live input), using the same mover semantics as
collider/target animations.

Documents are schema-validated up front (demo/scene_schema.py): unknown
keys, unknown material names, and out-of-range values raise a
path-precise SceneValidationError before any registry state exists —
the authoring-failsafe class of AudioCollider.cs:95-118.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from audio_raytracer_tpu_torch.demo.scene_schema import validate_scene_doc
from audio_raytracer_tpu_torch.materials import MATERIAL_PRESETS
from audio_raytracer_tpu_torch.runtime.registry import SceneRegistry
from audio_raytracer_tpu_torch.types import TraceConfig


def _euler_deg_to_inv_quat_xyzw(euler_deg):
    """Unity-convention ZXY euler (degrees) -> INVERSE quaternion xyzw
    (the bake-time inversion of AudioOBBCollider.cs:59)."""
    ex, ey, ez = (math.radians(v) * 0.5 for v in euler_deg)
    sx, cx = math.sin(ex), math.cos(ex)
    sy, cy = math.sin(ey), math.cos(ey)
    sz, cz = math.sin(ez), math.cos(ez)
    x = sx * cy * cz + sy * sz * cx
    y = sy * cx * cz - sx * sz * cy
    z = sz * cx * cy - sx * sy * cz
    w = cx * cy * cz + sy * sz * sx
    return (-x, -y, -z, w)  # conjugate = inverse for unit quats


def _resolve_material(spec, materials):
    if spec is None:
        return MATERIAL_PRESETS["default"]
    if isinstance(spec, str):
        if spec in materials:
            m = materials[spec]
            return (m.get("absorption", 0.0), m.get("density", 1.0),
                    m.get("echo", 1.0))
        return MATERIAL_PRESETS[spec]
    a, d, e = spec
    return (float(a), float(d), float(e))


def _advance_waypoints(position, waypoints, wp: int, speed: float,
                       dt: float):
    """One waypoint-mover step (PlatformMover.cs:18-27 semantics): move
    from the CURRENT position toward waypoint ``wp`` at ``speed``
    units/sec, looping over the waypoint list (posId.IncrementSmart).
    The mover starts from the object's authored position, exactly like
    the reference platform's transform; a single-waypoint list is valid
    (move there, then hold). Returns (new_position, new_wp)."""
    position = np.asarray(position, float).copy()
    wp %= len(waypoints)
    target = np.asarray(waypoints[wp], float)
    delta = target - position
    dist = float(np.linalg.norm(delta))
    if dist == 0.0:
        # Already at the waypoint (e.g. authored position == first
        # waypoint): advance the index and spend this frame's movement
        # budget on the next leg, so authored-on-path movers don't lose
        # a frame.
        wp = (wp + 1) % len(waypoints)
        target = np.asarray(waypoints[wp], float)
        delta = target - position
        dist = float(np.linalg.norm(delta))
        if dist == 0.0:  # all waypoints coincide with the position
            return position, wp
    move = speed * dt
    if dist <= move:
        return target.copy(), (wp + 1) % len(waypoints)
    return position + delta / dist * move, wp


@dataclasses.dataclass
class Animation:
    """Waypoint mover for a COLLIDER: the PlatformMover dynamic-geometry
    path (re-bake through the registry each frame)."""

    handle: int
    kind: str  # collider type
    base: dict  # the collider's non-positional parameters
    waypoints: np.ndarray  # [K, 3]
    speed: float
    # Current position; build_registry seeds it with the collider's
    # AUTHORED center (the reference platform moves from its transform
    # position, not from waypoints[0]).
    position: np.ndarray | None = None
    _wp: int = 0

    def step(self, registry: SceneRegistry, dt: float):
        if self.position is None:
            self.position = np.asarray(self.waypoints[0], float).copy()
        self.position, self._wp = _advance_waypoints(
            self.position, self.waypoints, self._wp, self.speed, dt)
        kw = dict(self.base)
        if self.kind == "sphere":
            registry.update_sphere(self.handle, self.position, **kw)
        elif self.kind == "aabb":
            registry.update_aabb(self.handle, self.position, **kw)
        else:
            registry.update_obb(self.handle, self.position, **kw)


@dataclasses.dataclass
class TargetAnimation:
    """Waypoint mover for an AUDIO TARGET (moving source): the
    AudioTargetRT.cs:53-62 position sync, exercised per frame. The
    target's OWNED colliders move with it, offsets preserved (one
    GameObject carrying both an AudioTargetRT and an AudioCollider)."""

    index: int  # target index
    waypoints: np.ndarray  # [K, 3]
    speed: float
    # [(handle, kind, base_kwargs, offset [3])] for target-owned
    # colliders; filled by build_registry.
    owned: list = dataclasses.field(default_factory=list)
    # Seeded with the target's AUTHORED position by build_registry.
    position: np.ndarray | None = None
    _wp: int = 0

    def step(self, registry: SceneRegistry, dt: float):
        if self.position is None:
            self.position = np.asarray(self.waypoints[0], float).copy()
        self.position, self._wp = _advance_waypoints(
            self.position, self.waypoints, self._wp, self.speed, dt)
        registry.set_target_position(self.index, self.position)
        for handle, kind, base, offset in self.owned:
            center = self.position + offset
            if kind == "sphere":
                registry.update_sphere(handle, center, **base)
            elif kind == "aabb":
                registry.update_aabb(handle, center, **base)
            else:
                registry.update_obb(handle, center, **base)


@dataclasses.dataclass
class ListenerAnimation:
    """Waypoint mover for the LISTENER: the scripted stand-in for the
    reference's input-driven PlayerController (PlayerController.cs:6-81)
    — same mover semantics as the platform/target animations, no
    registry side effects (the listener is a per-frame trace input, not
    scene state)."""

    waypoints: np.ndarray  # [K, 3]
    speed: float
    position: np.ndarray | None = None
    _wp: int = 0

    def step(self, dt: float) -> np.ndarray:
        if self.position is None:
            self.position = np.asarray(self.waypoints[0], float).copy()
        self.position, self._wp = _advance_waypoints(
            self.position, self.waypoints, self._wp, self.speed, dt)
        return self.position


@dataclasses.dataclass
class LoadedScene:
    registry: SceneRegistry
    cfg: TraceConfig
    listener_position: np.ndarray
    animations: list[Animation]
    target_names: list[str]
    handles: list[int]
    # Scripted listener path from "listener.waypoints" (None = static).
    listener_animation: ListenerAnimation | None = None


def build_registry(doc: dict) -> LoadedScene:
    """Instantiate a scene document into a live SceneRegistry.

    The document is schema-validated first (scene_schema.py); malformed
    input raises SceneValidationError without touching registry state.
    """
    validate_scene_doc(doc)
    registry = SceneRegistry()
    materials = doc.get("materials", {})

    cfg_kwargs = doc.get("trace", {})
    cfg = TraceConfig(**cfg_kwargs)

    target_names = []
    for t in doc.get("targets", []):
        registry.add_target(t["position"])
        target_names.append(t.get("name", f"target{len(target_names)}"))

    handles = []
    collider_info = []
    for c in doc.get("colliders", []):
        mat = _resolve_material(c.get("material"), materials)
        tgt = int(c.get("target", -1))
        kind = c["type"]
        if kind == "sphere":
            h = registry.add_sphere(c["center"], c["radius"], mat, tgt)
            base = dict(radius=c["radius"], material=mat, target_id=tgt)
        elif kind == "aabb":
            h = registry.add_aabb(c["center"], c["half_extents"], mat, tgt)
            base = dict(half_extents=c["half_extents"], material=mat,
                        target_id=tgt)
        elif kind == "obb":
            if "quat_xyzw" in c:
                q = tuple(c["quat_xyzw"])
                inv_q = (-q[0], -q[1], -q[2], q[3])
            else:
                inv_q = _euler_deg_to_inv_quat_xyzw(c.get("euler_deg",
                                                          [0, 0, 0]))
            h = registry.add_obb(c["center"], c["half_extents"], inv_q, mat,
                                 tgt)
            base = dict(half_extents=c["half_extents"], inv_rot=inv_q,
                        material=mat, target_id=tgt)
        else:
            raise ValueError(f"unknown collider type {kind!r}")
        handles.append(h)
        collider_info.append((kind, base, np.asarray(c["center"], float)))

    target_positions = [np.asarray(t["position"], float)
                        for t in doc.get("targets", [])]
    animations = []
    for a in doc.get("animations", []):
        waypoints = np.asarray(a["waypoints"], float)
        speed = float(a.get("speed", 2.0))
        if "target" in a:
            ti = int(a["target"])
            # The target's owned colliders ride along, authored offsets
            # preserved (the co-located GameObject transform).
            owned = [
                (handles[i], kind, base, center - target_positions[ti])
                for i, (kind, base, center) in enumerate(collider_info)
                if base.get("target_id") == ti
            ]
            animations.append(TargetAnimation(
                index=ti, waypoints=waypoints, speed=speed, owned=owned,
                position=target_positions[ti].copy()))
            continue
        idx = a["collider"]
        kind, base, center = collider_info[idx]
        animations.append(Animation(
            handle=handles[idx], kind=kind, base=base,
            waypoints=waypoints, speed=speed, position=center.copy()))

    listener_doc = doc.get("listener", {})
    listener = np.asarray(listener_doc.get("position", [0, 0, 0]), float)
    listener_anim = None
    if "waypoints" in listener_doc:
        listener_anim = ListenerAnimation(
            waypoints=np.asarray(listener_doc["waypoints"], float),
            speed=float(listener_doc.get("speed", 2.0)),
            position=listener.copy())

    return LoadedScene(registry=registry, cfg=cfg,
                       listener_position=listener, animations=animations,
                       target_names=target_names, handles=handles,
                       listener_animation=listener_anim)


def load_scene_file(path: str) -> LoadedScene:
    with open(path) as f:
        return build_registry(json.load(f))
