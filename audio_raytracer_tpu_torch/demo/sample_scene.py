"""A built-in demo scene mirroring the shape of the reference's
Sample Scene.unity: a walled room with interior boxes, rotated obstacles,
spheres, two audio targets, a moving platform that periodically occludes
one target (the PlatformMover path), and an orbiting "radio" source —
a moving AudioTargetRT whose position syncs every frame and audibly pans
in the rendered WAV. The same document as the JAX package's
``demo/sample_scene.py``."""

from __future__ import annotations


def sample_scene_dict(ray_count: int = 314, max_bounces: int = 4) -> dict:
    """The demo document; ray_count defaults to the scene override (314),
    other trace values to Player.prefab (SURVEY.md §2.6)."""
    room = 20.0
    wall = 0.5
    colliders = [
        # Room shell: floor, ceiling, four walls (concrete).
        {"type": "aabb", "center": [0, -wall, 0],
         "half_extents": [room, wall, room], "material": "concrete"},
        {"type": "aabb", "center": [0, 8 + wall, 0],
         "half_extents": [room, wall, room], "material": "concrete"},
        {"type": "aabb", "center": [room, 4, 0],
         "half_extents": [wall, 4 + wall, room], "material": "concrete"},
        {"type": "aabb", "center": [-room, 4, 0],
         "half_extents": [wall, 4 + wall, room], "material": "concrete"},
        {"type": "aabb", "center": [0, 4, room],
         "half_extents": [room, 4 + wall, wall], "material": "echo"},
        {"type": "aabb", "center": [0, 4, -room],
         "half_extents": [room, 4 + wall, wall], "material": "concrete"},
        # Interior boxes.
        {"type": "aabb", "center": [6, 1, 4],
         "half_extents": [1.5, 1.0, 1.5], "material": "wood"},
        {"type": "aabb", "center": [-5, 1.5, -6],
         "half_extents": [2.0, 1.5, 1.0], "material": "wood"},
        {"type": "aabb", "center": [2, 0.75, -9],
         "half_extents": [0.75, 0.75, 0.75], "material": "steel"},
        # Rotated obstacles.
        {"type": "obb", "center": [-8, 2, 5],
         "half_extents": [2.5, 2.0, 0.4], "euler_deg": [0, 35, 0],
         "material": "concrete"},
        {"type": "obb", "center": [4, 1.2, 10],
         "half_extents": [1.2, 1.2, 1.2], "euler_deg": [20, 45, 10],
         "material": "wood"},
        {"type": "obb", "center": [10, 3, -8],
         "half_extents": [3.0, 0.3, 2.0], "euler_deg": [0, 0, 25],
         "material": "steel"},
        # Spheres.
        {"type": "sphere", "center": [0, 1.2, 8], "radius": 1.2,
         "material": "echo"},
        {"type": "sphere", "center": [-10, 1.0, -2], "radius": 1.0,
         "material": "wood"},
        # Target-owned colliders (the AudioTargetId skip path).
        {"type": "sphere", "center": [12, 1.5, 12], "radius": 0.4,
         "target": 0},
        {"type": "sphere", "center": [-12, 1.5, -12], "radius": 0.4,
         "target": 1},
        # The moving platform (animated below).
        {"type": "aabb", "center": [8, 1.5, 12],
         "half_extents": [2.0, 1.5, 2.0], "material": "concrete"},
    ]
    return {
        "trace": {
            "ray_count": ray_count,
            "max_bounces": max_bounces,
            "max_ray_life": 125.0,
            "max_muffle_hit_distance": 250.0,
            "muffle_effectiveness": 1.0,
            "permeation_effectiveness": 0.5,
            "permeation_strength_per_ray": 1.0,
            "max_reverb_distance": 35.0,
            # Impulse-response recording on so the demo renders the
            # audible convolution reverb tail (the reference leans on
            # Unity's AudioReverbFilter for this part of the sound).
            "num_reverb_bins": 32,
            "ir_max_distance": 125.0,
        },
        "listener": {"position": [0.0, 1.6, 0.0]},
        "targets": [
            {"position": [12, 1.5, 12], "name": "radio"},
            {"position": [-12, 1.5, -12], "name": "speaker"},
        ],
        "colliders": colliders,
        "animations": [
            {"collider": len(colliders) - 1, "speed": 3.0,
             "waypoints": [[8, 1.5, 12], [16, 1.5, 12], [16, 1.5, 4],
                           [8, 1.5, 4]]},
            # The "radio" source orbits the room (a moving AudioTargetRT,
            # AudioTargetRT.cs:53-62); its owned collider rides along
            # automatically, so the rendered WAV audibly pans as the
            # source circles the listener.
            {"target": 0, "speed": 6.0,
             "waypoints": [[12, 1.5, 12], [12, 1.5, -12], [-12, 1.5, -12],
                           [-12, 1.5, 12]]},
        ],
    }
