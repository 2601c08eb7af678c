"""Carry a scene across from the JAX package.

Scenes are this system's parameters (their materials are what the
differentiable model trains). ``scene_from_arrays`` takes a scene whose
leaves the caller has turned into numpy arrays — for a JAX scene,
``jax.tree.map(np.asarray, scene)`` — and builds the PyTorch package's
``Scene`` from them. Only attribute names are read, so any object with
the JAX ``Scene``'s structure works, and nothing of JAX is imported.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.types import (
    Aabbs,
    Materials,
    Obbs,
    Scene,
    Spheres,
    to_tensor,
)


def _materials(m, device) -> Materials:
    return Materials(*(to_tensor(getattr(m, f), torch.float32, device)
                       for f in ("absorption", "density", "echo")))


def _common(p, device) -> dict:
    return dict(center=to_tensor(p.center, torch.float32, device),
                material=_materials(p.material, device),
                target_id=to_tensor(p.target_id, torch.int32, device),
                active=to_tensor(p.active, torch.bool, device))


def scene_from_arrays(scene, device="cpu") -> Scene:
    """The PyTorch ``Scene`` on ``device`` with the fields of ``scene``
    (numpy arrays in the JAX ``Scene`` structure)."""
    f32 = torch.float32
    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    return Scene(
        spheres=Spheres(radius=to_tensor(sp.radius, f32, device),
                        **_common(sp, device)),
        aabbs=Aabbs(half_extents=to_tensor(ab.half_extents, f32, device),
                    **_common(ab, device)),
        obbs=Obbs(half_extents=to_tensor(ob.half_extents, f32, device),
                  inv_rot=to_tensor(ob.inv_rot, f32, device),
                  **_common(ob, device)),
        target_positions=to_tensor(scene.target_positions, f32, device),
    )
