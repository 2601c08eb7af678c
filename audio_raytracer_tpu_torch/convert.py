"""Carry scenes, parameters and targets across from the JAX package.

Scenes are this system's parameters (their materials are what the
differentiable model trains). ``scene_from_arrays`` takes a scene whose
leaves the caller has turned into numpy arrays — for a JAX scene,
``jax.tree.map(np.asarray, scene)`` — and builds the PyTorch package's
``Scene`` from them; ``params_from_arrays`` and ``loudness_from_arrays``
do the same for the JAX ``SceneParams`` and ``Loudness``, so both
packages can train the same parameters toward the same target. Only
attribute names are read, so any object with the JAX structure works,
and nothing of JAX is imported.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.models.differentiable import (
    Loudness,
    SceneParams,
)
from audio_raytracer_tpu_torch.types import (
    Aabbs,
    Materials,
    Obbs,
    Scene,
    Spheres,
    resolve_device,
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


def scene_from_arrays(scene, device="cuda") -> Scene:
    """The PyTorch ``Scene`` on ``device`` with the fields of ``scene``
    (numpy arrays in the JAX ``Scene`` structure)."""
    device = resolve_device(device)
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


def params_from_arrays(params, device="cuda") -> SceneParams:
    """The PyTorch ``SceneParams`` on ``device`` from the JAX
    ``SceneParams`` structure (numpy leaves)."""
    device = resolve_device(device)
    return SceneParams(*(_materials(getattr(params, k), device)
                         for k in ("sphere", "aabb", "obb")))


def loudness_from_arrays(loudness, device="cuda") -> Loudness:
    """The PyTorch ``Loudness`` on ``device`` from the JAX ``Loudness``
    structure (numpy leaves; ``reverb_ir`` may be None)."""
    device = resolve_device(device)
    ir = loudness.reverb_ir
    return Loudness(
        *(to_tensor(getattr(loudness, k), torch.float32, device)
          for k in ("muffle", "permeation", "reverb_energy")),
        reverb_ir=None if ir is None else to_tensor(ir, torch.float32,
                                                    device))
