"""Carry scenes, parameters and targets across from the JAX package.

Scenes are this system's parameters (their materials are what the
differentiable model trains). ``scene_from_arrays`` takes a scene whose
leaves the caller has turned into numpy arrays — for a JAX scene,
``jax.tree.map(np.asarray, scene)`` — and builds the PyTorch package's
``Scene`` from them; ``params_from_arrays`` and ``loudness_from_arrays``
do the same for the JAX ``SceneParams`` and ``Loudness``, so both
packages can train the same parameters toward the same target;
``adam_from_arrays`` carries optax adam's moments and count into the
port's ``torch.optim.Adam``, so a run started in JAX continues here;
``shard_from_arrays`` carries a (padded) JAX scene and its parameters to
one rank's shard of a mesh, so a shard can be held against the JAX
package's global arrays. Only attribute names are read, so any object
with the JAX structure works, and nothing of JAX is imported.

Floating fields keep the arrays' own precision: a float64 scene (the JAX
package's under ``jax_enable_x64``, as its finite-difference checks run)
arrives as float64, anything else as float32, the canonical precision.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_raytracer_tpu_torch.models.differentiable import (
    Loudness,
    SceneParams,
)
from audio_raytracer_tpu_torch.parallel.mesh import Mesh, shard_scene
from audio_raytracer_tpu_torch.parallel.train import shard_params
from audio_raytracer_tpu_torch.types import (
    Aabbs,
    Materials,
    Obbs,
    Scene,
    Spheres,
    resolve_device,
    to_tensor,
)


_MATERIAL_FIELDS = ("absorption", "density", "echo")


def _float(x, device):
    """``x`` as a tensor on ``device``: float64 stays float64 and any
    other array becomes float32."""
    wide = x.dtype == torch.float64 if isinstance(x, torch.Tensor) \
        else np.asarray(x).dtype == np.float64
    return to_tensor(x, torch.float64 if wide else torch.float32, device)


def _materials(m, device) -> Materials:
    return Materials(*(_float(getattr(m, f), device)
                       for f in _MATERIAL_FIELDS))


def _common(p, device) -> dict:
    return dict(center=_float(p.center, device),
                material=_materials(p.material, device),
                target_id=to_tensor(p.target_id, torch.int32, device),
                active=to_tensor(p.active, torch.bool, device))


def scene_from_arrays(scene, device="cuda") -> Scene:
    """The PyTorch ``Scene`` on ``device`` with the fields of ``scene``
    (numpy arrays in the JAX ``Scene`` structure), each floating field in
    its own precision."""
    device = resolve_device(device)
    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    return Scene(
        spheres=Spheres(radius=_float(sp.radius, device),
                        **_common(sp, device)),
        aabbs=Aabbs(half_extents=_float(ab.half_extents, device),
                    **_common(ab, device)),
        obbs=Obbs(half_extents=_float(ob.half_extents, device),
                  inv_rot=_float(ob.inv_rot, device),
                  **_common(ob, device)),
        target_positions=_float(scene.target_positions, device),
    )


def params_from_arrays(params, device="cuda") -> SceneParams:
    """The PyTorch ``SceneParams`` on ``device`` from the JAX
    ``SceneParams`` structure (numpy leaves), each leaf in its own
    precision."""
    device = resolve_device(device)
    return SceneParams(*(_materials(getattr(params, k), device)
                         for k in ("sphere", "aabb", "obb")))


def loudness_from_arrays(loudness, device="cuda") -> Loudness:
    """The PyTorch ``Loudness`` on ``device`` from the JAX ``Loudness``
    structure (numpy leaves; ``reverb_ir`` may be None), each field in
    its own precision."""
    device = resolve_device(device)
    ir = loudness.reverb_ir
    return Loudness(
        *(_float(getattr(loudness, k), device)
          for k in ("muffle", "permeation", "reverb_energy")),
        reverb_ir=None if ir is None else _float(ir, device))


def adam_from_arrays(mu, nu, count, optimizer):
    """Load optax ``adam``'s ``ScaleByAdamState`` into ``optimizer``, a
    ``torch.optim.Adam`` built over the same parameters (the step
    factories' ``init(params)``), and return it.

    ``mu`` and ``nu`` are the first and second moments as sequences of
    numpy arrays in the order of the parameters' leaves
    (``SceneParams.leaves()`` or ``PoseParams.leaves()``, which is the
    order of ``jax.tree.leaves`` of the JAX structure); ``count`` is the
    number of steps taken. They become each parameter's ``exp_avg``,
    ``exp_avg_sq`` and ``step``, on the parameter's device; ``step`` is a
    float32 scalar on the CPU, or on the parameter's device for a
    ``capturable`` (or ``fused``) optimizer, as each keeps it.
    """
    params, on_device = [], []
    for group in optimizer.param_groups:
        params += group["params"]
        on_device += [bool(group.get("capturable") or group.get("fused"))
                      ] * len(group["params"])
    if not len(mu) == len(nu) == len(params):
        raise ValueError(f"{len(mu)} first and {len(nu)} second moments "
                         f"for {len(params)} parameters")
    for p, m, v, here in zip(params, mu, nu, on_device):
        exp_avg = to_tensor(m, p.dtype, p.device)
        exp_avg_sq = to_tensor(v, p.dtype, p.device)
        if exp_avg.shape != p.shape or exp_avg_sq.shape != p.shape:
            raise ValueError(f"moments of shape {tuple(exp_avg.shape)} and "
                             f"{tuple(exp_avg_sq.shape)} for a parameter of "
                             f"shape {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if here else None),
            "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    return optimizer


def shard_from_arrays(scene, mesh: Mesh, params=None):
    """This rank's ``(Scene, SceneParams or None)`` shard on ``mesh.device``
    from a JAX ``Scene`` (numpy leaves, padded for the prim shards) and,
    optionally, a JAX ``SceneParams``: ``scene_from_arrays`` and
    ``params_from_arrays`` composed with ``shard_scene`` and
    ``shard_params``."""
    local = shard_scene(scene_from_arrays(scene, mesh.device), mesh)
    if params is None:
        return local, None
    return local, shard_params(params_from_arrays(params, mesh.device), mesh)
