"""Permeation: sound power transmitted *through* geometry to each target.

Reference: Jobs/AudioPermeationJobBatched.cs. Per ray: find the first hit
of the primary ray; from an epsilon-offset of that point, integrate
(chord length through each collider) x material.Density toward every
audio target; the per-(batch, target) output is
``ray_count * strength - total_loss``.

Parity quirk, kept: the reference writes that value to
``PermeationPowerRemains[batchId * T + target]`` inside the per-ray loop
(cs:85), so within an accumulation batch every hitting ray OVERWRITES the
slot. The surviving value belongs to the LAST ray of the batch whose
primary ray hit anything; batches where no ray hits keep 0 (cs:43-46).
A scatter-max over hitting ray indices picks that ray.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.ops import intersect
from audio_raytracer_tpu_torch.ops.backend import DenseBackend
from audio_raytracer_tpu_torch.ops.trace import accum_batch_ids
from audio_raytracer_tpu_torch.types import Scene, TraceConfig

Tensor = torch.Tensor


def permeation(origin: Tensor, directions: Tensor, scene: Scene,
               cfg: TraceConfig, backend=None,
               total_ray_count: int | None = None,
               first_t: Tensor | None = None) -> Tensor:
    """[B, T] permeation power remains per (accum batch, target).

    ``total_ray_count`` takes the place of the ray count in the
    RayDirections.Length term of cs:260 when ``directions`` is one shard
    of a larger batch. ``first_t`` ([R], optional) is the primary-ray
    first-hit distance (TraceResult.first_hit_t); without it the scene is
    scanned again.
    """
    R = directions.shape[0]
    R_total = total_ray_count if total_ray_count is not None else R
    T = scene.num_targets
    B = cfg.num_accum_batches
    dev = directions.device
    if T == 0 or (backend is None and scene.num_primitives == 0):
        return torch.zeros((B, T), dtype=directions.dtype, device=dev)
    if backend is None:
        backend = DenseBackend(scene)

    o = origin.to(directions.dtype).expand(R, 3)
    d = directions
    t = first_t if first_t is not None else backend.closest_t(o, d)
    hit = torch.isfinite(t)

    # The overwrite quirk first: only the last hitting ray of each batch
    # survives (cs:85), so the chords run on those B rays alone.
    batch_ids = accum_batch_ids(R, B, dev)
    ray_idx = torch.arange(R, dtype=torch.int32, device=dev)
    marker = torch.where(hit, ray_idx + 1, 0)  # 0 = "no hit"
    last_plus1 = torch.zeros((B,), dtype=torch.int32, device=dev)
    last_plus1 = last_plus1.scatter_reduce(0, batch_ids, marker, "amax",
                                           include_self=True)
    any_hit_in_batch = last_plus1 > 0
    gather_idx = torch.clamp(last_plus1 - 1, min=0).long()  # [B]

    d_sel = d[gather_idx]
    t_sel = torch.where(any_hit_in_batch, t[gather_idx], 0.0)
    o_sel = o[gather_idx]
    p = o_sel + d_sel * t_sel[..., None]
    offset_point = p - d_sel * cfg.epsilon  # cs:72

    # All T target rays in one backend call (the per-target loop of
    # cs:57-89 vectorized over targets).
    dirs = []
    for ti in range(T):
        to_target = scene.target_positions[ti] - offset_point  # [B, 3]
        dirs.append(to_target / intersect.safe_norm(to_target)[..., None])
    losses = backend.multi_permeation_loss(offset_point, dirs,
                                           tuple(range(T)))  # [B, T]
    values = R_total * cfg.permeation_strength_per_ray - losses  # cs:260
    return torch.where(any_hit_in_batch[:, None], values, 0.0)
