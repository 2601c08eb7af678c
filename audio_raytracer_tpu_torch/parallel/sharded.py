"""The sharded forward over a ('rays', 'prims') mesh of process groups.

The PyTorch counterpart of ``audio_raytracer_tpu/parallel/sharded.py``.
Each rank traces its ray shard against its primitive shard with a local
engine (the CUDA kernels B1-B3, or the dense tier), and:

- the muffle, permeation and echo statistics and the reverb IR are
  summed over the ``rays`` group in one all-reduce: the collective form
  of ProcessAudioDataJob.cs:55-75's serial per-batch reduce;
- with more than one prim shard, the closest hits, occlusions and chord
  sums merge over the ``prims`` group (``ops/backend.py::
  PrimShardedBackend``).

Each ray shard IS one accumulation batch (the sharded run equals a
one-process run with ``num_accum_batches == ray_shards``), exactly the
reference's per-thread-batch accumulator rows, so the shards must be
contiguous ray ranges in rank order: ``parallel.distributed.
local_ray_slice``.
"""

from __future__ import annotations

import dataclasses

import torch

from audio_raytracer_tpu_torch.models.raytracer import make_backend
from audio_raytracer_tpu_torch.ops import permeation as permeation_op
from audio_raytracer_tpu_torch.ops import reverb as reverb_op
from audio_raytracer_tpu_torch.ops import trace as trace_op
from audio_raytracer_tpu_torch.ops.backend import PrimShardedBackend
from audio_raytracer_tpu_torch.parallel import comm
from audio_raytracer_tpu_torch.parallel.distributed import local_ray_slice
from audio_raytracer_tpu_torch.parallel.mesh import Mesh, shard_scene
from audio_raytracer_tpu_torch.types import (
    Scene,
    TargetSettings,
    TraceConfig,
    check_device,
)

Tensor = torch.Tensor


def _settings_from_partials(zero_entries, reverb_total, total_hits,
                            total_perm, scene: Scene, cfg: TraceConfig,
                            R: int, H: int) -> TargetSettings:
    """The reduce of ProcessAudioDataJob.cs:31-76 (``ops/process.py``)
    from partial sums already summed over every ray shard."""
    max_ray_hits = R * H
    reverb_strength = reverb_total / max_ray_hits / cfg.max_reverb_distance
    reverb_volume = zero_entries / max_ray_hits
    muffle = 1.0 - total_hits / max_ray_hits * cfg.muffle_effectiveness
    perm_term = (total_perm / R / cfg.permeation_strength_per_ray
                 * cfg.permeation_effectiveness)
    return TargetSettings(
        muffle=torch.clamp(muffle - perm_term, 0.0, 1.0),
        reverb_strength=torch.clamp(reverb_strength, 0.0, 1.0),
        reverb_volume=torch.clamp(reverb_volume, 0.0, 1.0),
        perceived_position=scene.target_positions)


# The intersection engine of one shard, by the JAX package's name:
# ``make_local_engine(scene_local, "kernel" | "dense", differentiable=)``.
make_local_engine = make_backend


def shard_backend(scene_local: Scene, mesh: Mesh, engine):
    """``engine`` itself on a mesh of one prim shard, else the
    ``PrimShardedBackend`` that merges it over the ``prims`` group."""
    if mesh.prim_shards == 1:
        return engine
    if scene_local.num_primitives == 0:
        raise ValueError("sharding the primitives needs a non-empty scene")
    return PrimShardedBackend(scene_local, mesh.prims, mesh.prim_shards,
                              mesh.prim_index, engine=engine)


def make_sharded_forward(cfg: TraceConfig, mesh: Mesh,
                         return_result: bool = False,
                         backend: str = "kernel",
                         elide_collectives: bool = False,
                         return_ir: bool = False):
    """``step(origin, local_dirs, local_scene)`` on this rank of ``mesh``.

    ``local_dirs`` is this rank's ray shard ([ray_count / ray_shards, 3],
    ``local_ray_slice`` of the global directions) and ``local_scene`` its
    primitive shard (``mesh.shard_scene`` of a scene padded by
    ``pad_scene_for_prim_shards``). Every rank returns the same
    ``TargetSettings``; with ``return_result``, ``(TraceResult,
    TargetSettings)`` where the result holds this rank's accumulator rows
    (echo distances of its rays, muffle_hits and permeation [1, T]) and
    the summed IR; with ``return_ir``, ``(TargetSettings, reverb_ir)``,
    the IR summed over the ray shards ([0] when ``cfg.num_reverb_bins ==
    0``).

    ``backend``: the local engine, "kernel" (B1-B3 on each rank) or
    "dense".

    ``elide_collectives`` is a timing diagnostic only, as in the JAX
    package: the ray-axis sum is skipped, so every rank does the same
    local work but the settings are this shard's partials (wrong
    numbers). Timing it beside the normal step separates the cost of the
    ray-axis collective. It cannot be combined with ``return_result`` or
    ``return_ir``.
    """
    if cfg.ray_count % mesh.ray_shards:
        raise ValueError(f"ray_count {cfg.ray_count} does not split over "
                         f"{mesh.ray_shards} ray shards")
    if elide_collectives and (return_result or return_ir):
        raise ValueError("elide_collectives returns settings only")
    if return_result and return_ir:
        raise ValueError("return_result and return_ir are exclusive")
    local_cfg = dataclasses.replace(cfg, num_accum_batches=1)
    local_rays = cfg.ray_count // mesh.ray_shards
    rays = None if elide_collectives else mesh.rays

    @torch.no_grad()
    def step(origin: Tensor, local_dirs: Tensor, local_scene: Scene):
        check_device(mesh.device, origin=origin, directions=local_dirs,
                     scene=local_scene.target_positions)
        if local_dirs.shape[0] != local_rays:
            raise ValueError(f"{local_dirs.shape[0]} rays on this shard, "
                             f"expected {local_rays}")
        be = shard_backend(local_scene, mesh,
                           make_local_engine(local_scene, backend))
        result = trace_op.trace(origin, local_dirs, local_scene, local_cfg,
                                backend=be)
        perm = permeation_op.permeation(origin, local_dirs, local_scene,
                                        local_cfg, backend=be,
                                        total_ray_count=cfg.ray_count,
                                        first_t=result.first_hit_t)
        echo = result.echo_distances
        ir = (reverb_op.impulse_response(echo, cfg)
              if cfg.num_reverb_bins > 0 else echo.new_zeros((0,)))
        # Every ray-axis partial in one all-reduce.
        zero_entries, reverb_total, total_hits, total_perm, ir = (
            comm.all_reduce_sums(
                [torch.sum(echo == 0.0).to(echo.dtype), torch.sum(echo),
                 result.muffle_hits.sum(dim=0).to(echo.dtype),
                 perm.sum(dim=0), ir], rays))
        settings = _settings_from_partials(
            zero_entries, reverb_total, total_hits, total_perm, local_scene,
            cfg, cfg.ray_count, cfg.max_hits_per_ray)
        if return_result:
            return dataclasses.replace(
                result, permeation=perm,
                reverb_ir=ir if cfg.num_reverb_bins > 0 else None), settings
        if return_ir:
            return settings, ir
        return settings

    return step


def sharded_forward(origin: Tensor, directions: Tensor, scene: Scene,
                    cfg: TraceConfig, mesh: Mesh, return_result: bool = False,
                    backend: str = "kernel"):
    """One-shot form of ``make_sharded_forward`` on the global inputs:
    this rank slices its rays out of ``directions`` [ray_count, 3] and
    its primitives out of ``scene`` (padded for the prim shards)."""
    step = make_sharded_forward(cfg, mesh, return_result, backend)
    return step(origin, directions[local_ray_slice(cfg.ray_count, mesh)],
                shard_scene(scene, mesh))
