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

On a mesh of NCCL process groups on the card, with the kernel engine,
the step is a ``ShardedFrameGraph``: the counterpart of the JAX
package's ``jax.jit`` of the sharded step (parallel/sharded.py:220), one
captured CUDA graph replayed from the second frame of a key on, its
all-reduce among the captured launches (``graphed_mesh`` says when).
Gloo copies through the host, which no capture can hold, so a gloo mesh,
the CPU and the dense engine run the step eagerly, with one engine per
local-scene object.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from audio_raytracer_tpu_torch.models.frame_graph import FrameGraph
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


def graphed_mesh(mesh: Mesh, backend, graph: bool = True) -> bool:
    """Does a sharded step on ``mesh`` run as one captured CUDA graph? With
    the kernel engine, on a CUDA device, when the ``rays`` and ``prims``
    groups are NCCL's, unless ``graph`` is False. Gloo copies a
    collective through the host, which a capture cannot hold."""
    return (graph and backend == "kernel" and mesh.device.type == "cuda"
            and all(dist.get_backend(g) == "nccl"
                    for g in (mesh.rays, mesh.prims)))


class ShardedFrameGraph(FrameGraph):
    """``step(origin, local_dirs, local_scene, reuse_scene=False)`` of
    ``make_sharded_forward`` on this rank, replayed from one captured CUDA
    graph from the second call of a key on, as ``FrameGraph`` replays
    ``forward``: the origin, the ray shard and the local scene in static
    buffers, a kernel engine with B1's and B2's tables built per local
    scene outside the graph (``GraphedCall._refill``; over prim shards
    wrapped in a ``PrimShardedBackend``), and ``frame`` (the sharded
    step's body: trace, permeation, IR, the ray-axis all-reduce, the
    reduce to settings) over them. The key is ``FrameGraph``'s with the
    step's options, the mesh's shape and this rank's shard indices in
    place of ``collect_debug``. Counters and timings as ``GraphedCall``'s.
    """

    def __init__(self, cfg: TraceConfig, mesh: Mesh, frame, options=()):
        self.mesh = mesh
        self._body = frame
        super().__init__(cfg, device=mesh.device)
        self._static = (cfg, *options, (mesh.ray_shards, mesh.prim_shards),
                        (mesh.ray_index, mesh.prim_index))
        self._local_rays = cfg.ray_count // mesh.ray_shards

    def __call__(self, origin: Tensor, local_dirs: Tensor,
                 local_scene: Scene, reuse_scene: bool = False):
        _check_shard(local_dirs, self._local_rays)
        return super().__call__(origin, local_dirs, local_scene,
                                reuse_scene=reuse_scene)

    def _make_engine(self, scene: Scene):
        return shard_backend(scene, self.mesh,
                             super()._make_engine(scene))

    def _frame(self):
        return self._body(self._origin, self._directions, self._scene,
                          self._engine)


def _check_shard(local_dirs: Tensor, local_rays: int) -> None:
    if local_dirs.shape[0] != local_rays:
        raise ValueError(f"{local_dirs.shape[0]} rays on this shard, "
                         f"expected {local_rays}")


def make_sharded_forward(cfg: TraceConfig, mesh: Mesh,
                         return_result: bool = False,
                         backend: str = "kernel",
                         elide_collectives: bool = False,
                         return_ir: bool = False, graph: bool = True):
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

    ``backend``: the local engine, "kernel" (B1-B3 on each rank, in
    ``cfg.compute_dtype``'s tier) or "dense".

    ``graph``: where ``graphed_mesh`` allows (the kernel engine, the card,
    NCCL groups), ``step`` is a ``ShardedFrameGraph``: the first call of
    a key runs eagerly, later ones replay one captured CUDA graph, and
    ``step(..., reuse_scene=True)`` skips the refill when the local scene
    is the object of the call before. Elsewhere, or with ``graph=False``
    (the baseline the graph is held against), the step runs eagerly and
    builds one engine per local-scene object: a scene changed in place
    must come as a new object.

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

    def frame(origin, local_dirs, local_scene, be):
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

    if graphed_mesh(mesh, backend, graph):
        return ShardedFrameGraph(cfg, mesh, frame, (
            return_result, return_ir, elide_collectives))

    engine = [None, None]  # (local scene, its engine)

    @torch.no_grad()
    def step(origin: Tensor, local_dirs: Tensor, local_scene: Scene):
        check_device(mesh.device, origin=origin, directions=local_dirs,
                     scene=local_scene.target_positions)
        _check_shard(local_dirs, local_rays)
        if engine[0] is not local_scene:
            engine[:] = local_scene, shard_backend(
                local_scene, mesh, make_local_engine(
                    local_scene, backend, cfg.compute_torch_dtype))
        return frame(origin, local_dirs, local_scene, engine[1])

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
