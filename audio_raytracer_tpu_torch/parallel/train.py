"""The sharded materials step over a ('rays', 'prims') mesh.

The PyTorch counterpart of ``audio_raytracer_tpu/parallel/train.py``:
the loudness-map loss of ``models/differentiable.py`` on each rank's ray
and primitive shard, rays data-parallel, the primitive arrays (and so
the learnable materials) split over the ``prims`` group. Every rank
computes the same loss (the ray-axis sums inside ``loudness_map`` are
replicated); ``backward`` leaves each rank the gradient of its own rays
for its own materials; a SUM over the ``rays`` group then completes it
(the all-reduce that JAX's ``shard_map`` transpose inserts for inputs
replicated over 'rays'). The materials are not summed over ``prims``:
each prim shard owns its slice.

On a mesh that ``parallel/sharded.py::graphed_mesh`` allows (the kernel
engine, the card, NCCL groups) the step is a ``StepGraph``
(models/step_graph.py), the counterpart of the JAX package's
``jax.jit`` of the sharded step (parallel/train.py:91): the whole step,
its all-reduces included, one captured CUDA graph replayed from the
second step of a key on.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.models.differentiable import (
    SceneParams,
    _backward,
    _loudness_mse,
    _trainable,
    adam,
    loudness_map,
)
from audio_raytracer_tpu_torch.models.step_graph import StepGraph
from audio_raytracer_tpu_torch.parallel import comm
from audio_raytracer_tpu_torch.parallel.mesh import Mesh, shard_rows
from audio_raytracer_tpu_torch.parallel.sharded import (
    graphed_mesh,
    make_local_engine,
    shard_backend,
)
from audio_raytracer_tpu_torch.types import Materials, TraceConfig
from audio_raytracer_tpu_torch.utils import profiling


def shard_params(params: SceneParams, mesh: Mesh) -> SceneParams:
    """This rank's slice of each material tensor (the counterpart of the
    JAX ``params_pspec``), as tensors of their own that can train."""
    def shard(m: Materials) -> Materials:
        return Materials(*(shard_rows(getattr(m, f), mesh).detach().clone()
                           for f in ("absorption", "density", "echo")))

    return SceneParams(*(shard(getattr(params, k))
                         for k in ("sphere", "aabb", "obb")))


def make_sharded_train_step(cfg: TraceConfig, mesh: Mesh, optimizer=None,
                            backend: str = "kernel", graph: bool = True):
    """Materials training on this rank of ``mesh``. Returns ``(step,
    init)``, as ``models.differentiable.make_train_step`` does:
    ``opt = init(params)`` marks this rank's 9 material tensors
    (``shard_params``) trainable and builds the optimizer over them
    (``optimizer``: a factory taking the tensors, default ``adam(1e-2)``,
    the same on every rank); ``step(params, opt, scene_geom, origin,
    local_dirs, target) -> (params, opt, loss)`` takes one step.
    ``scene_geom`` is this rank's scene shard (its materials are taken
    from ``params``), ``local_dirs`` its ray shard, ``target`` the
    replicated ``Loudness``. ``backend``: the local engine, "kernel" (B1-B3
    forward and B4 backward on each rank) or "dense".

    ``graph``: where ``graphed_mesh`` allows, ``step`` is a ``StepGraph``
    whose key also holds the mesh's shape and this rank's shard indices;
    its engine is built per scene object and, over prim shards, wrapped
    in a ``PrimShardedBackend``. ``graph=False`` gives the eager step,
    the baseline the graph is held against."""
    make_opt = optimizer or adam()

    def init(params: SceneParams):
        return make_opt(_trainable(params.leaves()))

    def body(params, opt, scene_geom, origin, local_dirs, target,
             backend=backend):
        with profiling.device_span("step.loss", mesh.device):
            opt.zero_grad(set_to_none=False)
            scene_local = params.into_scene(scene_geom)
            if isinstance(backend, str):
                backend = shard_backend(scene_local, mesh, make_local_engine(
                    scene_local, backend, differentiable=True))
            pred = loudness_map(origin, local_dirs, scene_local, cfg,
                                backend=backend, device=mesh.device,
                                group=mesh.rays,
                                total_ray_count=cfg.ray_count)
            loss = _loudness_mse(pred, target)
        leaves = params.leaves()
        _backward(loss, leaves)
        with torch.no_grad():
            for x, g in zip(leaves, comm.all_reduce_sums(
                    [x.grad for x in leaves], mesh.rays)):
                x.grad.copy_(g)
        with profiling.device_span("step.adam", mesh.device):
            opt.step()
        return loss.detach()

    if graphed_mesh(mesh, backend, graph):
        return StepGraph(
            cfg, body, SceneParams.into_scene, SceneParams.leaves,
            ("materials", (mesh.ray_shards, mesh.prim_shards),
             (mesh.ray_index, mesh.prim_index)), device=mesh.device,
            wrap=lambda scene, engine: shard_backend(scene, mesh,
                                                     engine)), init

    def step(params, opt, scene_geom, origin, local_dirs, target):
        return params, opt, body(params, opt, scene_geom, origin,
                                 local_dirs, target)

    return step, init
