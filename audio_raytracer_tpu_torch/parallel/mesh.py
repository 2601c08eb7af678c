"""The ('rays', 'prims') mesh of process groups, and primitive sharding.

The PyTorch counterpart of ``audio_raytracer_tpu/parallel/mesh.py``. The
reference scales by splitting the ray range over CPU job-worker threads
(Audio/AudioRayTracer.cs:161). Here one process per rank holds one
device, and the ranks form a 2-D grid: rays are data-parallel shards
along one axis and, for large collider counts, the primitives are split
along the other, closest hits merged by collectives over the ``prims``
group (``ops/backend.py::PrimShardedBackend``).

Rank r sits at (ray_index, prim_index) = divmod(r, prim_shards), the
row-major order of the JAX package's ``reshape(ray_shards,
prim_shards)``. This rank's ``rays`` group is its column (the ranks that
hold the same primitives and other rays), its ``prims`` group its row.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from audio_raytracer_tpu_torch.types import (
    Aabbs,
    Materials,
    Obbs,
    Scene,
    Spheres,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: its ``rays`` and ``prims`` process
    groups, its (ray_index, prim_index) and its device; ``world``, the
    group of every rank of the mesh (the serving loop's broadcasts)."""

    ray_shards: int
    prim_shards: int
    ray_index: int
    prim_index: int
    rays: object
    prims: object
    device: torch.device
    world: object


def rank_grid(ray_shards: int, prim_shards: int) -> list[list[int]]:
    """The global ranks of the mesh, [ray_shards][prim_shards], row-major."""
    return [[i * prim_shards + j for j in range(prim_shards)]
            for i in range(ray_shards)]


def make_mesh(ray_shards: int | None = None, prim_shards: int = 1,
              backend: str | None = None, device=None) -> Mesh:
    """This rank's ``Mesh`` over every rank of the default process group,
    which must be initialized (``parallel.distributed.initialize`` or
    ``torch.distributed.init_process_group``).

    ``ray_shards`` defaults to world size / ``prim_shards``. The groups'
    ``backend`` defaults to "nccl" for a CUDA ``device`` and "gloo" on the
    CPU; ``device`` (this rank's) defaults to "cuda". Every rank creates
    every group (the world's, then the ``rays`` and ``prims`` groups), in
    the same order, as ``new_group`` requires."""
    world = dist.get_world_size()
    if ray_shards is None:
        ray_shards = world // prim_shards
    if ray_shards * prim_shards != world:
        raise ValueError(f"mesh {ray_shards}x{prim_shards} != {world} ranks")
    dev = resolve_device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    grid = rank_grid(ray_shards, prim_shards)
    ray_index, prim_index = divmod(dist.get_rank(), prim_shards)
    everyone = dist.new_group(list(range(world)), backend=backend)
    rays = prims = None
    for j in range(prim_shards):
        g = dist.new_group([row[j] for row in grid], backend=backend)
        if j == prim_index:
            rays = g
    for i in range(ray_shards):
        g = dist.new_group(grid[i], backend=backend)
        if i == ray_index:
            prims = g
    return Mesh(ray_shards, prim_shards, ray_index, prim_index, rays, prims,
                dev, everyone)


def _pad_axis(x, n, fill=0.0):
    if n == 0:
        return x
    return torch.cat([x, x.new_full((n,) + x.shape[1:], fill)])


def _pad_materials(m: Materials, n: int) -> Materials:
    return Materials(*(_pad_axis(getattr(m, f), n)
                       for f in ("absorption", "density", "echo")))


def pad_scene_for_prim_shards(scene: Scene, prim_shards: int) -> Scene:
    """Pad each primitive array with inactive entries (target -1, identity
    quaternions for OBBs) so every type's count divides by
    ``prim_shards``."""
    def pad(p, n, **extra):
        return dict(center=_pad_axis(p.center, n),
                    material=_pad_materials(p.material, n),
                    target_id=_pad_axis(p.target_id, n, -1),
                    active=_pad_axis(p.active, n, False), **extra)

    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    ns, na, nb = ((-p.count) % prim_shards for p in (sp, ab, ob))
    identity = ob.inv_rot.new_zeros((nb, 4))
    identity[:, 3] = 1.0
    return dataclasses.replace(
        scene,
        spheres=Spheres(radius=_pad_axis(sp.radius, ns), **pad(sp, ns)),
        aabbs=Aabbs(half_extents=_pad_axis(ab.half_extents, na),
                    **pad(ab, na)),
        obbs=Obbs(half_extents=_pad_axis(ob.half_extents, nb),
                  inv_rot=torch.cat([ob.inv_rot, identity]), **pad(ob, nb)))


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous share of ``x``'s leading axis, split over
    the ``prims`` axis (the counterpart of ``PartitionSpec('prims')``)."""
    n = x.shape[0]
    if n % mesh.prim_shards:
        raise ValueError(f"{n} primitives do not split over "
                         f"{mesh.prim_shards} prim shards: pad the scene "
                         "with pad_scene_for_prim_shards")
    per = n // mesh.prim_shards
    return x[mesh.prim_index * per:(mesh.prim_index + 1) * per]


def _shard_fields(obj, mesh: Mesh):
    """Every tensor field of a primitive set (materials included) sliced
    by ``shard_rows``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (_shard_fields(v, mesh) if dataclasses.is_dataclass(v)
                       else shard_rows(v, mesh))
    return type(obj)(**out)


def shard_scene(scene: Scene, mesh: Mesh) -> Scene:
    """This rank's shard of a (padded) scene: a contiguous slice of each
    primitive type; the target positions are replicated. The counterpart
    of the JAX ``scene_pspec``."""
    return dataclasses.replace(
        scene, spheres=_shard_fields(scene.spheres, mesh),
        aabbs=_shard_fields(scene.aabbs, mesh),
        obbs=_shard_fields(scene.obbs, mesh))
