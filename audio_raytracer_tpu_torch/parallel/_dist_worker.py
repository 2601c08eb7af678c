"""One rank of the cluster check (``distributed.run_two_process_check``).

Run as ``python -m audio_raytracer_tpu_torch.parallel._dist_worker`` with
the ART_* variables ``run_two_process_check`` sets. Each worker:

1. joins the cluster (``distributed.initialize``: ART_COORDINATOR,
   ART_NUM_PROCESSES, ART_PROCESS_ID; LOCAL_RANK and LOCAL_WORLD_SIZE
   say which ranks share a host),
2. builds the hosts-major ('rays', 'prims') mesh
   (``make_distributed_mesh``: each prims group inside one host),
3. runs the sharded forward on the check workload
   (``distributed.check_workload``) with its ray slice and primitive
   shard, on the engine ART_BACKEND ("dense" or "kernel") and the device
   ART_DEVICE, the process groups on ART_DIST_BACKEND (empty: the
   device's default), and
4. on rank 0, saves the settings to ART_OUT for the parent to hold
   against the one-process reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.parallel import distributed
from audio_raytracer_tpu_torch.parallel.mesh import shard_scene
from audio_raytracer_tpu_torch.parallel.sharded import make_sharded_forward


def run():
    env = os.environ
    prim_shards = int(env.get("ART_PRIM_SHARDS", "2"))
    ray_count = int(env.get("ART_RAY_COUNT", "64"))
    device = env.get("ART_DEVICE", "cuda")
    dist_backend = env.get("ART_DIST_BACKEND") or None
    torch.set_num_threads(1)
    if not distributed.initialize(backend=dist_backend, device=device):
        raise RuntimeError("the cluster check needs ART_NUM_PROCESSES > 1")
    try:
        mesh = distributed.make_distributed_mesh(
            prim_shards, backend=dist_backend, device=device)
        cfg, scene = distributed.check_workload(
            ray_count, prim_shards, mesh.ray_shards, device=mesh.device)
        dirs = fibonacci_directions(ray_count, device=mesh.device)
        step = make_sharded_forward(cfg, mesh,
                                    backend=env.get("ART_BACKEND", "dense"))
        settings = step(torch.zeros(3, device=mesh.device),
                        dirs[distributed.local_ray_slice(ray_count, mesh)],
                        shard_scene(scene, mesh))
        rank = dist.get_rank()
        if rank == 0 and env.get("ART_OUT"):
            np.savez(env["ART_OUT"], **distributed.settings_arrays(settings))
        print(f"dist worker {rank}/{dist.get_world_size()}: ok (mesh "
              f"{mesh.ray_shards}x{mesh.prim_shards}, {mesh.device})",
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run()
