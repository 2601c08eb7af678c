"""Cluster bootstrap: process groups from the environment, the mesh with
each ``prims`` group inside one host, and the multi-process checks.

The PyTorch counterpart of ``audio_raytracer_tpu/parallel/distributed.py``.
One process per rank, each with one device. At scale the ray axis spans
hosts; primitive sharding stays within a host's local ranks, so the
collectives ride the right fabric for their size:

- ``rays`` across hosts: the sums are the tiny per-target accumulators
  ([T] floats: muffle counts, permeation, reverb statistics and IR
  bins), the per-thread-batch rows the reference reduces serially
  (Jobs/ProcessAudioDataJob.cs:61-65);
- ``prims`` within a host: the closest-hit merge carries O(R_local) per
  bounce and must stay on the host's own interconnect.

Usage, once per rank process, before building a mesh:

    from audio_raytracer_tpu_torch.parallel import distributed
    distributed.initialize()          # reads ART_* or torchrun's variables
    mesh = distributed.make_distributed_mesh(prim_shards=2)
    step = make_sharded_forward(cfg, mesh)

Environment (either these or torchrun's ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``):

    ART_COORDINATOR    host:port of rank 0 (default 127.0.0.1:9911), or
                       a ``file://`` path shared by the ranks
    ART_NUM_PROCESSES  total rank processes
    ART_PROCESS_ID     this process's rank

and, in both forms, torchrun's ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
(default: one rank per host): the ranks of a host are contiguous, and
with NCCL each uses ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from audio_raytracer_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    rank_grid,
)
from audio_raytracer_tpu_torch.types import resolve_device


# The directory that holds the package, for the workers' imports.
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _local_layout(rank: int) -> tuple[int, int]:
    """(local rank, local world size) of ``rank`` from torchrun's
    variables; one rank per host when they are unset."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return int(os.environ.get("LOCAL_RANK", rank % local_world)), local_world


def local_device(device="cuda") -> torch.device:
    """This rank's device: "cuda" without an index is
    ``cuda:LOCAL_RANK``; anything else is kept as it is."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", _local_layout(rank)[0])
    return dev


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> bool:
    """Initialize the default process group from the arguments or the
    environment.

    Returns True when several processes joined, False when this is the
    only one (no environment configured): the caller then runs without a
    mesh. A second call is a no-op. ``backend`` defaults to "nccl" for a
    CUDA ``device`` (each rank then takes ``local_device(device)``) and
    "gloo" on the CPU; it is never switched: a failed initialization
    raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator or env.get("ART_COORDINATOR")
    if num_processes is None and "ART_NUM_PROCESSES" in env:
        num_processes = int(env["ART_NUM_PROCESSES"])
    if process_id is None and "ART_PROCESS_ID" in env:
        process_id = int(env["ART_PROCESS_ID"])
    if num_processes is None and "WORLD_SIZE" in env:  # torchrun
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        init_method = coordinator or "env://"
    else:
        init_method = coordinator or "127.0.0.1:9911"
    if num_processes is None or num_processes <= 1:
        return False
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        rank_dev = dev if dev.index is not None else torch.device(
            "cuda", _local_layout(process_id)[0])
        torch.cuda.set_device(rank_dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def mesh_layout(world_size: int, local_world_size: int,
                prim_shards: int) -> list[list[int]]:
    """The rank grid [ray_shards][prim_shards] of a cluster whose hosts
    each hold ``local_world_size`` contiguous ranks, with every ``prims``
    row inside one host. Raises if no such grid exists."""
    if world_size % local_world_size:
        raise ValueError(f"{world_size} ranks do not split into hosts of "
                         f"{local_world_size}")
    if local_world_size % prim_shards:
        raise ValueError(
            f"prim_shards {prim_shards} must divide the {local_world_size} "
            "local ranks of each host (the 'prims' axis must not cross "
            "hosts)")
    grid = rank_grid(world_size // prim_shards, prim_shards)
    for row in grid:
        hosts = {r // local_world_size for r in row}
        if len(hosts) != 1:
            raise AssertionError(f"prims group {row} spans hosts {hosts}")
    return grid


def make_distributed_mesh(prim_shards: int = 1, backend: str | None = None,
                          device="cuda") -> Mesh:
    """The ('rays', 'prims') mesh of the initialized cluster with each
    ``prims`` group confined to one host (``mesh_layout``): only the
    ``rays`` axis crosses hosts. ``device`` goes through
    ``local_device``."""
    world = dist.get_world_size()
    _, local_world = _local_layout(dist.get_rank())
    grid = mesh_layout(world, local_world, prim_shards)
    return make_mesh(len(grid), prim_shards, backend=backend,
                     device=local_device(device))


def local_ray_slice(ray_count: int, mesh: Mesh | None = None) -> slice:
    """This rank's contiguous slice of the global ray axis: its ray
    shard's on ``mesh``; without one, this process's share among the
    processes of the default group (all rays when there is none)."""
    if mesh is not None:
        n, i = mesh.ray_shards, mesh.ray_index
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if ray_count % n:
        raise ValueError(f"ray_count {ray_count} does not split over {n}")
    per = ray_count // n
    return slice(i * per, (i + 1) * per)


# ---------------------------------------------------------------------------
# The cluster check's workload and reference
# ---------------------------------------------------------------------------


def check_workload(ray_count: int, prim_shards: int, ray_shards: int,
                   device="cuda", muffle_effectiveness: float = 0.15,
                   permeation_effectiveness: float = 0.1):
    """The deterministic scene and config of the cluster check, shared by
    the workers (``_dist_worker``), the one-process reference
    (``dense_check_reference``) and the tests, so the compared runs
    cannot drift apart. The effectiveness values keep the muffle strictly
    inside (0, 1), so a broken sum that clamps to 0 cannot pass."""
    from audio_raytracer_tpu_torch.models.raytracer import random_scene
    from audio_raytracer_tpu_torch.parallel.mesh import (
        pad_scene_for_prim_shards,
    )
    from audio_raytracer_tpu_torch.types import TraceConfig

    cfg = TraceConfig(ray_count=ray_count, max_bounces=3,
                      max_ray_life=150.0, num_accum_batches=ray_shards,
                      num_reverb_bins=8, ir_max_distance=80.0,
                      muffle_effectiveness=muffle_effectiveness,
                      permeation_effectiveness=permeation_effectiveness)
    scene = pad_scene_for_prim_shards(
        random_scene(42, num_spheres=6, num_aabbs=10, num_obbs=8,
                     num_targets=2, extent=14.0, size_range=(1.0, 4.0),
                     device=device), prim_shards)
    return cfg, scene


def settings_arrays(settings) -> dict:
    return {k: getattr(settings, k).detach().cpu().numpy()
            for k in ("muffle", "reverb_strength", "reverb_volume")}


def dense_check_reference(ray_count: int, prim_shards: int, ray_shards: int,
                          device="cuda") -> dict:
    """The one-process dense forward on the check workload: what the
    cluster's collective outcome must equal (the reduce being checked is
    Jobs/ProcessAudioDataJob.cs:61-76)."""
    from audio_raytracer_tpu_torch.models.raytracer import forward
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions

    cfg, scene = check_workload(ray_count, prim_shards, ray_shards, device)
    dev = resolve_device(device)
    with torch.no_grad():
        _, settings = forward(torch.zeros(3, device=dev),
                              fibonacci_directions(ray_count, device=dev),
                              scene, cfg, backend="dense", device=dev)
    return settings_arrays(settings)


# ---------------------------------------------------------------------------
# Processes with a deadline
# ---------------------------------------------------------------------------


def _kill_all(procs) -> None:
    for p in procs:
        p.kill()
    for p in procs:
        p.wait(10)


def _worker_report(procs, logs, timeout) -> str:
    """The log tails of the workers that failed by themselves; of every
    worker when none did (the deadline killed them)."""
    failed = [r for r, p in enumerate(procs) if p.returncode > 0]
    parts = [] if failed else [f"cluster timed out after {timeout:.0f} s"]
    for r in failed or range(len(procs)):
        with open(logs[r]) as fh:
            parts.append(f"worker {r} failed (exit {procs[r].returncode}):"
                         f"\n{fh.read()[-2000:]}")
    return "distributed check: " + "\n".join(parts)


def run_two_process_check(ray_count: int = 64, local_ranks: int = 4,
                          prim_shards: int = 2, timeout: float = 600.0,
                          backend: str = "dense", device="cuda",
                          dist_backend: str | None = None) -> dict:
    """Start a cluster of 2 "hosts" x ``local_ranks`` rank processes
    (``python -m audio_raytracer_tpu_torch.parallel._dist_worker``) that
    run the sharded forward on the check workload over the hosts-major
    mesh, and return rank 0's settings as numpy arrays.

    It exercises the whole multi-process path: ``initialize`` from the
    ART_* variables (a file store in a temporary directory), the mesh
    with ``prims`` inside each host, the ``rays`` collectives across
    hosts. ``backend`` is each rank's engine ("dense" or "kernel"),
    ``device`` each rank's device ("cpu", or a CUDA device all ranks
    share, with ``dist_backend="gloo"`` on one card), ``dist_backend``
    that of the process groups (default: "nccl" on CUDA, "gloo" on the
    CPU). A worker that fails or a cluster that outlives ``timeout``
    seconds kills every worker and raises; the caller compares the
    result with ``dense_check_reference``."""
    world = 2 * local_ranks
    td = tempfile.mkdtemp(prefix="art_cluster_")
    out = os.path.join(td, "settings.npz")
    procs, logs = [], []
    try:
        for rank in range(world):
            env = dict(os.environ)
            env.update(
                ART_COORDINATOR=f"file://{td}/store",
                ART_NUM_PROCESSES=str(world), ART_PROCESS_ID=str(rank),
                LOCAL_RANK=str(rank % local_ranks),
                LOCAL_WORLD_SIZE=str(local_ranks),
                ART_PRIM_SHARDS=str(prim_shards),
                ART_RAY_COUNT=str(ray_count), ART_BACKEND=backend,
                ART_DEVICE=str(device), ART_DIST_BACKEND=dist_backend or "",
                ART_OUT=out, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(filter(None, (
                    _PACKAGE_PARENT, env.get("PYTHONPATH")))))
            logs.append(os.path.join(td, f"worker{rank}.log"))
            with open(logs[-1], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "audio_raytracer_tpu_torch.parallel._dist_worker"],
                    env=env, stdout=fh, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                time.sleep(0.5)  # let a peer's own failure reach its log
                _kill_all(procs)
                raise RuntimeError(_worker_report(procs, logs, timeout))
            time.sleep(0.05)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(_worker_report(procs, logs, timeout))
        with np.load(out) as data:
            return {k: data[k] for k in data.files}
    finally:
        _kill_all([p for p in procs if p.poll() is None])
        shutil.rmtree(td, ignore_errors=True)


def _spawn_entry(rank, world_size, init_method, backend, fn, args, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, args=(), timeout: float | None = 600.0,
          backend: str = "gloo") -> list:
    """Run ``fn(*args)`` on ``world_size`` fresh processes joined in one
    process group (a file store in a temporary directory, so concurrent
    runs never collide) and return their results in rank order.

    ``fn`` must be importable by module and name (the ``spawn`` start
    method pickles it by reference); it reads its rank from
    ``torch.distributed.get_rank()``, and its result comes back pickled.
    Each process uses one CPU thread. A rank that raises or dies, or a
    run that outlives ``timeout`` seconds (None: no deadline), kills
    every rank and raises here."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    td = tempfile.mkdtemp(prefix="art_spawn_")
    procs = [ctx.Process(target=_spawn_entry, args=(
        r, world_size, f"file://{td}/store", backend, fn, args, results))
        for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        got = {}
        while len(got) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.1)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if deadline is not None and \
                        time.monotonic() > deadline:
                    late = sorted(set(range(world_size)) - set(got))
                    raise RuntimeError(f"ranks {late} timed out after "
                                       f"{timeout:.0f} s")
                continue
            if not ok:
                # Collect the other ranks' errors for a moment: the first
                # to arrive may be a rank that lost its peer.
                errors, grace = {rank: value}, time.monotonic() + 1.0
                while time.monotonic() < grace:
                    try:
                        r, ok_r, v = results.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if not ok_r:
                        errors[r] = v
                raise RuntimeError("\n".join(
                    f"rank {r} failed:\n{v}" for r, v in sorted(
                        errors.items())))
            got[rank] = value
        for p in procs:
            p.join(30)
        return [got[r] for r in range(world_size)]
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        for p in alive:
            p.join(10)
        shutil.rmtree(td, ignore_errors=True)


# ---------------------------------------------------------------------------
# A program over a mesh of rank processes
# ---------------------------------------------------------------------------


def parse_mesh(text: str) -> tuple[int, int]:
    """"RxP" -> (R, P), both positive."""
    try:
        rs, ps = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {text!r}: expected RxP, e.g. 2x2")
    if rs < 1 or ps < 1:
        raise ValueError(f"mesh {text!r}: shards must be positive")
    return rs, ps


def _mesh_rank(fn, args, rs, ps, device, backend):
    """One local rank of ``run_meshed``: the mesh over the spawned group
    (the rank's own card under NCCL), then ``fn(*args, mesh)``."""
    dev = resolve_device(device)
    if backend == "nccl":
        dev = torch.device("cuda", dist.get_rank())
        torch.cuda.set_device(dev)
    return fn(*args, make_mesh(rs, ps, backend=backend, device=dev))


def run_meshed(fn, mesh: str, args=(), device="cuda", log=print,
               timeout: float | None = None):
    """Run ``fn(*args, mesh)`` on every rank of an R x P ('rays',
    'prims') mesh (``mesh`` is "RxP") and return rank 0's result.

    Under torchrun or the ART_* variables (``initialize``) this process
    is one rank of the cluster, and returns its own result. Otherwise
    R x P local ranks are started (``spawn``; ``fn`` must be importable
    by module and name): NCCL with one card each where there are cards
    enough, else gloo with the ranks sharing ``device``. The first
    ``log`` line says which. ``timeout`` is the local ranks' deadline
    (None: none; a rank that fails still stops them all)."""
    rs, ps = parse_mesh(mesh)
    world = rs * ps
    if initialize(device=device):
        try:
            grid = make_distributed_mesh(ps, device=device)
            if grid.ray_shards != rs:
                raise ValueError(f"mesh {mesh} on {dist.get_world_size()} "
                                 "ranks")
            if dist.get_rank() == 0:
                log(f"mesh {rs}x{ps} of {world} ranks from the environment "
                    f"over {dist.get_backend()}")
            return fn(*args, grid)
        finally:
            dist.destroy_process_group()
    dev = resolve_device(device)
    one_each = dev.type == "cuda" and torch.cuda.device_count() >= world
    backend = "nccl" if one_each else "gloo"
    log(f"mesh {rs}x{ps}, {world} local ranks over {backend}"
        + (", one card each" if one_each else f", sharing {dev}"))
    return spawn(_mesh_rank, world, (fn, args, rs, ps, device, backend),
                 timeout=timeout, backend=backend)[0]
