"""Async per-frame orchestration: dispatch tracing, harvest when done.

The PyTorch counterpart of ``audio_raytracer_tpu/runtime/orchestrator.py``.
The reference's frame driver (Audio/AudioRayTracer.cs:92-238) schedules
its job graph and harvests it a frame (or more) later, skipping frames
while jobs run (``computeAsync``, AudioRaytracingManager.cs:13). Here
``tick()`` snapshots the registry (the double-buffer publish), enqueues
one forward frame on a CUDA stream the loop owns without waiting for it,
and returns the most recent *completed* frame's settings. Completion is a
``torch.cuda.Event`` recorded after the frame on that stream and polled
with ``query()``: no host thread waits on the device. With the kernel
backend the frame is the loop's ``FrameGraph`` (models/frame_graph.py),
the counterpart of the JAX loop's jitted step: from its second frame on
a tick copies the origin (and a changed snapshot) into the graph's
buffers and launches one captured CUDA graph.

With ``mesh=`` the loop serves through the sharded forward
(``parallel/sharded.py``), one process per rank (the JAX loop drives
every device of its mesh from one process). Every rank builds the loop
and calls ``tick`` in lockstep; rank 0 owns the registry and the
listener's origin and decides each tick, over the mesh's ``world``
group (``parallel/comm.py::broadcast``), whether the ranks harvest and
dispatch, and sends the origin and every changed snapshot. On a mesh
of NCCL groups with the kernel backend the rank's frame is the sharded
step's ``ShardedFrameGraph`` (parallel/sharded.py), one replay a frame as
on one card; the control record and the snapshot's broadcast stay
outside it.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from audio_raytracer_tpu_torch.models.frame_graph import FrameGraph
from audio_raytracer_tpu_torch.models.raytracer import forward, make_backend
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.parallel import comm
from audio_raytracer_tpu_torch.parallel.distributed import local_ray_slice
from audio_raytracer_tpu_torch.parallel.mesh import (
    pad_scene_for_prim_shards,
    shard_scene,
)
from audio_raytracer_tpu_torch.parallel.sharded import (
    ShardedFrameGraph,
    make_sharded_forward,
)
from audio_raytracer_tpu_torch.types import (
    Aabbs,
    Materials,
    Obbs,
    Scene,
    Spheres,
    TargetSettings,
    TraceConfig,
    resolve_device,
    tensors_of,
)
from audio_raytracer_tpu_torch.utils import profiling

# The control record rank 0 broadcasts each tick of a meshed loop:
# [proceed, origin x, y, z, snapshot follows, spheres, AABBs, OBBs,
# targets] (the counts those of the padded snapshot).
_RECORD = 9


def _zeros_scene(ns: int, na: int, no: int, targets: int, dev) -> Scene:
    """A scene of the given counts, every tensor zero: what a follower
    rank receives a snapshot into."""
    def f(*shape):
        return torch.zeros(shape, device=dev)

    def prims(n):
        return dict(center=f(n, 3), material=Materials(f(n), f(n), f(n)),
                    target_id=torch.zeros(n, dtype=torch.int32, device=dev),
                    active=torch.zeros(n, dtype=torch.bool, device=dev))

    return Scene(Spheres(radius=f(ns), **prims(ns)),
                 Aabbs(half_extents=f(na, 3), **prims(na)),
                 Obbs(half_extents=f(no, 3), inv_rot=f(no, 4), **prims(no)),
                 f(targets, 3))


def _broadcast_scene(scene: Scene, group) -> None:
    """Every tensor of ``scene`` from rank 0 into the same tensors of the
    other ranks, in one float64 broadcast (exact for the float32 fields,
    the int32 ids and the masks)."""
    parts = list(tensors_of(scene))
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in parts])
    comm.broadcast(flat, src=0, group=group)
    start = 0
    for t in parts:
        n = t.numel()
        t.copy_(flat[start:start + n].reshape(t.shape))
        start += n


class AsyncRaytraceLoop:
    """Owns the ray buffers, the side stream and one intersection engine
    per scene snapshot; one instance per listener.

    Usage per frame: ``settings = loop.tick(origin)``; returns None until
    the first frame is harvested, then always the latest completed
    TargetSettings (tensors on ``device``). ``reverb_ir`` is the latest
    completed frame's [num_reverb_bins] impulse response (None until
    harvested, or when ``cfg.num_reverb_bins == 0``).

    Instrumentation (the raytracerMs / batchCycleMs stopwatches,
    AudioRayTracer.cs:58-59,100-104,158): ``raytracer_ms`` is the DEVICE
    time of the latest harvested frame, between two CUDA events recorded
    around it on the loop's stream (on the CPU, the host time of the
    synchronous frame); the JAX loop's value is instead the host time
    until a transfer of the frame's result completed, so it also counts
    dispatch and transfer. ``batch_cycle_ms`` is the host time of the
    latest snapshot (publish and upload). ``frames_dispatched`` and
    ``frames_harvested`` count frames.

    ``backend``: "kernel" (the CUDA kernels; their plain versions on the
    CPU), "dense" (plain [rays, prims] grids) or an engine object with
    the backend protocol, used as it is for every frame.

    ``graph`` (the kernel backend; on a mesh, NCCL groups on the card,
    ``parallel/sharded.py::graphed_mesh``): each frame goes through the
    loop's ``FrameGraph`` (on a mesh its ``ShardedFrameGraph``), a
    captured CUDA graph replayed from the second frame of a key on (a
    growing registry or a changed owner or activity makes a new key; a
    moved primitive does not); ``graph_frames`` is that object. On the
    CPU, without a mesh, it runs the same frame on its static buffers.
    ``graph=False``, and a gloo mesh, enqueue every frame op by op, one
    engine per snapshot: the eager baseline the graph is measured
    against.

    ``device="cpu"`` runs every frame synchronously inside ``tick`` (a
    frame is always done when probed). The kernel engine runs in
    ``cfg.compute_dtype``'s tier.

    ``mesh`` (``parallel/mesh.py::Mesh``, this rank's): serve through
    ``make_sharded_forward(cfg with num_accum_batches = ray shards, mesh,
    return_ir=True)`` on ``mesh.device`` (``device`` is then ignored), the
    JAX loop's meshed mode (runtime/orchestrator.py:68-176). Each ray
    shard is one accumulation batch, so ``cfg.ray_count`` must divide by
    the ray shards. Every rank of the mesh builds the loop and calls
    ``tick`` (and ``reconfigure``) at the same points. Rank 0 passes the
    registry and the origin; the other ranks pass ``registry=None`` and
    ``tick()`` without one. Each tick rank 0 broadcasts a control record
    over ``mesh.world``: whether to proceed (its own in-flight frame is
    done, by its ``Event.query()`` alone, or there is none: a rank that
    dispatched while another skipped would pair the step's all-reduces
    wrongly), the origin, whether a changed snapshot follows and the
    padded snapshot's counts, and then that snapshot's tensors. A
    follower told to proceed waits for its own frame. Snapshots are padded per prim
    shard (``pad_scene_for_prim_shards``) and each rank traces its
    ``shard_scene``; registry growth changes the counts, which the
    record carries. ``control_ms`` is the host time of the latest
    tick's control broadcast, ``batch_cycle_ms`` the snapshot's (rank
    0's publish, padding and send; a follower's receive). Every rank
    returns the same settings.
    """

    def __init__(self, registry, cfg: TraceConfig, backend="kernel",
                 compute_async: bool = True, device="cuda", mesh=None,
                 graph: bool = True):
        self.mesh = mesh
        self._leader = mesh is None or dist.get_rank() == 0
        if (registry is not None) != self._leader:
            raise ValueError("rank 0 (or the loop without a mesh) owns the "
                             "registry; the other ranks of a mesh pass "
                             "registry=None")
        self.registry = registry
        self.compute_async = compute_async
        self._backend = backend
        self._graph = graph
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._scene = None
        self._engine = None
        self.graph_frames = None
        self._adopt_config(cfg)
        self._in_flight = None
        self._events = None
        self._latest = None
        self.reverb_ir = None
        # The meshed loop's snapshots: rank 0's latest from the registry,
        # the padded scene every rank holds, and this rank's shard.
        self._published = None
        self._padded = None
        self._local = None

        self.raytracer_ms = 0.0
        self.batch_cycle_ms = 0.0
        self.control_ms = 0.0
        self.frames_dispatched = 0
        self.frames_harvested = 0

    def _adopt_config(self, cfg: TraceConfig):
        """(Re)build the ray buffers (and, on a mesh, the sharded step)
        for ``cfg``."""
        directions = fibonacci_directions(cfg.ray_count, device=self.device)
        self._engine = None
        if self.mesh is None:
            self.cfg, self._directions = cfg, directions
            self.graph_frames = FrameGraph(cfg, device=self.device) \
                if self._graph and self._backend == "kernel" else None
            return
        shards = self.mesh.ray_shards
        if cfg.ray_count % shards:
            raise ValueError(f"ray_count {cfg.ray_count} does not split "
                             f"over {shards} ray shards")
        # Each ray shard is one accumulation batch, exactly the
        # reference's per-thread-batch accumulator rows.
        self._step = make_sharded_forward(
            dataclasses.replace(cfg, num_accum_batches=shards), self.mesh,
            backend=self._backend, return_ir=True, graph=self._graph)
        self.graph_frames = self._step \
            if isinstance(self._step, ShardedFrameGraph) else None
        self.cfg = cfg
        self._directions = directions[local_ray_slice(cfg.ray_count,
                                                      self.mesh)]

    def reconfigure(self, cfg: TraceConfig):
        """Adopt a changed TraceConfig mid-run — the reference's editor
        failsafe that re-allocates ray buffers when inspector params
        change (Audio/AudioRayTracer.cs:110-133). The in-flight frame
        (traced under the old config) is dropped, the directions are
        rebuilt, and the next ``tick`` dispatches under the new config;
        the latest completed settings stay available so the DSP never
        starves. No-op when nothing changed."""
        if cfg == self.cfg:
            return
        self._adopt_config(cfg)
        self._in_flight = None
        self._events = None

    def _done(self) -> bool:
        return not self._cuda or self._events[1].query()

    def _harvest(self):
        if self._cuda:
            self._events[1].synchronize()
            self.raytracer_ms = self._events[0].elapsed_time(
                self._events[1])
            # The outputs were made on the loop's stream and are read on
            # the caller's: keep their memory from reuse until the
            # caller's stream is past its work at the time they are freed.
            consumer = torch.cuda.current_stream(self.device)
            for t in tensors_of(self._in_flight[0]):
                t.record_stream(consumer)
            if self._in_flight[1] is not None:
                self._in_flight[1].record_stream(consumer)
        self._latest, self.reverb_ir = self._in_flight
        if self.reverb_ir is not None and self.reverb_ir.numel() == 0:
            self.reverb_ir = None  # the sharded step's disabled-IR shape
        self._in_flight = None
        self._events = None
        self.frames_harvested += 1

    def _dispatch(self, origin, scene):
        if scene is not self._scene:
            # One engine per snapshot: the kernel backend's tables are
            # built once per published scene, not once per frame.
            self._scene = scene
            self._engine = None
        if not self._cuda:
            t0 = time.perf_counter()
            self._in_flight = self._frame(origin, scene)
            self.raytracer_ms = (time.perf_counter() - t0) * 1e3
            return
        producer = torch.cuda.current_stream(self.device)
        stream = self._stream
        stream.wait_stream(producer)  # the snapshot's and origin's uploads
        # Memory the caller's stream allocated and this frame reads: not
        # to be reused while the frame runs, even if a later snapshot or
        # reconfigure frees it.
        for t in (origin, self._directions, *tensors_of(scene)):
            t.record_stream(stream)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            self._in_flight = self._frame(origin, scene)
            done.record(stream)
        self._events = (start, done)

    @torch.no_grad()
    def _frame(self, origin, scene):
        # The registry hands back the same snapshot object until the
        # scene changes (on a mesh, every rank keeps its shard until a
        # changed snapshot arrives): only a new one is copied in.
        if self.mesh is not None and self.graph_frames is not None:
            return self.graph_frames(origin, self._directions, scene,
                                     reuse_scene=True)
        if self.mesh is not None:
            return self._step(origin, self._directions, scene)
        if self.graph_frames is not None:
            result, settings = self.graph_frames(origin, self._directions,
                                                 scene, reuse_scene=True)
            return settings, result.reverb_ir
        if self._engine is None:
            self._engine = make_backend(scene, self._backend,
                                        self.cfg.compute_torch_dtype)
        result, settings = forward(origin, self._directions, scene,
                                   self.cfg, backend=self._engine,
                                   device=self.device)
        # The IR histogram rides along when enabled, for the DSP tail
        # stage (models/spatializer.spatialize(reverb_ir=...)).
        return settings, result.reverb_ir

    def tick(self, origin=None) -> TargetSettings | None:
        """One frame: harvest if complete, re-sync scene, dispatch next.
        ``origin``: the listener's position (rank 0's; None on the other
        ranks of a mesh). Host spans (utils/profiling.py): ``tick``, and
        on one card ``harvest``, ``snapshot`` and ``dispatch`` in it."""
        with profiling.span("tick"):
            if self.mesh is not None:
                return self._tick_meshed(origin)
            return self._tick(origin)

    def _tick(self, origin) -> TargetSettings | None:
        # 1. Harvest (the mainJobHandle.Complete() analog).
        if self._in_flight is not None:
            if self.compute_async and not self._done():
                # Frame-skip: the frame is still running
                # (AudioRayTracer.cs:95).
                return self._latest
            with profiling.span("harvest"):
                self._harvest()

        # 2. Publish scene mutations (UpdateJobBatch, cs:154-155).
        t0 = time.perf_counter()
        with profiling.span("snapshot"):
            scene = self.registry.snapshot(device=self.device)
        self.batch_cycle_ms = (time.perf_counter() - t0) * 1e3

        # 3. Dispatch (async on the card: the frame is enqueued on the
        # loop's stream and tick returns).
        if scene.num_targets > 0:
            with profiling.span("dispatch"):
                o = torch.as_tensor(origin,
                                    dtype=torch.float32).to(self.device)
                self._dispatch(o, scene)
            self.frames_dispatched += 1
        return self._latest

    def _control(self, proceed: bool, origin, changed: bool) -> list:
        """The tick's control record, rank 0's values on every rank."""
        if self._leader:
            counts = [0.0] * 4
            if proceed:
                sc = self._padded
                counts = [float(sc.spheres.count), float(sc.aabbs.count),
                          float(sc.obbs.count), float(sc.num_targets)]
            vals = [float(proceed), *origin, float(changed), *counts]
            rec = torch.tensor(vals, dtype=torch.float64, device=self.device)
        else:
            rec = torch.empty(_RECORD, dtype=torch.float64,
                              device=self.device)
        t0 = time.perf_counter()
        vals = comm.broadcast(rec, src=0, group=self.mesh.world).tolist()
        self.control_ms = (time.perf_counter() - t0) * 1e3
        return vals

    def _tick_meshed(self, origin) -> TargetSettings | None:
        if self._leader and origin is None:
            raise ValueError("rank 0's tick needs the listener's origin")
        if not self._leader and origin is not None:
            raise ValueError("only rank 0 passes the origin")
        # 1. Rank 0's probe decides for every rank.
        proceed = not (self._leader and self._in_flight is not None
                       and self.compute_async and not self._done())
        # 2. Rank 0 publishes the registry (UpdateJobBatch, cs:154-155).
        t0 = time.perf_counter()
        changed = False
        o = [0.0] * 3
        if self._leader and proceed:
            snap = self.registry.snapshot(device=self.device)
            changed = snap is not self._published
            if changed:
                self._published = snap
                self._padded = pad_scene_for_prim_shards(
                    snap, self.mesh.prim_shards)
            o = torch.as_tensor(origin, dtype=torch.float32).tolist()
        t_snap = time.perf_counter() - t0
        rec = self._control(proceed, o, changed)
        if not rec[0]:
            # Frame-skip on every rank (AudioRayTracer.cs:95).
            return self._latest
        t0 = time.perf_counter()
        if rec[4]:
            if not self._leader:
                self._padded = _zeros_scene(*(int(x) for x in rec[5:9]),
                                            self.device)
            _broadcast_scene(self._padded, self.mesh.world)
            self._local = shard_scene(self._padded, self.mesh)
        self.batch_cycle_ms = (t_snap + time.perf_counter() - t0) * 1e3
        # 3. Harvest: a follower waits for its own frame.
        if self._in_flight is not None:
            self._harvest()
        # 4. Dispatch on every rank.
        if int(rec[8]) > 0:
            o_t = torch.tensor(rec[1:4], dtype=torch.float32,
                               device=self.device)
            self._dispatch(o_t, self._local)
            self.frames_dispatched += 1
        return self._latest
