"""Async per-frame orchestration: dispatch tracing, harvest when done.

The PyTorch counterpart of ``audio_raytracer_tpu/runtime/orchestrator.py``.
The reference's frame driver (Audio/AudioRayTracer.cs:92-238) schedules
its job graph and harvests it a frame (or more) later, skipping frames
while jobs run (``computeAsync``, AudioRaytracingManager.cs:13). Here
``tick()`` snapshots the registry (the double-buffer publish), enqueues
one forward frame on a CUDA stream the loop owns without waiting for it,
and returns the most recent *completed* frame's settings. Completion is a
``torch.cuda.Event`` recorded after the frame on that stream and polled
with ``query()``: no host thread waits on the device.
"""

from __future__ import annotations

import time

import torch

from audio_raytracer_tpu_torch.models.raytracer import forward, make_backend
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.types import (
    TargetSettings,
    TraceConfig,
    resolve_device,
    tensors_of,
)


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

    ``device="cpu"`` runs every frame synchronously inside ``tick`` (a
    frame is always done when probed). The meshed mode of the JAX loop
    is not ported yet (ROADMAP item 10b): with one process per rank, a
    serving loop has to broadcast each tick's origin and snapshot to
    every rank. The sharded forward it would serve is
    ``parallel/sharded.py``.
    """

    def __init__(self, registry, cfg: TraceConfig, backend="kernel",
                 compute_async: bool = True, device="cuda"):
        self.registry = registry
        self.compute_async = compute_async
        self._backend = backend
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._scene = None
        self._engine = None
        self._adopt_config(cfg)
        self._in_flight = None
        self._events = None
        self._latest = None
        self.reverb_ir = None

        self.raytracer_ms = 0.0
        self.batch_cycle_ms = 0.0
        self.frames_dispatched = 0
        self.frames_harvested = 0

    def _adopt_config(self, cfg: TraceConfig):
        """(Re)build the ray buffers for ``cfg``."""
        self.cfg = cfg
        self._directions = fibonacci_directions(cfg.ray_count,
                                                device=self.device)

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
        if self._engine is None:
            self._engine = make_backend(scene, self._backend)
        result, settings = forward(origin, self._directions, scene,
                                   self.cfg, backend=self._engine,
                                   device=self.device)
        # The IR histogram rides along when enabled, for the DSP tail
        # stage (models/spatializer.spatialize(reverb_ir=...)).
        return settings, result.reverb_ir

    def tick(self, origin) -> TargetSettings | None:
        """One frame: harvest if complete, re-sync scene, dispatch next."""
        # 1. Harvest (the mainJobHandle.Complete() analog).
        if self._in_flight is not None:
            if self.compute_async and not self._done():
                # Frame-skip: the frame is still running
                # (AudioRayTracer.cs:95).
                return self._latest
            self._harvest()

        # 2. Publish scene mutations (UpdateJobBatch, cs:154-155).
        t0 = time.perf_counter()
        scene = self.registry.snapshot(device=self.device)
        self.batch_cycle_ms = (time.perf_counter() - t0) * 1e3

        # 3. Dispatch (async on the card: the frame is enqueued on the
        # loop's stream and tick returns).
        if scene.num_targets > 0:
            o = torch.as_tensor(origin, dtype=torch.float32).to(self.device)
            self._dispatch(o, scene)
            self.frames_dispatched += 1
        return self._latest
