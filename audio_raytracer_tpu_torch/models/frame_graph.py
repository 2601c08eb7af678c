"""The compiled frame: one serving frame captured as a CUDA graph.

The port's counterpart of the JAX package's jitted step (``make_forward``
returns a ``jax.jit`` step, audio_raytracer_tpu/models/raytracer.py:78-85,
and the loop jits its own, runtime/orchestrator.py:98-131): from the
second frame of a key on, a frame is one launch of one captured program,
and new scene values reach it as the contents of its input buffers.

A ``FrameGraph`` holds static buffers for the frame's inputs (origin [3],
directions [R, 3], a scene, and a ``KernelBackend`` built from that
scene with every table the frame reads), one ``torch.cuda.CUDAGraph`` of
``forward`` over them, and the frame's outputs. Per key (``key``: every
host value a launch bakes in, the config, the shapes of the inputs and
of the engine's tables, and B2's free and owned row counts):

1. the first call runs ``forward`` eagerly on the static buffers (the
   warm-up, the counterpart of JAX's first-call trace);
2. the second captures it, and it and every later call replay the graph.

A call copies its origin and directions into the static buffers. Its
scene, unless ``reuse_scene`` says it is the scene object of the call
before, is copied into the static scene, a fresh engine is built from it
eagerly, and that engine's tensors are copied into the static engine's
of the same attribute and cache key. A new key drops the graph and its
memory pool and starts again at 1. The outputs are copied out of the
graph's memory after every frame, so no later frame overwrites what a
caller holds (``perceived_position`` would otherwise alias the static
scene's target positions).

A capture or replay error raises: nothing runs eagerly on the card after
the warm-up. On the CPU there is no graph: steps 1 and 2 run the same
closure on the static buffers, so the refill, the key and the copy out
are the same code there.

Launch counts: the B1-B9 wrappers count when they enqueue a kernel. A
capture enqueues none, so the counts it made are taken back and added
again at every replay: ``run_closest_hit.launches`` and the rest keep
counting the kernels launched on the card.

``CapturedCall`` holds the key, the warm-up, capture and replays and the
launch bookkeeping, which the DSP chain's graph shares
(models/spatializer.py::SpatializeGraph). ``GraphedCall`` adds what the
frame shares with the sharded frame (parallel/sharded.py) and the
compiled training steps (models/step_graph.py): the static scene and
engine and their refill.
"""

from __future__ import annotations

import time

import torch

from audio_raytracer_tpu_torch.models.raytracer import forward
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP, PrimShardedBackend
from audio_raytracer_tpu_torch.ops.cuda import calibrate as C
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.backend import KernelBackend
from audio_raytracer_tpu_torch.types import (
    Scene,
    TargetSettings,
    TraceConfig,
    TraceResult,
    check_device,
    map_tensors,
    resolve_device,
    tensors_of,
)
from audio_raytracer_tpu_torch.utils import profiling

Tensor = torch.Tensor


def launch_counters() -> list[tuple[object, str]]:
    """(wrapper, attribute) of every launch count of B1-B9, B1's and B3's
    tree paths (``launches_bvh``) among them."""
    wrappers = (K.run_closest_hit, F.run_multi_any_hit, F.run_multi_chord,
                F.run_multi_chord_dens_bwd, F.run_multi_chord_bwd,
                K.run_any_hit, K.run_chord_loss, K.run_chord_loss_bwd,
                C.run_calibrate)
    return [(w, a) for w in wrappers
            for a in ("launches", "launches_bf16", "launches_bvh")
            if hasattr(w, a)]


def frame_skip_sets(num_targets: int) -> list[tuple[int, ...]]:
    """The skip targets of each B2 launch of a frame: the echo set's
    NO_SKIP, then one set per target (ops/trace.py::
    _secondary_occlusion), in groups of at most MAX_SETS."""
    skips = (NO_SKIP, *range(num_targets))
    return [skips[g] for g in F.set_groups(len(skips))]


def engine_state(engine) -> dict:
    """Every tensor and host int of a kernel engine by attribute and cache
    key: its tables, the derived tables of ``Fields.derived`` and the row
    counts cached beside them. Of a ``PrimShardedBackend`` over a kernel
    engine: that engine's, and the global scan ranks of its primitives
    (``_ranks``, which depend only on the shapes and the shard index)."""
    if isinstance(engine, PrimShardedBackend):
        return {**engine_state(engine.engine), "ranks": engine._ranks}
    out = {}

    def walk(name, x):
        if isinstance(x, Tensor) or isinstance(x, int):
            out[name] = x
        elif isinstance(x, K.Fields):
            for f in ("sph", "aabb", "obb"):
                walk(f"{name}.{f}", getattr(x, f))
            for k, v in x.derived.items():
                walk(f"{name}[{k!r}]", v)
        elif isinstance(x, tuple):
            for i, v in enumerate(x):
                walk(f"{name}[{i}]", v)
        else:
            raise TypeError(f"{name}: no rule for {type(x).__name__}")

    walk("fields", engine.fields)
    if engine.total:
        walk("geom_tab", engine._geom_tab)
        walk("mat_tab", engine._mat_tab)
    return out


def _describe(x):
    """A tensor's shape and dtype, or the host value itself."""
    if isinstance(x, Tensor):
        return tuple(x.shape), x.dtype
    return x


def _copy_out(out):
    """The output (a tuple, or one dataclass of tensors) with every tensor
    copied: nothing of what a caller holds lies in the static buffers or
    the graph's pool."""
    if isinstance(out, tuple):
        return tuple(map_tensors(torch.clone, x) for x in out)
    return map_tensors(torch.clone, out)


class CapturedCall:
    """A closure over static buffers run eagerly on the first call of a
    key (the warm-up), captured as one CUDA graph on the second and
    replayed from then on (``_run``), its output copied out; the key
    (``_set_key``); the launch bookkeeping.

    Counters: ``warmups``, ``captures`` and ``replays`` (calls run each
    way); host milliseconds of the latest ``capture_ms`` (capture, the
    first replay excluded) and ``replay_ms`` (graph launch and the
    output's copy). The closure's device spans accumulate into the
    call's own buffer, which its graph captures (``span_totals``)."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self._capturing = self.device.type == "cuda"
        self._spans = None
        self.key = None
        self.warmups = self.captures = self.replays = 0
        self.capture_ms = self.replay_ms = 0.0
        self._drop_graph()

    def _drop_graph(self):
        """Forget the graph, its output (in its memory pool) and its
        launch counts; the next call is a warm-up."""
        self._graph = None
        self._out = None
        self._launches = {}
        self._captured = False
        self._warm = False

    def _full_key(self, key):
        """``key`` (a tuple) with the device spans' switch, which a
        capture bakes in."""
        return (*key, ("device_spans", profiling.device_spans_enabled()))

    def _set_key(self, key):
        """A new key drops the graph and its memory pool: the next call
        is its warm-up."""
        key = self._full_key(key)
        if key != self.key:
            self._drop_graph()
            self.key = key

    def _run(self, closure, copy_out):
        """``copy_out`` of the closure's output: run eagerly on the first
        call of a key (the warm-up), captured on the second, replayed
        from then on."""
        if not self._warm:
            with profiling.span("warmup"):
                out = self._call(closure)
            with profiling.span("copy_out"):
                out = copy_out(out)
            self._check_warmup()
            self._warm = True
            self.warmups += 1
            return out
        if not self._captured:
            with profiling.span("capture"):
                self._capture(closure)
        t0 = time.perf_counter()
        with profiling.span("replay"):
            out = self._replay(closure)
        with profiling.span("copy_out"):
            out = copy_out(out)
        self.replay_ms = (time.perf_counter() - t0) * 1e3
        return out

    def _call(self, closure):
        """The closure, its device spans into the call's buffer (made on
        the card at the first warm-up, before any capture)."""
        if self._capturing and self._spans is None:
            self._spans = profiling.span_buffer(self.device)
        with profiling.spans_into(self._spans):
            return closure()

    def span_totals(self) -> dict[str, tuple[int, float]]:
        """{span: (count, device ms)} of the device spans of every frame
        or step this call has run on the card (warm-up and replays), in
        one copy to the host; empty on the CPU."""
        return profiling.totals(self._spans)

    def _check_warmup(self):
        """Raise if the warm-up left state a capture cannot make."""

    def _capture(self, closure):
        t0 = time.perf_counter()
        counters = launch_counters()
        before = [getattr(w, a) for w, a in counters]
        try:
            if self._capturing:
                graph = torch.cuda.CUDAGraph()
                # Thread-local: the backward of a training step launches
                # from autograd's device thread onto the capturing stream.
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    self._out = self._call(closure)
                self._graph = graph
        finally:
            after = [getattr(w, a) for w, a in counters]
            for (w, a), n in zip(counters, before):
                setattr(w, a, n)
        self._launches = {c: m - n for c, n, m in zip(counters, before, after)
                          if m != n}
        self._captured = True
        self.captures += 1
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _replay(self, closure):
        if not self._capturing:  # the CPU: the closure itself
            self._out = self._call(closure)
        else:
            self._graph.replay()
            for (w, a), n in self._launches.items():
                setattr(w, a, getattr(w, a) + n)
        self.replays += 1
        return self._out


class GraphedCall(CapturedCall):
    """What the compiled frame, the sharded frame (parallel/sharded.py)
    and the compiled training steps (models/step_graph.py) share beside
    ``CapturedCall``'s: a static scene and a kernel engine built from it
    (``_make_engine``), refilled from a new scene (``_refill``).

    Counters beside ``CapturedCall``'s: ``refills`` (scenes copied in),
    and host milliseconds of the latest ``refill_ms`` (scene copy, engine
    build and copy)."""

    def __init__(self, device):
        self.refills = 0
        self.refill_ms = 0.0
        self._scene = self._engine = self._state = self._source = None
        self._scene_shapes = self._engine_shapes = None
        super().__init__(device)

    def _make_engine(self, scene: Scene) -> KernelBackend:
        """A kernel engine on ``scene`` with every table the closure's
        launches read built (``KernelBackend.build_tables``)."""
        raise NotImplementedError

    def _refill(self, scene: Scene):
        """``scene`` into the static scene and the engine built from it
        into the static engine, tensor by tensor. New scene shapes
        replace the static scene, and new engine table shapes (or row
        counts) the static engine; either makes a new key."""
        with profiling.span("refill"):
            t0 = time.perf_counter()
            with profiling.span("refill.scene_copy"):
                shapes = tuple(_describe(t) for t in tensors_of(scene))
                fresh = shapes != self._scene_shapes
                if fresh:
                    self._scene = map_tensors(torch.clone, scene)
                    self._scene_shapes = shapes
                else:
                    for mine, theirs in zip(tensors_of(self._scene),
                                            tensors_of(scene)):
                        mine.copy_(theirs)
            with profiling.span("refill.engine_build"):
                engine = self._make_engine(self._scene)
                state = engine_state(engine)
            with profiling.span("refill.copy_in"):
                engine_shapes = tuple((n, _describe(v))
                                      for n, v in state.items())
                if fresh or engine_shapes != self._engine_shapes:
                    self._engine, self._state = engine, state
                    self._engine_shapes = engine_shapes
                else:
                    for n, t in state.items():
                        if isinstance(t, Tensor):
                            self._state[n].copy_(t)
        self._source = scene
        self.refills += 1
        self.refill_ms = (time.perf_counter() - t0) * 1e3

    def _check_warmup(self):
        """Raise if the warm-up built a table that ``build_tables`` did
        not: a capture would build it lazily, and a refill leave it
        stale."""
        grown = set(engine_state(self._engine)) - set(self._state)
        if grown:
            raise RuntimeError(f"the closure built tables lazily: {grown}")


class FrameGraph(GraphedCall):
    """``step(origin, directions, scene)`` -> (TraceResult, TargetSettings)
    of ``forward(..., cfg, collect_debug, backend=<kernel engine>)``, the
    frame replayed from a captured CUDA graph from the second call of a
    key on (see the module's docstring). Counters and timings as
    ``GraphedCall``'s."""

    def __init__(self, cfg: TraceConfig, collect_debug: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.collect_debug = collect_debug
        # The host values the frame bakes in beside the shapes: the key's
        # first entries.
        self._static = (cfg, collect_debug)
        self._io = None
        super().__init__(device)

    @torch.no_grad()
    def __call__(self, origin: Tensor, directions: Tensor, scene: Scene,
                 reuse_scene: bool = False):
        with profiling.span("frame.call"):
            check_device(self.device, origin=origin, directions=directions,
                         scene=scene.target_positions)
            io = tuple((tuple(x.shape), x.dtype)
                       for x in (origin, directions))
            if io != self._io:
                self._origin, self._directions = (
                    x.clone(memory_format=torch.contiguous_format)
                    for x in (origin, directions))
                self._io = io
            if not (reuse_scene and scene is self._source):
                self._refill(scene)
            self._set_key((*self._static, (io, self._scene_shapes),
                           self._engine_shapes))
            self._origin.copy_(origin)
            self._directions.copy_(directions)
            return self._run(self._frame, _copy_out)

    def _make_engine(self, scene: Scene) -> KernelBackend:
        engine = KernelBackend(scene,
                               compute_dtype=self.cfg.compute_torch_dtype)
        engine.build_tables(frame_skip_sets(scene.num_targets))
        return engine

    def _frame(self) -> tuple[TraceResult, TargetSettings]:
        return forward(self._origin, self._directions, self._scene,
                       self.cfg, self.collect_debug, backend=self._engine,
                       device=self.device)
