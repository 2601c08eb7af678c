"""The compiled training step: one training step captured as a CUDA graph.

The port's counterpart of the JAX package's jitted training steps
(``make_train_step``, ``make_pose_recovery_step`` and
``make_source_recovery_step`` return ``jax.jit`` steps,
audio_raytracer_tpu/models/differentiable.py:268, :327 and :386): from the
second step of a key on, a step is one launch of one captured program,
its inputs the contents of static buffers and its parameters and
optimizer state updated in place.

A ``StepGraph`` runs the body of one of those factories: the optimizer's
``zero_grad(set_to_none=False)``, the loudness map (B1 and B2 H times and
B3 once, per listener in the source step), the loss, ``backward()`` (B4,
or B5 twice per listener), and ``opt.step()``. It holds static buffers
for the step's inputs (origin or origins, directions, target or
recordings), a static scene, and a ``KernelBackend`` built from that
scene with B1's and B2's tables. Per key (``key``: every host value a
launch bakes in):

1. the first call runs the body eagerly on the static buffers (the
   warm-up): it makes every ``.grad`` and every optimizer state tensor;
2. the second captures the body as one ``torch.cuda.CUDAGraph``, and it
   and every later call replay the graph.

The parameters stay the caller's own leaf tensors and the optimizer the
caller's; the graph updates both in place. What depends on the trained
tensors is made inside the graph at every replay: the density columns of
the engine's tables and its winner-materials table
(``KernelBackend.with_materials``). What waits for the device (B2's row
selections) is made once per scene, outside it: a call with another scene
object than the call before copies it into the static scene and the
engine built from it into the static engine (``GraphedCall._refill``). The
loss (and the loudness map, where the body returns it) is copied out of
the graph's memory after every step.

The key holds the config, ``recover`` and the number of listeners, the
shapes of the inputs and of the parameters, the static scene's and
engine's table shapes and B2's row counts, and the identity of every
tensor the graph reads or writes in place: the parameters, their
gradients, the optimizer and its state tensors, and the optimizer's
hyperparameters. A moved primitive or new material values keep it.
Growth, a change of owner or activity, a new optimizer, or an
``opt.load_state_dict`` that puts new state tensors in place make a new
key: the step warms up and captures again, so a replay never updates
stale state. The step graph holds every tensor its key names, so no new
tensor can take the identity of one.

A capture or replay error raises: nothing runs eagerly on the card after
the warm-up. On the CPU there is no graph: the warm-up and the replays
run the same closure on the static buffers, so the refill, the key and
the copy out are the same code there. The launch counts of B1-B9 follow
``GraphedCall``: a capture's counts are taken back and added again at
every replay.
"""

from __future__ import annotations

import dataclasses

import torch

from audio_raytracer_tpu_torch.models.frame_graph import (
    GraphedCall,
    _copy_out,
    _describe,
    frame_skip_sets,
)
from audio_raytracer_tpu_torch.ops.cuda.backend import KernelBackend
from audio_raytracer_tpu_torch.types import (
    Scene,
    TraceConfig,
    check_device,
    map_tensors,
    tensors_of,
)

Tensor = torch.Tensor


def _fields(x):
    """Each tensor field of an input by name, None where a field is None
    (a Loudness without ``reverb_ir``)."""
    if isinstance(x, Tensor):
        return ((None, x),)
    return tuple((f.name, getattr(x, f.name))
                 for f in dataclasses.fields(x))


def _host(v):
    """A hyperparameter as a key entry: a tensor by identity."""
    return ("tensor", id(v)) if isinstance(v, Tensor) else v


class StepGraph(GraphedCall):
    """``step(params, opt, scene, *inputs) -> (params, opt, loss)``: the
    training step ``body(params, opt, scene, *inputs, backend=engine) ->
    loss``, replayed from a captured CUDA graph from the second call of a
    key on (see the module's docstring).

    ``scene_of(params, scene)`` is the scene the step traces (the
    materials or the poses of ``params`` in ``scene``), ``leaves(params)``
    the trained tensors, and ``static`` the host values of the step
    (``recover``, the number of listeners; a mesh's shape and shard
    indices) that its key holds beside the config. ``wrap(scene,
    engine)``, when given, wraps the kernel engine built at each refill
    (the sharded step's ``PrimShardedBackend``); the wrapper's
    ``with_materials`` is called at every replay. Counters and timings as
    ``GraphedCall``'s; ``loss`` is a copy out of the graph's memory. A
    body that returns ``(loss, map)`` makes the call return ``(params,
    opt, loss, map)``, both copied out."""

    def __init__(self, cfg: TraceConfig, body, scene_of, leaves,
                 static=(), device="cuda", wrap=None):
        self.cfg = cfg
        self._body, self._scene_of, self._leaves = body, scene_of, leaves
        self._wrap = wrap
        self._static = (cfg, *static)
        self._params = self._opt = self._inputs = self._io = None
        self._held = ()
        super().__init__(device)

    def __call__(self, params, opt, scene: Scene, *inputs):
        check_device(self.device, scene=scene.target_positions,
                     **{f"input {i}": t for i, x in enumerate(inputs)
                        for t in tensors_of(x)})
        io = tuple(tuple((n, None if t is None else _describe(t))
                         for n, t in _fields(x)) for x in inputs)
        if io == self._io:
            for mine, theirs in zip(self._inputs, inputs):
                for a, b in zip(tensors_of(mine), tensors_of(theirs)):
                    a.copy_(b)
        else:
            self._inputs = [map_tensors(torch.clone, x) for x in inputs]
            self._io = io
        if scene is not self._source:
            self._refill(scene)
        self._params, self._opt = params, opt
        self._set_key(self._key())
        warm = self._warm
        out = self._run(self._step, _copy_out)
        if not warm:  # the warm-up made the gradients and optimizer state
            self.key = self._full_key(self._key())
        return (params, opt, *out) if isinstance(out, tuple) else (
            params, opt, out)

    def _key(self):
        """The key of this call's parameters and optimizer (see the
        module's docstring); holds what it names by identity."""
        opt, leaves = self._opt, self._leaves(self._params)
        params = [p for g in opt.param_groups for p in g["params"]]
        grads = [p.grad for p in leaves if p.grad is not None]
        state = [v for p in params for v in opt.state.get(p, {}).values()
                 if isinstance(v, Tensor)]
        self._held = (opt, leaves, params, grads, state)
        return (self._static, self._io, self._scene_shapes,
                self._engine_shapes,
                tuple((id(p), p.data_ptr(), _describe(p)) for p in leaves),
                tuple(None if p.grad is None else id(p.grad)
                      for p in leaves),
                id(opt), tuple(id(p) for p in params),
                tuple(tuple((k, _host(v)) for k, v in g.items()
                            if k != "params") for g in opt.param_groups),
                tuple(tuple((k, _host(v)) for k, v in
                            opt.state.get(p, {}).items()) for p in params))

    def _make_engine(self, scene: Scene):
        engine = KernelBackend(scene, differentiable=True)
        engine.build_tables(frame_skip_sets(scene.num_targets))
        return engine if self._wrap is None else self._wrap(scene, engine)

    def _step(self) -> Tensor:
        engine = self._engine.with_materials(
            self._scene_of(self._params, self._scene))
        return self._body(self._params, self._opt, self._scene,
                          *self._inputs, backend=engine)
