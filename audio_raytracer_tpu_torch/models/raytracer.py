"""The flagship model: one full audio-raytrace frame.

The per-frame pipeline of the reference orchestrator
(Audio/AudioRayTracer.cs:92-238): main trace + permeation, then the
reduce to per-target settings. Entry points run on ``device="cuda"``
unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audio_raytracer_tpu_torch.ops import permeation as permeation_op
from audio_raytracer_tpu_torch.ops import process as process_op
from audio_raytracer_tpu_torch.ops import quaternion
from audio_raytracer_tpu_torch.ops import reverb as reverb_op
from audio_raytracer_tpu_torch.ops import trace as trace_op
from audio_raytracer_tpu_torch.ops.backend import DenseBackend
from audio_raytracer_tpu_torch.ops.cuda.backend import KernelBackend
from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu_torch.types import (
    Aabbs,
    Materials,
    Obbs,
    Scene,
    Spheres,
    TargetSettings,
    TraceConfig,
    TraceResult,
    check_device,
    resolve_device,
)

Tensor = torch.Tensor

BACKENDS = {"kernel": KernelBackend, "dense": DenseBackend}


def make_backend(scene: Scene, backend, **kernel_kw):
    """The intersection engine for a backend name ("kernel" or "dense"),
    or ``backend`` itself when it is an engine object. ``kernel_kw`` go to
    ``KernelBackend`` (``differentiable``)."""
    if not isinstance(backend, str):
        return backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {sorted(BACKENDS)}")
    if backend == "kernel":
        return KernelBackend(scene, **kernel_kw)
    return BACKENDS[backend](scene)


def forward(origin: Tensor, directions: Tensor, scene: Scene,
            cfg: TraceConfig, collect_debug: bool = False,
            backend: str = "kernel",
            device="cuda") -> tuple[TraceResult, TargetSettings]:
    """One full frame: trace + permeation + reduce.

    Equivalent to one cycle of AudioRaytracerJobBatched ||
    AudioPermeationJobBatched -> ProcessAudioDataJob. ``backend``:
    "kernel" (the CUDA kernels; their plain versions on the CPU) or
    "dense" (plain [rays, prims] grids). Every input must lie on
    ``device``.
    """
    dev = resolve_device(device)
    check_device(dev, origin=origin, directions=directions,
                 scene=scene.target_positions)
    be = make_backend(scene, backend)
    if scene.num_primitives == 0:
        be = None  # trace / permeation handle the empty scene
    result = trace_op.trace(origin, directions, scene, cfg,
                            collect_debug=collect_debug, backend=be)
    perm = permeation_op.permeation(origin, directions, scene, cfg,
                                    backend=be, first_t=result.first_hit_t)
    result = dataclasses.replace(result, permeation=perm)
    if cfg.num_reverb_bins > 0:
        result = dataclasses.replace(
            result, reverb_ir=reverb_op.impulse_response(
                result.echo_distances, cfg))
    settings = process_op.process(result, scene, cfg)
    return result, settings


def make_forward(cfg: TraceConfig, collect_debug: bool = False,
                 backend: str = "kernel", device="cuda"):
    """``step(origin, directions, scene)`` with the config closed over,
    running on ``device``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(origin, directions, scene):
        return forward(origin, directions, scene, cfg, collect_debug,
                       backend, dev)

    return step


# ---------------------------------------------------------------------------
# Scene construction helpers (demo / test / benchmark content)
# ---------------------------------------------------------------------------


def random_scene(seed, num_spheres=8, num_aabbs=8, num_obbs=8, num_targets=2,
                 extent=30.0, size_range=(0.5, 3.0),
                 target_owned_colliders=False, device="cuda") -> Scene:
    """Random mixed scene in a cube of +/- extent around the origin, with
    the distributions of the JAX package's ``random_scene``.

    ``seed`` is an int or a ``numpy.random.Generator``. The draws come
    from numpy, so the same seed does not give the JAX package's scene
    (its bits come from ``jax.random``); carry a JAX scene across with
    ``convert.scene_from_arrays`` to trace the very same one.
    """
    dev = resolve_device(device)
    rng = seed if isinstance(seed, np.random.Generator) \
        else np.random.default_rng(seed)
    lo, hi = size_range

    def upos(n):
        return rng.uniform(-extent, extent, (n, 3)).astype(np.float32)

    def umat(n):
        return Materials(
            *(torch.as_tensor(rng.uniform(a, b, (n,)).astype(np.float32),
                              device=dev)
              for a, b in ((0.0, 0.3), (0.2, 2.0), (0.5, 2.0))))

    def usize(shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    spheres = Spheres.build(upos(num_spheres), usize((num_spheres,)),
                            material=umat(num_spheres), device=dev)
    aabbs = Aabbs.build(upos(num_aabbs), usize((num_aabbs, 3)),
                        material=umat(num_aabbs), device=dev)
    axis = torch.as_tensor(rng.normal(size=(num_obbs, 3)).astype(np.float32))
    angle = torch.as_tensor(
        rng.uniform(0.0, 2.0 * np.pi, (num_obbs,)).astype(np.float32))
    rot = quaternion.from_axis_angle(axis, angle)
    obbs = Obbs.build(upos(num_obbs), usize((num_obbs, 3)),
                      quaternion.inverse(rot),  # stored pre-inverted
                      material=umat(num_obbs), device=dev)
    targets = rng.uniform(-extent * 0.8, extent * 0.8,
                          (num_targets, 3)).astype(np.float32)

    if target_owned_colliders and num_targets > 0:
        # One owning sphere collider around each target exercises the
        # AudioTargetId skip path (AudioCollider.cs:30-37).
        own = Spheres.build(targets, np.full((num_targets,), 0.5),
                            target_id=np.arange(num_targets), device=dev)

        def cat(a, b):
            return torch.cat([a, b])

        spheres = Spheres(
            center=cat(spheres.center, own.center),
            radius=cat(spheres.radius, own.radius),
            material=Materials(*(cat(getattr(spheres.material, f),
                                     getattr(own.material, f))
                                 for f in ("absorption", "density", "echo"))),
            target_id=cat(spheres.target_id, own.target_id),
            active=cat(spheres.active, own.active),
        )

    return Scene(spheres=spheres, aabbs=aabbs, obbs=obbs,
                 target_positions=torch.as_tensor(targets, device=dev))


def demo_inputs(cfg: TraceConfig, device="cuda"):
    """(origin [3], directions [R, 3]) as the reference Player.prefab
    sets them: the listener at the origin, Fibonacci directions."""
    dev = resolve_device(device)
    return (torch.zeros((3,), device=dev),
            fibonacci_directions(cfg.ray_count, device=dev))
