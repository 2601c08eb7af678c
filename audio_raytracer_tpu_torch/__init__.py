"""audio_raytracer_tpu_torch — the audio ray tracer in PyTorch and CUDA.

The port of ``audio_raytracer_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100. The JAX package stays the reference; this package imports
nothing of it. Plain tensor code is PyTorch; the rays x primitives hot
loops are CUDA C++ kernels written for Hopper (``csrc/``), built with
nvcc at first use.

Ported so far: one forward frame (``models.raytracer.forward``): the
multi-bounce trace, permeation, the reverb impulse response and the
reduce to per-target settings; the differentiable training step
(``models.differentiable``): the loudness map, materials training and
pose and source recovery, with the chord adjoints as CUDA kernels; the
runtime on one device (``runtime``): the native ``SceneRegistry`` and
the ``AsyncRaytraceLoop`` that completes frames on CUDA events; the DSP
chain (``models.spatializer``, ``utils.curves``); the conformance
runner (``python -m audio_raytracer_tpu_torch.conformance``), which
holds the port to its copy of the scalar NumPy oracle
(``utils.oracle``); and the demo layer (``demo``: scene JSON and its
schema, the scene player ``demo.scene_player`` with its WAV render, the
material calibration and pose-recovery CLI ``demo.train_materials``,
the visualizer), with ``utils.checkpoint`` and ``utils.profiling``; and
the sharded tier (``parallel``): a ('rays', 'prims') mesh of process
groups on torch.distributed, the sharded forward and materials step,
and the cluster bootstrap.
"""

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
)

__all__ = [
    "Materials",
    "Spheres",
    "Aabbs",
    "Obbs",
    "Scene",
    "TraceConfig",
    "TargetSettings",
    "TraceResult",
    "fibonacci_directions",
]
