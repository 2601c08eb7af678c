from audio_raytracer_tpu_torch.runtime.registry import SceneRegistry
from audio_raytracer_tpu_torch.runtime.orchestrator import AsyncRaytraceLoop

__all__ = ["SceneRegistry", "AsyncRaytraceLoop"]
