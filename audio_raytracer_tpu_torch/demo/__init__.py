"""The demo layer: scene documents, the scene player, the material
calibration and pose-recovery CLI, and the trace visualizer."""

from audio_raytracer_tpu_torch.demo.sample_scene import sample_scene_dict
from audio_raytracer_tpu_torch.demo.scene_format import (
    build_registry,
    load_scene_file,
)

__all__ = ["load_scene_file", "build_registry", "sample_scene_dict"]
