from audio_raytracer_tpu_torch.models.differentiable import (
    Loudness,
    PoseParams,
    SceneParams,
    adam,
    loudness_loss,
    loudness_map,
    make_pose_recovery_step,
    make_source_recovery_step,
    make_train_step,
    pose_loss,
    stack_loudness,
)
from audio_raytracer_tpu_torch.models.raytracer import (
    demo_inputs,
    forward,
    make_forward,
    random_scene,
)

__all__ = [
    "Loudness",
    "PoseParams",
    "SceneParams",
    "adam",
    "demo_inputs",
    "forward",
    "loudness_loss",
    "loudness_map",
    "make_forward",
    "make_pose_recovery_step",
    "make_source_recovery_step",
    "make_train_step",
    "pose_loss",
    "random_scene",
    "stack_loudness",
]
