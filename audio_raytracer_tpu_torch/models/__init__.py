from audio_raytracer_tpu_torch.models.raytracer import (
    demo_inputs,
    forward,
    make_forward,
    random_scene,
)

__all__ = ["demo_inputs", "forward", "make_forward", "random_scene"]
