"""Reduce raw trace outputs to per-target audio settings.

Reference: Jobs/ProcessAudioDataJob.cs. Replicated quirks:

- Reverb stats count ZERO echo entries as "returned hits" (cs:42-45):
  ``reverb_volume`` is the fraction of (ray, bounce-slot) entries that are
  zero, unused slots and missed rays included.
- ``avgReverbDist`` divides by rayCount * maxHitsPerRay regardless of how
  many entries are nonzero (cs:49).
- Muffle: 1 - hits / (rayCount * maxHitsPerRay) * effectiveness, with the
  permeation term subtracted BEFORE saturation (cs:68-71).
- All outputs saturate to [0, 1] (DataTypes/AudioTargetRTSettings.cs:19-24).
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.types import (
    Scene,
    TargetSettings,
    TraceConfig,
    TraceResult,
)


def _saturate(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def process(result: TraceResult, scene: Scene,
            cfg: TraceConfig) -> TargetSettings:
    echo = result.echo_distances  # [R, H]
    R, H = echo.shape
    max_ray_hits = R * H

    # Reverb statistics (listener-global).
    zero_entries = torch.sum(echo == 0.0)
    avg_reverb_dist = torch.sum(echo) / max_ray_hits
    reverb_strength = avg_reverb_dist / cfg.max_reverb_distance
    reverb_volume = zero_entries.to(echo.dtype) / max_ray_hits

    # Per-target muffle from the per-batch accumulators (cs:55-75).
    total_hits = torch.sum(result.muffle_hits, dim=0).to(echo.dtype)  # [T]
    total_perm = torch.sum(result.permeation, dim=0)  # [T]
    muffle = 1.0 - total_hits / (R * H) * cfg.muffle_effectiveness
    perm_term = (total_perm / R / cfg.permeation_strength_per_ray
                 * cfg.permeation_effectiveness)
    muffle = _saturate(muffle - perm_term)

    return TargetSettings(
        muffle=muffle,
        reverb_strength=_saturate(reverb_strength),
        reverb_volume=_saturate(reverb_volume),
        perceived_position=scene.target_positions,
    )
