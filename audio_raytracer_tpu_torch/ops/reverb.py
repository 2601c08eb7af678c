"""Reverb impulse response: echo energy over arrival-time bins.

The PyTorch counterpart of ``audio_raytracer_tpu/ops/reverb.py``. The
bins span echo distances [0, ir_max_distance) — arrival delays once
divided by the speed of sound:

    IR[b] = sum of echo energy whose distance falls in bin b

Each echo splats linearly onto its two neighbouring bins, weighted by the
fractional bin position, so the histogram is piecewise linear (and
differentiable) in the echo distances and linear in the weights; delays
beyond the window land in the last bin. Zero entries of
``echo_distances`` mean "no clear echo for this (ray, bounce) slot" and
carry no energy here (ops/process.py counts them in its reverb_volume
stat, as the reference does). The histogram is a plain sum over rays, so
under ray sharding it sums over the ray group like the muffle and
permeation accumulators.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.parallel import comm
from audio_raytracer_tpu_torch.types import TraceConfig, resolve_device

SPEED_OF_SOUND = 343.0  # m/s at 20C


def bin_times(cfg: TraceConfig, device="cuda") -> torch.Tensor:
    """[n_bins] left edge of each IR time bin, in seconds."""
    width = cfg.ir_max_distance / SPEED_OF_SOUND / cfg.num_reverb_bins
    return torch.arange(cfg.num_reverb_bins, dtype=torch.float32,
                        device=resolve_device(device)) * width


def impulse_response(echo_distances: torch.Tensor, cfg: TraceConfig,
                     weights: torch.Tensor | None = None,
                     group=None) -> torch.Tensor:
    """[n_bins] energy histogram over arrival-time bins.

    echo_distances: [..., H] (0 = no echo). ``weights``: matching energy
    weights (the per-bounce ray energy of models.differentiable); one
    unit per echo when None. With ``group`` (a process group of ray
    shards), the histogram is summed over it. Autograd reaches both
    inputs."""
    n = cfg.num_reverb_bins
    if n <= 0:
        raise ValueError(
            "set TraceConfig.num_reverb_bins > 0 for IR accumulation")
    dist = echo_distances.reshape(-1)
    has_echo = dist > 0.0
    if weights is None:
        w = has_echo.to(dist.dtype)
    else:
        w = torch.where(has_echo, weights.reshape(-1).to(dist.dtype), 0.0)

    # Fractional bin position; out-of-window energy lands in the last bin.
    bin_f = torch.clamp(dist * (n / cfg.ir_max_distance), 0.0, n - 1.0)
    i0f = torch.floor(bin_f)
    frac = bin_f - i0f  # d frac / d dist flows through bin_f
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)

    ir = torch.zeros((n,), dtype=dist.dtype, device=dist.device)
    ir.index_add_(0, i0, w * (1.0 - frac))
    ir.index_add_(0, i1, w * frac)
    return comm.all_reduce_sum(ir, group)
