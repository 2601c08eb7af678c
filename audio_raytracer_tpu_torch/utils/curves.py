"""Sampled animation curves: piecewise-linear LUTs.

The PyTorch counterpart of ``audio_raytracer_tpu/utils/curves.py``, which
replaces DataTypes/NativeSampledAnimationCurve.cs: the reference bakes a
Unity AnimationCurve into N uniform samples and evaluates it with a
clamped lerp between the two samples around an index (cs:64-88). A curve
is its samples, so it is differentiable and lives on one device.
"""

from __future__ import annotations

import dataclasses

import torch

from audio_raytracer_tpu_torch.types import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SampledCurve:
    """Uniformly sampled curve over [0, length]."""

    samples: Tensor  # [K]
    length: Tensor  # scalar; time of the last key

    def evaluate(self, time: Tensor) -> Tensor:
        """Clamped piecewise-linear lookup, replicating
        NativeSampledAnimationCurve.EvaluateWithBurst exactly: percent =
        time / length, index = clamp(percent * (K-1), 0, K-1),
        lerp(floor, ceil). An index lerp, not an interpolation over the
        sample times."""
        k = self.samples.shape[0]
        idx = torch.clamp(time / self.length * (k - 1), 0.0, float(k - 1))
        lo = torch.floor(idx)
        frac = idx - lo
        lo = lo.long()
        hi = torch.ceil(idx).long()
        # ``take``, not ``samples[lo]``: indexing by a 0-d tensor reads
        # the index on the host, a sync that a captured graph refuses.
        return (torch.take(self.samples, lo) * (1.0 - frac)
                + torch.take(self.samples, hi) * frac)

    @staticmethod
    def linear(k: int = 50, value_multiplier: float = 1.0,
               device="cuda") -> "SampledCurve":
        """The reference's Default: identity ramp 0..1
        (AnimationCurve.Linear keys sorted to (0,0)->(1,1), 50 samples)."""
        return SampledCurve.from_fn(lambda t: t, k, 1.0, value_multiplier,
                                    device)

    @staticmethod
    def from_fn(fn, k: int = 50, length: float = 1.0,
                value_multiplier: float = 1.0,
                device="cuda") -> "SampledCurve":
        dev = resolve_device(device)
        t = torch.linspace(0.0, length, k, device=dev)
        return SampledCurve(samples=fn(t) * value_multiplier,
                            length=torch.tensor(length, device=dev))
