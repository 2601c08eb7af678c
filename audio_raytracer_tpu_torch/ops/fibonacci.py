"""Fibonacci-sphere ray directions.

Reference: Jobs/FibonacciDirectionsJobParallel.cs:25-34 — golden-angle
spiral: phi = pi (3 - sqrt 5), y_i = 1 - 2 i / (n - 1), r = sqrt(1 - y^2),
theta = phi i, dir = (cos(theta) r, y, sin(theta) r).
"""

from __future__ import annotations

import math

import torch

from audio_raytracer_tpu_torch.types import resolve_device


def fibonacci_directions(count: int, device="cuda",
                         dtype=torch.float32) -> torch.Tensor:
    """[count, 3] directions on the unit sphere, on ``device``, computed
    in ``dtype`` (float32, or float64 for the float64 checks).

    Keeps the reference's n - 1 denominator, so the first and last rays
    sit at the poles, and ``count=1`` gives NaN (0 / 0), as it does
    there.
    """
    device = resolve_device(device)
    i = torch.arange(count, dtype=dtype, device=device)
    # Arithmetic in ``dtype`` throughout, as the reference package
    # computes it.
    five = torch.tensor(5.0, dtype=dtype, device=device)
    phi = math.pi * (3.0 - torch.sqrt(five))
    denom = torch.tensor(count - 1, dtype=dtype, device=device)
    y = 1.0 - (i / denom) * 2.0
    radius = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    theta = phi * i
    x = torch.cos(theta) * radius
    z = torch.sin(theta) * radius
    return torch.stack([x, y, z], dim=-1)
