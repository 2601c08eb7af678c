"""The permeation chords as autograd Functions.

``MultiChordLoss`` (fused, S sets) is the counterpart of
``audio_raytracer_tpu/ops/pallas/diff.py::multi_chord_loss``;
``ChordLoss`` (one set, B7 forward, B8 backward) that of its
``chord_loss``. The kernels read detached primitive tables, so the three
per-type density tensors enter each Function as explicit inputs and their
gradients come out of it; every other table column (geometry, target ids,
miss encodings) carries no gradient, as in the JAX tier.

- Forward: B3 (``fused.run_multi_chord``), [R, S].
- Backward: B5, the full adjoint (d_o, every set's d_dirs and the
  density gradients), when the origins or any direction set needs a
  gradient, as in pose recovery; B4, the density adjoint alone,
  otherwise, as in materials training, where ray positions do not
  depend on the trained parameters. The JAX tier takes this choice as
  an argument (``pose_grads``) because its custom_vjp cannot see which
  inputs need gradients; autograd can.

On CPU tensors the wrappers run their kernels' plain versions; on a CUDA
tensor they launch the kernels or raise.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.kernels import Fields


class MultiChordLoss(torch.autograd.Function):
    """``apply(fields, skips, o, s_dens, a_dens, o_dens, *dirs) -> [R, S]``:
    chord x density sums of S target ray sets sharing the origins o
    [R, 3]; dirs are S normalized [R, 3]. ``fields`` must hold the
    densities given as s_dens / a_dens / o_dens."""

    @staticmethod
    def forward(ctx, fields: Fields, skips, o, s_dens, a_dens, o_dens,
                *dirs):
        ctx.fields, ctx.skips = fields, tuple(skips)
        ctx.save_for_backward(o, *dirs)
        return F.run_multi_chord(fields, o.contiguous(), list(dirs),
                                 ctx.skips)

    @staticmethod
    def backward(ctx, gbar):
        o, *dirs = ctx.saved_tensors
        o = o.contiguous()
        gbar = gbar.to(torch.float32).contiguous()
        need = ctx.needs_input_grad
        if need[2] or any(need[6:]):
            d_o, d_dirs, dens = F.run_multi_chord_bwd(ctx.fields, o, dirs,
                                                      ctx.skips, gbar)
        else:
            dens = F.run_multi_chord_dens_bwd(ctx.fields, o, dirs, ctx.skips,
                                              gbar)
            d_o, d_dirs = None, [None] * len(dirs)
        return (None, None, d_o, *dens, *d_dirs)


def multi_chord_loss(fields: Fields, skips, o, densities, dirs):
    """Differentiable fused permeation: [R, S]. ``densities``: the scene's
    (sphere, aabb, obb) material densities, the tensors that receive the
    density gradients."""
    return MultiChordLoss.apply(fields, tuple(skips), o, *densities, *dirs)


class ChordLoss(torch.autograd.Function):
    """``apply(fields, skip, o, d, s_dens, a_dens, o_dens) -> [R]``: chord
    x density sums along the rays o, d [R, 3] (d unit length), skipping
    target ``skip``'s colliders. Forward B7; backward B8, which gives the
    gradients of o, d and the densities together, with jax.vjp's split at
    ties. ``fields`` must hold the densities given as s_dens / a_dens /
    o_dens."""

    @staticmethod
    def forward(ctx, fields: Fields, skip, o, d, s_dens, a_dens, o_dens):
        ctx.fields, ctx.skip = fields, skip
        ctx.save_for_backward(o, d)
        return K.run_chord_loss(fields, o.contiguous(), d.contiguous(), skip)

    @staticmethod
    def backward(ctx, gbar):
        o, d = ctx.saved_tensors
        d_o, d_d, dens = K.run_chord_loss_bwd(
            ctx.fields, o.contiguous(), d.contiguous(), ctx.skip,
            gbar.to(torch.float32).contiguous())
        return (None, None, d_o, d_d, *dens)


def chord_loss(fields: Fields, skip: int, o, d, densities):
    """Differentiable single-set permeation: [R]. ``densities``: the
    scene's (sphere, aabb, obb) material densities."""
    return ChordLoss.apply(fields, skip, o, d, *densities)
