"""Intersection backends: one trace loop, swappable closest-hit engines.

``ops.trace`` and ``ops.permeation`` are written against this protocol:
``closest_hit``, ``closest_t``, ``multi_occluded`` and
``multi_permeation_loss``. ``DenseBackend`` here builds [rays, prims]
grids with plain tensor ops; ``ops.cuda.backend.KernelBackend`` runs the
hand-written CUDA kernels.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.ops import intersect
from audio_raytracer_tpu_torch.types import Scene

Tensor = torch.Tensor

_ATTR_KEYS = ("kind", "center", "half_extents", "inv_rot", "absorption",
              "echo")

# "Skip no audio target" for multi-set occlusion / permeation. Real
# target ids are >= 0 and -1 means "not owned", so the sentinel lies far
# below -1 and never matches.
NO_SKIP = -(2**31)

# Rays per chunk are chosen so a [rays, prims] grid holds at most this
# many elements (64 MB of float32), keeping the dense tier's
# intermediates within a few GB at any ray count.
GRID_ELEMS = 1 << 24


def _skip_or_none(skip: int):
    return None if skip < 0 else skip


def ray_chunks(R: int, P: int):
    """Slices over R rays, each with at most GRID_ELEMS / P rays."""
    step = max(1, GRID_ELEMS // max(P, 1))
    return [slice(i, min(i + step, R)) for i in range(0, R, step)]


def empty_attrs(o: Tensor, t: Tensor) -> dict:
    """Hit attributes of a scene with no primitives (all zeros)."""
    z3 = torch.zeros_like(o)
    return dict(kind=torch.zeros(t.shape, dtype=torch.int32,
                                 device=o.device),
                center=z3, half_extents=z3,
                inv_rot=o.new_zeros(o.shape[:-1] + (4,)),
                absorption=torch.zeros_like(t), echo=torch.zeros_like(t))


class DenseBackend:
    """All primitives as dense [rays, prims] grids of tensor ops."""

    def __init__(self, scene: Scene):
        self.scene = scene
        self.total = scene.num_primitives
        self._uni = intersect.unified_arrays(scene) if self.total else None

    def _chunks(self, R: int):
        return ray_chunks(R, self.total)

    def closest_hit(self, o: Tensor, d: Tensor, alive: Tensor | None = None):
        """(hit [R], t [R], attrs dict of per-ray hit attributes).

        ``alive`` is ignored: the dense grid computes every lane and the
        caller masks."""
        if self.total == 0:
            t = torch.full(o.shape[:-1], intersect.INF, device=o.device)
            return torch.zeros_like(t, dtype=torch.bool), t, empty_attrs(o, t)
        parts = [intersect.closest_hit(o[c], d[c], self.scene)
                 for c in self._chunks(o.shape[0])]
        hit, t, idx = (torch.cat(x) for x in zip(*parts))
        idx = idx.long()
        attrs = {k: self._uni[k][idx] for k in _ATTR_KEYS}
        return hit, t, attrs

    def closest_t(self, o: Tensor, d: Tensor) -> Tensor:
        return self.closest_hit(o, d)[1]

    def occluded(self, o, d, limit, skip_target_id=None) -> Tensor:
        if self.total == 0:
            return torch.zeros(o.shape[:-1], dtype=torch.bool,
                               device=o.device)
        return torch.cat([
            intersect.any_hit_within(o[c], d[c], limit[c], self.scene,
                                     skip_target_id)
            for c in self._chunks(o.shape[0])])

    def permeation_loss(self, o, d, skip_target_id=None) -> Tensor:
        if self.total == 0:
            return o.new_zeros(o.shape[:-1])
        return torch.cat([
            intersect.permeation_loss(o[c], d[c], self.scene,
                                      skip_target_id)
            for c in self._chunks(o.shape[0])])

    def multi_occluded(self, o, dirs, limits, skips, init_occ) -> Tensor:
        """Occlusion over S ray sets sharing one origin.

        o: [R, 3]; dirs: S tensors [R, 3]; limits: [R, S]; skips: S ints
        (NO_SKIP or a target id); init_occ: [R, S] bool pre-resolved
        lanes, which come back True. Returns [R, S] bool."""
        cols = [self.occluded(o, dirs[s], limits[..., s],
                              _skip_or_none(skips[s])) | init_occ[..., s]
                for s in range(len(dirs))]
        return torch.stack(cols, dim=-1)

    def multi_permeation_loss(self, o, dirs, skips) -> Tensor:
        """[R, S] permeation chord-loss sums for S target ray sets."""
        cols = [self.permeation_loss(o, dirs[s], _skip_or_none(skips[s]))
                for s in range(len(dirs))]
        return torch.stack(cols, dim=-1)
