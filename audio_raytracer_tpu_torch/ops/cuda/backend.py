"""KernelBackend: the hand-written CUDA kernels behind the backend protocol.

The counterpart of ``audio_raytracer_tpu/ops/pallas/backend.py::
PallasBackend``: the same field preparation (box bounds, the 9 baked OBB
matrix rows, miss encodings, target ids, densities) and the same
winner-attribute tables, with B1-B3 from ``ops/cuda`` in place of the
Pallas kernels. A GPU kernel reads the primitive tables from global
memory, so one launch takes any primitive count: there is no SMEM budget
and no chunked variant.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.ops import intersect, quaternion
from audio_raytracer_tpu_torch.ops.backend import empty_attrs
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.types import Scene

Tensor = torch.Tensor


def _ids_as_f32(x: Tensor) -> Tensor:
    return x.to(torch.int32).contiguous().view(torch.float32)


def _table(cols, width: int) -> Tensor:
    """Stack [n] float32 columns into an [n, width] table, zero padded."""
    tab = torch.stack(cols, dim=1)
    return torch.nn.functional.pad(tab, (0, width - tab.shape[1]))


def prepare_fields(scene: Scene) -> K.Fields:
    """Per-type kernel tables in the csrc/fields.cuh layout.

    Inactive primitives encode guaranteed misses: sphere r2 = -1e30,
    box miss = +inf (0 when active)."""
    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    inf = torch.tensor(float("inf"), device=scene.device)
    zero = torch.tensor(0.0, device=scene.device)
    r2 = torch.where(sp.active, sp.radius * sp.radius, -1e30)
    sph = _table([*sp.center.unbind(1), r2, _ids_as_f32(sp.target_id),
                  sp.material.density], K.SPH_W)
    lo, hi = ab.center - ab.half_extents, ab.center + ab.half_extents
    aabb = _table([*lo.unbind(1), *hi.unbind(1),
                   torch.where(ab.active, zero, inf),
                   _ids_as_f32(ab.target_id), ab.material.density], K.AABB_W)
    # World->local rotation baked into matrix rows (quaternion.to_matrix
    # of the stored inverse quaternion, AudioOBBCollider.cs:59).
    m = quaternion.to_matrix(ob.inv_rot.to(torch.float32)).reshape(-1, 9)
    obb = _table([*ob.center.unbind(1), *ob.half_extents.unbind(1),
                  *m.unbind(1), torch.where(ob.active, zero, inf),
                  _ids_as_f32(ob.target_id), ob.material.density], K.OBB_W)
    return K.Fields(sph.contiguous(), aabb.contiguous(), obb.contiguous())


def build_attr_tabs(uni: dict, total: int):
    """(geom_tab [P, 12], mat_tab [P, 2]) winner-gather tables: kind,
    center, half_extents, inv_rot, padding; absorption, echo."""
    geom = torch.cat([uni["kind"].to(torch.float32)[:, None], uni["center"],
                      uni["half_extents"], uni["inv_rot"],
                      uni["center"].new_zeros((total, 1))], dim=1)
    mat = torch.stack([uni["absorption"], uni["echo"]], dim=1)
    return geom, mat


def attrs_from_tabs(geom_tab: Tensor, mat_tab: Tensor, idx: Tensor) -> dict:
    """Per-ray winner attributes from one [.., 12] and one [.., 2] gather."""
    geom = geom_tab[idx]
    mat = mat_tab[idx]
    return dict(kind=geom[..., 0].to(torch.int32), center=geom[..., 1:4],
                half_extents=geom[..., 4:7], inv_rot=geom[..., 7:11],
                absorption=mat[..., 0], echo=mat[..., 1])


class KernelBackend:
    """All primitives visible locally, intersections in the CUDA kernels
    (their plain versions for a scene on the CPU)."""

    # Dead lanes skip the primitive loop (closest_hit's ``alive``, and
    # multi_occluded's init bits).
    supports_block_skip = True

    def __init__(self, scene: Scene):
        self.scene = scene
        self.total = scene.num_primitives
        self.fields = prepare_fields(scene)
        if self.total:
            uni = intersect.unified_arrays(scene)
            self._geom_tab, self._mat_tab = build_attr_tabs(uni, self.total)

    def closest_hit(self, o: Tensor, d: Tensor, alive: Tensor | None = None):
        """(hit [R], t [R] (+inf miss), attrs of the winning primitive)."""
        if self.total == 0:
            t = torch.full(o.shape[:-1], float("inf"), device=o.device)
            return torch.zeros_like(t, dtype=torch.bool), t, empty_attrs(o, t)
        t, rank = K.run_closest_hit(self.fields, o.contiguous(),
                                    d.contiguous(), alive)
        idx = torch.clamp(rank, max=self.total - 1).long()
        attrs = attrs_from_tabs(self._geom_tab, self._mat_tab, idx)
        return torch.isfinite(t), t, attrs

    def closest_t(self, o: Tensor, d: Tensor) -> Tensor:
        if self.total == 0:
            return torch.full(o.shape[:-1], float("inf"), device=o.device)
        return K.run_closest_hit(self.fields, o.contiguous(),
                                 d.contiguous())[0]

    def multi_occluded(self, o, dirs, limits, skips, init_occ) -> Tensor:
        """Fused S-set occlusion (B2): [R, S] bool, init lanes True."""
        if self.total == 0:
            return init_occ
        return F.run_multi_any_hit(self.fields, o.contiguous(), dirs,
                                   limits.contiguous(), tuple(skips),
                                   init_occ.contiguous())

    def multi_permeation_loss(self, o, dirs, skips) -> Tensor:
        """Fused S-target permeation chords (B3): [R, S] float32."""
        if self.total == 0:
            return o.new_zeros(o.shape[:-1] + (len(dirs),))
        return F.run_multi_chord(self.fields, o.contiguous(), dirs,
                                 tuple(skips))
