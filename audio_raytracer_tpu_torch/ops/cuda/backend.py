"""KernelBackend: the hand-written CUDA kernels behind the backend protocol.

The counterpart of ``audio_raytracer_tpu/ops/pallas/backend.py::
PallasBackend``: the same field preparation (box bounds, the 9 baked OBB
matrix rows, miss encodings, target ids, densities) and the same
winner-attribute tables, with the kernels of ``ops/cuda`` in place of the
Pallas kernels: B1 (closest hit), B2 and B3 (the fused multi-set
occlusion and chords of the bounce loop and permeation), and B6-B8 (the
single-set ``occluded`` and ``permeation_loss``). A GPU kernel reads the
primitive tables from global memory, so one launch takes any primitive
count: there is no SMEM budget and no chunked variant.

With ``differentiable=True`` (JAX ``PallasBackend(differentiable=True)``,
ops/pallas/backend.py:59-118) gradients flow at O(R + P) memory:

- closest hit: the kernel selects the winner, and
  ``intersect.primitive_t_per_ray`` recomputes its t with autograd, so t
  is differentiable in the ray origin and direction;
- the winner's geometry is gathered from a detached table; its
  materials (absorption, echo) from a table that stays in the graph;
- permeation goes through ``ops/cuda/diff.py::MultiChordLoss``: B3
  forward; backward B5 where the ray origins or directions need a
  gradient, B4 alone where only the densities do; single-set permeation
  through ``ChordLoss``: B7 forward, B8 backward;
- occlusion booleans carry no gradient.

Every kernel reads detached inputs. Forward values are those of
``differentiable=False``.

The kernels compute in float32 whatever the scene's precision, as the
JAX tier's do: a float64 scene's tables are rounded to float32 once,
and the origins, directions and limits at every call (the winner's t
is recomputed from the rounded ray, in the scene's precision, as the
JAX tier's is); gradients reach the float64 leaves through those
casts.

``compute_dtype=torch.bfloat16`` is the bfloat16 tier of JAX
``PallasBackend(compute_dtype=jnp.bfloat16)`` (ops/pallas/backend.py:
94-118): it reaches B1 (``closest_hit``, ``closest_t``,
``local_closest``), B2 (``multi_occluded``) and B3
(``multi_permeation_loss``); the single-set ``occluded`` and
``permeation_loss`` (B6, B7) stay float32, and ``differentiable=True``
forces float32.
"""

from __future__ import annotations

import copy

import torch

from audio_raytracer_tpu_torch.ops import intersect, quaternion
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP, empty_attrs
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.ops.cuda.diff import (
    chord_loss,
    multi_chord_loss,
)
from audio_raytracer_tpu_torch.types import Scene
from audio_raytracer_tpu_torch.utils import profiling

Tensor = torch.Tensor


def _ids_as_f32(x: Tensor) -> Tensor:
    return x.to(torch.int32).contiguous().view(torch.float32)


def _f32(x: Tensor) -> Tensor:
    """``x`` in float32 (itself when it is float32 already)."""
    return x.to(torch.float32)


def _table(cols, width: int) -> Tensor:
    """Stack [n] columns, each rounded to float32, into an [n, width]
    float32 table, zero padded."""
    tab = torch.stack([_f32(c) for c in cols], dim=1)
    return torch.nn.functional.pad(tab, (0, width - tab.shape[1]))


@torch.no_grad()
def prepare_fields(scene: Scene) -> K.Fields:
    """Per-type kernel tables in the csrc/fields.cuh layout.

    Inactive primitives encode guaranteed misses: sphere r2 = -1e30,
    box miss = +inf (0 when active). The tables are detached. No tensor
    is made from host data (the miss encodings are scalars), so the
    build enqueues no pageable copy: the frame and step graphs' refills
    build tables at every new scene."""
    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    inf = float("inf")
    r2 = torch.where(sp.active, sp.radius * sp.radius, -1e30)
    sph = _table([*sp.center.unbind(1), r2, _ids_as_f32(sp.target_id),
                  sp.material.density], K.SPH_W)
    lo, hi = ab.center - ab.half_extents, ab.center + ab.half_extents
    aabb = _table([*lo.unbind(1), *hi.unbind(1),
                   torch.where(ab.active, 0.0, inf),
                   _ids_as_f32(ab.target_id), ab.material.density], K.AABB_W)
    # World->local rotation baked into matrix rows (quaternion.to_matrix
    # of the stored inverse quaternion, AudioOBBCollider.cs:59).
    m = quaternion.to_matrix(ob.inv_rot.to(torch.float32)).reshape(-1, 9)
    obb = _table([*ob.center.unbind(1), *ob.half_extents.unbind(1),
                  *m.unbind(1), torch.where(ob.active, 0.0, inf),
                  _ids_as_f32(ob.target_id), ob.material.density], K.OBB_W)
    return K.Fields(sph.contiguous(), aabb.contiguous(), obb.contiguous())


def build_attr_tabs(uni: dict, total: int):
    """(geom_tab [P, 12], mat_tab [P, 2]) winner-gather tables: kind,
    center, half_extents, inv_rot, padding (detached); absorption, echo
    (in the graph)."""
    geom = torch.cat([uni["kind"].to(torch.float32)[:, None], uni["center"],
                      uni["half_extents"], uni["inv_rot"],
                      uni["center"].new_zeros((total, 1))], dim=1).detach()
    return geom, material_table(uni["absorption"], uni["echo"])


def material_table(absorption: Tensor, echo: Tensor) -> Tensor:
    """[P, 2] winner-materials table (absorption, echo), in the autograd
    graph of its columns."""
    return torch.stack([absorption, echo], dim=1)


# The density column of each type table (csrc/fields.cuh).
DENSITY_COLUMNS = (K.S_DENS, K.A_DENS, K.O_DENS)


def attrs_from_tabs(geom_tab: Tensor, mat_tab: Tensor, idx: Tensor) -> dict:
    """Per-ray winner attributes from one [R, 12] and one [R, 2] gather
    (idx [R]). ``index_select``'s backward is an atomic ``index_add_``
    into the table; the backward of ``mat_tab[idx]`` is a sort-based
    ``index_put_``, 34 ms per bounce at 1M rays on an H100 (PERF.md)."""
    geom = geom_tab.index_select(0, idx)
    mat = mat_tab.index_select(0, idx)
    return dict(kind=geom[..., 0].to(torch.int32), center=geom[..., 1:4],
                half_extents=geom[..., 4:7], inv_rot=geom[..., 7:11],
                absorption=mat[..., 0], echo=mat[..., 1])


class KernelBackend:
    """All primitives visible locally, intersections in the CUDA kernels
    (their plain versions for a scene on the CPU)."""

    # Dead lanes skip the primitive loop (closest_hit's ``alive``, and
    # multi_occluded's init bits).
    supports_block_skip = True

    def __init__(self, scene: Scene, differentiable: bool = False,
                 compute_dtype=torch.float32):
        self.scene = scene
        self.differentiable = differentiable
        # The chord adjoints and the winner-t recompute are float32 only.
        self.compute_dtype = (torch.float32 if differentiable
                              else K.check_compute_dtype(compute_dtype))
        self.total = scene.num_primitives
        self.fields = prepare_fields(scene)
        if self.total:
            # Its identity quaternion is a copy from host data: on the
            # card a copy from pageable memory, which waits.
            with K.host_wait():
                uni = intersect.unified_arrays(scene)
            self._geom_tab, self._mat_tab = build_attr_tabs(uni, self.total)

    def build_tables(self, skip_sets) -> None:
        """Build now every table a frame's launches read in the engine's
        tier: B1's (its tree where it walks one, ``K.takes_bvh``, built
        inside an ``art.refill.bvh`` host span, else its tiles), B2's for
        each tuple of skip targets in ``skip_sets`` and the rounded tables
        of the bfloat16 plain versions. Built lazily inside a captured
        frame (models/frame_graph.py) they would fail: B2's row selections
        wait for the device, and a refill would leave the lazy ones
        stale."""
        if not self.total:
            return
        if K.takes_bvh(self.fields, self.compute_dtype):
            with profiling.span("refill.bvh"):
                K.closest_bvh(self.fields)
        else:
            K.closest_tables(self.fields, self.compute_dtype)
        for skips in skip_sets:
            K.occlusion_tables(self.fields, skips, self.compute_dtype)
        self.fields.rounded(self.compute_dtype)

    def with_materials(self, scene: Scene) -> "KernelBackend":
        """This engine on ``scene``, a scene of the same geometry whose
        materials may be trained tensors (the step graphs of
        models/step_graph.py call it at every replay). The density
        columns of ``fields``, which B3, B4 and B5 read, are written in
        place from ``scene``'s densities, and the winner-materials table
        is made anew from its absorption and echo, in their autograd
        graph. B1's and B2's tables read no density and stay as they
        are. Nothing here selects rows or reads host data, so it runs
        inside a captured CUDA graph."""
        eng = copy.copy(self)
        eng.scene = scene
        mats = [p.material for p in (scene.spheres, scene.aabbs, scene.obbs)]
        with torch.no_grad():
            for tab, col, m in zip((self.fields.sph, self.fields.aabb,
                                    self.fields.obb), DENSITY_COLUMNS, mats):
                tab[:, col] = m.density
        if self.total:
            eng._mat_tab = material_table(
                *(torch.cat([getattr(m, f) for m in mats])
                  for f in ("absorption", "echo")))
        return eng

    @property
    def recompute_winner_t(self) -> bool:
        """The kernel's t has no gradient; with ``differentiable`` the
        winner's t is recomputed with autograd (here, and in
        PrimShardedBackend after the cross-shard merge)."""
        return self.differentiable

    def local_closest(self, o: Tensor, d: Tensor,
                      alive: Tensor | None = None):
        """B1: (t [R] (+inf on a miss), idx [R] int64 in sphere -> AABB ->
        OBB order, a miss clamped to the last row): the local-engine
        protocol of PrimShardedBackend. No gradient."""
        t, rank = K.run_closest_hit(self.fields, _f32(o.detach()).contiguous(),
                                    _f32(d.detach()).contiguous(), alive,
                                    self.compute_dtype)
        return t, torch.clamp(rank, max=self.total - 1).long()

    def attr_rows(self, idx: Tensor) -> Tensor:
        """[R, 16] winner rows of local indices in
        ``intersect.unpack_attr_rows``' layout: the geometry from the
        detached table, absorption and echo from the one in the graph,
        so a sharded materials step still trains them."""
        geom = self._geom_tab.index_select(0, idx)[:, :11]
        mat = self._mat_tab.index_select(0, idx)
        return torch.nn.functional.pad(torch.cat([geom, mat], dim=1),
                                       (0, 3))

    def closest_hit(self, o: Tensor, d: Tensor, alive: Tensor | None = None):
        """(hit [R], t [R] (+inf miss), attrs of the winning primitive)."""
        if self.total == 0:
            t = torch.full(o.shape[:-1], float("inf"), device=o.device)
            return torch.zeros_like(t, dtype=torch.bool), t, empty_attrs(o, t)
        t, idx = self.local_closest(o, d, alive)
        attrs = attrs_from_tabs(self._geom_tab, self._mat_tab, idx)
        hit = torch.isfinite(t)
        if self.differentiable:
            # From the ray the kernel saw, in the scene's precision.
            t_rec = intersect.primitive_t_per_ray(
                _f32(o).to(o.dtype), _f32(d).to(d.dtype), attrs["kind"],
                attrs["center"], attrs["half_extents"], attrs["inv_rot"])
            t = torch.where(hit, t_rec, float("inf"))
        return hit, t, attrs

    def closest_t(self, o: Tensor, d: Tensor) -> Tensor:
        """The kernel's closest-hit t [R] (no gradient)."""
        if self.total == 0:
            return torch.full(o.shape[:-1], float("inf"), device=o.device)
        return K.run_closest_hit(self.fields, _f32(o.detach()).contiguous(),
                                 _f32(d.detach()).contiguous(),
                                 compute_dtype=self.compute_dtype)[0]

    def _densities(self):
        sc = self.scene
        return (sc.spheres.material.density, sc.aabbs.material.density,
                sc.obbs.material.density)

    def occluded(self, o, d, limit, skip_target_id=None) -> Tensor:
        """Single-set occlusion (B6): [R] bool, True where a primitive not
        owned by ``skip_target_id`` hits at t < limit ([R] or broadcast);
        d need not be unit length. No gradient."""
        if self.total == 0:
            return torch.zeros(o.shape[:-1], dtype=torch.bool,
                               device=o.device)
        skip = NO_SKIP if skip_target_id is None else int(skip_target_id)
        return K.run_any_hit(self.fields, _f32(o.detach()).contiguous(),
                             _f32(d.detach()).contiguous(),
                             _f32(torch.as_tensor(limit).detach()), skip)

    def permeation_loss(self, o, d, skip_target_id=None) -> Tensor:
        """Single-set permeation chords (B7): [R] float32, d unit length;
        with ``differentiable=True`` through ChordLoss (B8 backward)."""
        if self.total == 0:
            return o.new_zeros(o.shape[:-1])
        skip = NO_SKIP if skip_target_id is None else int(skip_target_id)
        if self.differentiable:
            return chord_loss(self.fields, skip, _f32(o), _f32(d),
                              self._densities())
        return K.run_chord_loss(self.fields, _f32(o.detach()).contiguous(),
                                _f32(d.detach()).contiguous(), skip)

    def multi_occluded(self, o, dirs, limits, skips, init_occ) -> Tensor:
        """Fused S-set occlusion (B2): [R, S] bool, init lanes True."""
        if self.total == 0:
            return init_occ
        return F.run_multi_any_hit(self.fields, _f32(o.detach()).contiguous(),
                                   [_f32(x.detach()) for x in dirs],
                                   _f32(limits.detach()).contiguous(),
                                   tuple(skips), init_occ.contiguous(),
                                   self.compute_dtype)

    def multi_permeation_loss(self, o, dirs, skips) -> Tensor:
        """Fused S-target permeation chords (B3): [R, S] float32; with
        ``differentiable=True`` through MultiChordLoss (B4 / B5
        backward)."""
        if self.total == 0:
            return o.new_zeros(o.shape[:-1] + (len(dirs),))
        if self.differentiable:
            return multi_chord_loss(self.fields, skips, _f32(o),
                                    self._densities(),
                                    [_f32(x) for x in dirs])
        return F.run_multi_chord(self.fields, _f32(o.detach()).contiguous(),
                                 [_f32(x.detach()) for x in dirs],
                                 tuple(skips), self.compute_dtype)
