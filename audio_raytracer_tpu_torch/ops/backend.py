"""Intersection backends: one trace loop, swappable closest-hit engines.

``ops.trace`` and ``ops.permeation`` are written against this protocol:
``closest_hit``, ``closest_t``, ``multi_occluded`` and
``multi_permeation_loss``. ``DenseBackend`` here builds [rays, prims]
grids with plain tensor ops; ``ops.cuda.backend.KernelBackend`` runs the
hand-written CUDA kernels. ``PrimShardedBackend`` splits the primitives
over the ranks of a process group and merges what a local engine (either
of the two) finds on each shard.
"""

from __future__ import annotations

import copy

import torch

from audio_raytracer_tpu_torch.ops import intersect
from audio_raytracer_tpu_torch.parallel import comm
from audio_raytracer_tpu_torch.types import Scene

Tensor = torch.Tensor

_ATTR_KEYS = ("kind", "center", "half_extents", "inv_rot", "absorption",
              "echo")

# The rank of "no candidate" in the cross-shard closest-hit vote.
_INT_MAX = 2**31 - 1

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

    # Its t carries autograd, so under PrimShardedBackend the merged t
    # needs no recompute of the winner.
    recompute_winner_t = False

    def __init__(self, scene: Scene):
        self.scene = scene
        self.total = scene.num_primitives
        self._uni = intersect.unified_arrays(scene) if self.total else None
        self._packed = (intersect.packed_unified_table(self._uni)
                        if self.total else None)

    def _chunks(self, R: int):
        return ray_chunks(R, self.total)

    def local_closest(self, o: Tensor, d: Tensor,
                      alive: Tensor | None = None):
        """(t [R] (+inf on a miss), idx [R] int64 in sphere -> AABB -> OBB
        order) over a non-empty scene: the local-engine protocol of
        PrimShardedBackend. ``alive`` is ignored, as in ``closest_hit``."""
        parts = [intersect.closest_hit(o[c], d[c], self.scene)[1:]
                 for c in self._chunks(o.shape[0])]
        t, idx = (torch.cat(x) for x in zip(*parts))
        return t, idx.long()

    def attr_rows(self, idx: Tensor) -> Tensor:
        """[..., 16] winner-attribute rows of local indices, in
        ``intersect.unpack_attr_rows``' layout (materials in the graph)."""
        return self._packed[idx]

    def closest_hit(self, o: Tensor, d: Tensor, alive: Tensor | None = None):
        """(hit [R], t [R], attrs dict of per-ray hit attributes).

        ``alive`` is ignored: the dense grid computes every lane and the
        caller masks."""
        if self.total == 0:
            t = torch.full(o.shape[:-1], intersect.INF, device=o.device)
            return torch.zeros_like(t, dtype=torch.bool), t, empty_attrs(o, t)
        t, idx = self.local_closest(o, d)
        return torch.isfinite(t), t, {k: self._uni[k][idx]
                                      for k in _ATTR_KEYS}

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


class PrimShardedBackend:
    """The primitives split over the ranks of the process group
    ``group``; this rank holds shard ``shard_index`` of ``num_shards``.

    ``scene`` is the local shard: a contiguous slice of each primitive
    type's array, the same length on every rank (``parallel.mesh.
    pad_scene_for_prim_shards`` pads with inactive primitives,
    ``shard_scene`` slices). The local concatenation is type-major
    ([sphere, aabb, obb]), so a primitive's global scan rank is its
    local rank within its type plus this shard's offset into that type,
    and the cross-shard winner is the least (t, global rank): the
    reference's scan order over the whole scene.

    The local work goes to ``engine`` (``local_closest``, ``attr_rows``,
    ``occluded``, ``permeation_loss``, ``multi_occluded``,
    ``multi_permeation_loss``): ``DenseBackend`` by default, or a
    ``KernelBackend`` so each shard runs the CUDA kernels on its
    primitives. This class only adds the collectives over ``group``.
    """

    def __init__(self, scene: Scene, group, num_shards: int,
                 shard_index: int, engine=None):
        self.scene = scene
        self.group = group
        self.num_shards = num_shards
        self.engine = DenseBackend(scene) if engine is None else engine
        self.recompute_winner_t = getattr(self.engine, "recompute_winner_t",
                                          False)
        self._ranks = self._global_ranks(shard_index)

    @property
    def supports_block_skip(self) -> bool:
        """Delegated: the alive mask helps iff the local engine skips
        dead lanes."""
        return getattr(self.engine, "supports_block_skip", False)

    def with_materials(self, scene: Scene) -> "PrimShardedBackend":
        """This backend on ``scene``, a shard of the same geometry whose
        materials may be trained tensors: the local engine's
        ``with_materials`` (a ``KernelBackend``'s, which the sharded step
        graph calls at every replay), the scan ranks kept."""
        out = copy.copy(self)
        out.scene = scene
        out.engine = self.engine.with_materials(scene)
        return out

    def _global_ranks(self, s: int) -> Tensor:
        """[P_local] int32 global scan rank of each local primitive."""
        sc = self.scene
        ns, na, nb = sc.spheres.count, sc.aabbs.count, sc.obbs.count
        gs, ga = ns * self.num_shards, na * self.num_shards

        def span(start, n):
            return torch.arange(start, start + n, dtype=torch.int32,
                                device=sc.device)

        return torch.cat([span(s * ns, ns), span(gs + s * na, na),
                          span(gs + ga + s * nb, nb)])

    def _merge_min(self, t_loc: Tensor, rank_loc: Tensor):
        """The cross-shard least (t, global rank).

        The votes run on a detached t: first the MIN of t, then the MIN
        of the rank among the shards whose finite t equals it (a shard of
        inactive padding reports +inf and never votes). Returns (t_min
        detached, winner mask [R] of this shard, t_diff): t_diff equals
        t_min but carries the winning shard's gradient, and is computed
        only where t_loc has one (every rank of the group has the same
        structure, so all or none take that collective)."""
        ts = t_loc.detach()
        t_min = comm.all_reduce_min(ts, self.group)
        cand = (ts == t_min) & torch.isfinite(ts)
        rank = torch.where(cand, rank_loc, _INT_MAX)
        winner = cand & (rank_loc == comm.all_reduce_min(rank, self.group))
        t_diff = t_min
        if t_loc.requires_grad:
            t_diff = t_min + comm.all_reduce_sum(
                torch.where(winner, t_loc - ts, 0.0), self.group)
        return t_min, winner, t_diff

    def closest_hit(self, o: Tensor, d: Tensor, alive: Tensor | None = None):
        """(hit [R], t [R], attrs of the global winner)."""
        t_loc, idx = self.engine.local_closest(o, d, alive=alive)
        t_min, winner, t_diff = self._merge_min(t_loc, self._ranks[idx])
        # The winner's attribute row reaches every shard as one SUM in
        # which the losing shards contribute zeros; the gradient of a
        # row goes back to the winning shard's materials only. The
        # geometry columns are constants, as KernelBackend's geometry
        # table is: without the detach they would carry the materials'
        # graph into t and the hit points, and the chord adjoint would
        # take B5 where B4 does.
        rows = comm.all_reduce_sum(
            torch.where(winner[..., None], self.engine.attr_rows(idx), 0.0),
            self.group)
        attrs = intersect.unpack_attr_rows(rows.detach())
        attrs.update(absorption=rows[..., 11], echo=rows[..., 12])
        hit = torch.isfinite(t_min)
        if self.recompute_winner_t:
            # The kernel engine's t has no gradient: recompute the
            # winner's t with autograd, as KernelBackend does unsharded.
            t_rec = intersect.primitive_t_per_ray(
                o, d, attrs["kind"], attrs["center"], attrs["half_extents"],
                attrs["inv_rot"])
            return hit, torch.where(hit, t_rec, float("inf")), attrs
        return hit, t_diff, attrs

    def closest_t(self, o: Tensor, d: Tensor) -> Tensor:
        if self.recompute_winner_t:
            return self.closest_hit(o, d)[1]
        t_loc, idx = self.engine.local_closest(o, d)
        return self._merge_min(t_loc, self._ranks[idx])[2]

    def _any(self, local: Tensor) -> Tensor:
        return comm.all_reduce_max(local.to(torch.uint8), self.group) > 0

    def occluded(self, o, d, limit, skip_target_id=None) -> Tensor:
        return self._any(self.engine.occluded(o, d, limit, skip_target_id))

    def permeation_loss(self, o, d, skip_target_id=None) -> Tensor:
        return comm.all_reduce_sum(
            self.engine.permeation_loss(o, d, skip_target_id), self.group)

    def multi_occluded(self, o, dirs, limits, skips, init_occ) -> Tensor:
        return self._any(self.engine.multi_occluded(o, dirs, limits, skips,
                                                    init_occ))

    def multi_permeation_loss(self, o, dirs, skips) -> Tensor:
        return comm.all_reduce_sum(
            self.engine.multi_permeation_loss(o, dirs, skips), self.group)
