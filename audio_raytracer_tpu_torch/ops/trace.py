"""Multi-bounce trace: the main raytracer loop, fixed depth, masked.

The PyTorch counterpart of ``audio_raytracer_tpu/ops/trace.py``. The
reference's per-ray ``while (isRayAlive)`` loop
(Jobs/AudioRaytracerJobBatched.cs:61-215) becomes a Python loop of
``max_hits_per_ray`` bounce steps over the whole ray batch, with an alive
mask instead of an early exit. Per bounce:

  1. closest hit over all primitives; a miss kills the ray
  2. advance the origin, drain life by the hit distance
  3. echo ray from the epsilon-offset hit point back to the listener; if
     clear, record dist x material.Echo in slot (ray, bounce)
  4. one muffle ray per audio target within MaxMuffleHitDistance,
     skipping the target's own colliders; clear -> counter += 1
  5. stop at the last bounce or when life <= 0; otherwise reflect off the
     face normal, offset along the new direction, drain life by
     MaxRayLife x absorption, and stop if life went below 0

Steps 3 and 4 are one backend call per bounce (``multi_occluded``).

Ray compaction (``TraceConfig.compact_rays``, engines that skip dead
lanes): before every bounce after the first, a stable alive-first
reorder packs the live rays into a dense prefix, so the kernels' dead-lane
skips find whole blocks of dead rays, and the bounce's outputs go back to
the original order after it. ``compact_unordered`` skips that restore:
the rays stay in their compacted order from bounce to bounce, the muffle
counts reduce per bounce, and the echo distances come back permuted
within each bounce column. Both permutations are applied as packed row
gathers, as the JAX package applies them.
"""

from __future__ import annotations

import dataclasses

import torch

from audio_raytracer_tpu_torch.ops import intersect
from audio_raytracer_tpu_torch.ops.backend import NO_SKIP, DenseBackend
from audio_raytracer_tpu_torch.types import Scene, TraceConfig, TraceResult
from audio_raytracer_tpu_torch.utils import profiling

Tensor = torch.Tensor


def accum_batch_ids(ray_count: int, num_batches: int,
                    device="cpu") -> Tensor:
    """Per-ray accumulation-batch id [R] int64, the reference's thread
    batch mapping: batchSize = ceil(rayCount / threads), batchId =
    rayStartIndex * batchCount / rayCount (Audio/AudioRayTracer.cs:161,
    AudioRaytracerJobBatched.cs:63-64)."""
    batch_size = -(-ray_count // num_batches)
    r = torch.arange(ray_count, device=device)
    ray_start = (r // batch_size) * batch_size
    return (ray_start * num_batches) // ray_count


def alive_partition(alive: Tensor, with_inverse: bool = True):
    """Stable alive-first permutation and its inverse: ``(order, pos)``,
    int64 [R]. ``x[order]`` packs the alive lanes into a dense prefix
    (relative order kept on both sides) and ``y[pos]`` undoes it: lane i
    lands at ``pos[i]``. ``with_inverse=False`` returns ``pos=None`` (the
    unordered tier never restores). ``pos`` comes from two cumulative
    sums, so both directions are gathers."""
    order = torch.argsort((~alive).to(torch.uint8), stable=True)
    if not with_inverse:
        return order, None
    a = alive.to(torch.int64)
    pos_alive = torch.cumsum(a, 0) - a  # rank among the alive lanes
    n_alive = pos_alive[-1] + a[-1]
    dead = 1 - a
    pos_dead = torch.cumsum(dead, 0) - dead + n_alive
    return order, torch.where(alive, pos_alive, pos_dead)


def _pack_rows(*cols) -> Tensor:
    """Per-ray columns ([R] or [R, k]; float32, int32 or bool) as one
    [R, K] float32 matrix, so that a permutation moves whole rows in one
    gather. int32 is bitcast (exact), bool goes through 0 / 1."""
    parts = []
    for c in cols:
        if c.dtype == torch.int32:
            c = c.view(torch.float32)
        elif c.dtype != torch.float32:
            c = c.to(torch.float32)
        parts.append(c[:, None] if c.ndim == 1 else c)
    return torch.cat(parts, dim=1)


def _unpack_col(rows: Tensor, sl, dtype=torch.float32) -> Tensor:
    """Inverse of _pack_rows for one column (int) or column slice."""
    c = rows[:, sl]
    if dtype == torch.int32:
        return c.contiguous().view(torch.int32)
    if dtype == torch.bool:
        return c > 0.5
    return c


def _secondary_occlusion(backend, scene: Scene, cfg: TraceConfig,
                         offset_point: Tensor, p: Tensor, origin: Tensor,
                         live_hit: Tensor):
    """Echo ray back to the listener + one muffle ray per target, in one
    backend call. Returns (dist_to_origin [R], echo_visible [R],
    muffle_visible [R, T]). Moot lanes (dead ray; target beyond
    MaxMuffleHitDistance) enter pre-resolved as occluded."""
    dist_echo = intersect.safe_norm(origin - p)
    dirs = [intersect.safe_normalize(origin - offset_point)]
    limits = [dist_echo]
    skips = [NO_SKIP]
    moot = [~live_hit]
    for t in range(scene.num_targets):
        to_target = scene.target_positions[t] - offset_point
        dist = intersect.safe_norm(to_target)
        dirs.append(to_target / dist[..., None])
        limits.append(dist)
        skips.append(t)  # skip the target's own colliders (cs:405-449)
        moot.append(~live_hit | (dist >= cfg.max_muffle_hit_distance))
    limits = torch.stack(limits, dim=-1)  # [R, 1 + T]
    occ = backend.multi_occluded(offset_point, dirs, limits, tuple(skips),
                                 torch.stack(moot, dim=-1))
    echo_visible = ~occ[..., 0]
    muffle_visible = ((limits[..., 1:] < cfg.max_muffle_hit_distance)
                      & ~occ[..., 1:])
    return dist_echo, echo_visible, muffle_visible


def _empty_result(R, T, H, cfg, device, collect_debug, dtype):
    B = cfg.num_accum_batches
    result = TraceResult(
        echo_distances=torch.zeros((R, H), dtype=dtype, device=device),
        muffle_hits=torch.zeros((B, T), dtype=torch.int32, device=device),
        permeation=torch.zeros((B, T), dtype=dtype, device=device),
    )
    if collect_debug:
        result = dataclasses.replace(
            result,
            hit_points=torch.zeros((R, H, 3), dtype=dtype, device=device),
            hit_counts=torch.zeros((R,), dtype=torch.int32, device=device),
        )
    return result


def trace(origin: Tensor, directions: Tensor, scene: Scene,
          cfg: TraceConfig, collect_debug: bool = False,
          backend=None) -> TraceResult:
    """Run the full multi-bounce trace.

    origin: [3] listener position; directions: [R, 3]. Returns echo
    [R, H], muffle_hits [B, T] and first_hit_t [R]; permeation is left
    zero (ops.permeation fills it).
    """
    R = directions.shape[0]
    T = scene.num_targets
    H = cfg.max_hits_per_ray
    B = cfg.num_accum_batches
    eps = cfg.epsilon
    dev = directions.device

    if backend is None:
        if scene.num_primitives == 0:
            return _empty_result(R, T, H, cfg, dev, collect_debug,
                                 directions.dtype)
        backend = DenseBackend(scene)
    # Engines that skip dead lanes get the alive mask, and only for them
    # does the alive-first reorder pay.
    block_skip = getattr(backend, "supports_block_skip", False)
    compact = cfg.compact_rays and block_skip
    unordered = compact and cfg.compact_unordered and not collect_debug
    # The accumulation-batch ids ride the reorder only where the muffle
    # counts reduce per bounce over more than one batch.
    carry_bids = unordered and B > 1
    batch_ids = accum_batch_ids(R, B, dev)
    bids = batch_ids.to(torch.int32)

    o = origin.to(directions.dtype).expand(R, 3)
    d = directions
    life = torch.full((R,), cfg.max_ray_life, dtype=directions.dtype,
                      device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    echoes, hit_mask, hit_points = [], [], []
    muffle_per_ray = torch.zeros((R, T), dtype=torch.int32, device=dev)
    muffle_acc = torch.zeros((B, T), dtype=torch.int32, device=dev)

    for step in profiling.device_spans("trace.bounce", dev, range(H)):
        # Every ray starts alive, so bounce 0's partition would be the
        # identity: it is skipped.
        reorder = compact and step > 0
        if reorder:
            with profiling.device_span("trace.compact", dev):
                order, pos = alive_partition(alive,
                                             with_inverse=not unordered)
                cols = (o, d, life, alive) + ((bids,) if carry_bids else ())
                rows = _pack_rows(*cols).index_select(0, order)
                o, d, life = rows[:, 0:3], rows[:, 3:6], rows[:, 6]
                alive = _unpack_col(rows, 7, torch.bool)
                if carry_bids:
                    bids = _unpack_col(rows, 8, torch.int32)

        hit, t, attrs = backend.closest_hit(
            o, d, alive=alive if block_skip else None)
        live_hit = alive & hit
        # Guard t on dead / missed lanes so position math stays finite.
        t_safe = torch.where(live_hit, t, 0.0)
        p = o + d * t_safe[..., None]
        life = life - t_safe
        offset_point = p - d * eps

        # Echo ray (cs:121-147) + muffle rays (cs:150-175), fused.
        dist_to_origin, echo_visible, muffle_visible = _secondary_occlusion(
            backend, scene, cfg, offset_point, p, origin, live_hit)
        echo_val = torch.where(live_hit & echo_visible,
                               dist_to_origin * attrs["echo"], 0.0)
        muffle_inc = muffle_visible & live_hit[..., None]

        # Termination + reflection (cs:179-193, 456-532).
        can_continue = live_hit & (step + 1 < H) & (life > 0.0)
        normal = intersect.reflection_normal(
            p, attrs["kind"], attrs["center"], attrs["half_extents"],
            attrs["inv_rot"])
        d_new = intersect.reflect(d, normal)
        o_new = p + d_new * eps
        life_new = life - cfg.max_ray_life * attrs["absorption"]
        alive = can_continue & (life_new >= 0.0)

        cc = can_continue[..., None]
        o = torch.where(cc, o_new, p)
        d = torch.where(cc, d_new, d)
        life = torch.where(can_continue, life_new, life)

        if unordered:
            # No restore: the muffle counts reduce to [B, T] here, on the
            # compacted batch ids, as a sum (B == 1) or a one-hot matrix
            # product (exact in float32 below 2^24 counts).
            m = muffle_inc.to(torch.float32)
            if B == 1:
                seg = m.sum(0, keepdim=True)
            else:
                one_hot = (bids[:, None] == torch.arange(B, device=dev)
                           ).to(torch.float32)
                seg = one_hot.T @ m
            muffle_acc += seg.to(torch.int32)
        else:
            if reorder:
                # Outputs and the next bounce's rays back to the original
                # order, in one packed row gather.
                with profiling.device_span("trace.restore", dev):
                    rows = _pack_rows(t, echo_val, live_hit, p, muffle_inc,
                                      o, d, life, alive).index_select(0, pos)
                    t, echo_val = rows[:, 0], rows[:, 1]
                    live_hit = _unpack_col(rows, 2, torch.bool)
                    p = rows[:, 3:6]
                    muffle_inc = rows[:, 6:6 + T] > 0.5
                    o, d = rows[:, 6 + T:9 + T], rows[:, 9 + T:12 + T]
                    life = rows[:, 12 + T]
                    alive = _unpack_col(rows, 13 + T, torch.bool)
            muffle_per_ray += muffle_inc.to(torch.int32)
            if collect_debug:
                hit_mask.append(live_hit)
                hit_points.append(p)

        if step == 0:
            # Bounce 0 is never reordered: original ray order.
            first_hit_t = t
        echoes.append(echo_val)

    if unordered:
        muffle_hits = muffle_acc
    else:
        # Per-(accum batch, target) muffle counts: the per-thread-batch
        # rows of AudioTargetManager.MuffleRayHits.
        muffle_hits = muffle_acc.index_add_(0, batch_ids, muffle_per_ray)

    result = TraceResult(
        echo_distances=torch.stack(echoes, dim=1),  # [R, H]
        muffle_hits=muffle_hits,
        permeation=torch.zeros((B, T), dtype=directions.dtype, device=dev),
        # Primary-ray first hit, reused by ops.permeation so it need not
        # scan the scene again.
        first_hit_t=first_hit_t,
    )
    if collect_debug:
        result = dataclasses.replace(
            result,
            hit_points=torch.stack(hit_points, dim=1),
            hit_counts=torch.stack(hit_mask, dim=1).sum(
                dim=-1, dtype=torch.int32),
        )
    return result
