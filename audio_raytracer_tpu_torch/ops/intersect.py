"""Batched ray-primitive intersection: the dense [R, P] tier.

The PyTorch counterpart of ``audio_raytracer_tpu/ops/intersect.py``, with
the same semantics as the reference's Burst kernels:

- The AABB slab test returns tFar when the origin is inside the box
  (Jobs/AudioRaytracerJobBatched.cs:284-308).
- The sphere test uses the full quadratic with a = dot(d, d) and prefers
  the near root when it is >= 0 (cs:323-355).
- Closest hit scans spheres, then AABBs, then OBBs with a strict ``<``
  (cs:225-280): the first index of the minimum over the concatenated
  [sphere, aabb, obb] axis.
- Permeation chords sum (tExit - max(tEnter, 0)) x density along the
  unbounded ray (Jobs/AudioPermeationJobBatched.cs:265-328).

Misses are t = +inf.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.ops import quaternion
from audio_raytracer_tpu_torch.types import Scene

Tensor = torch.Tensor

INF = float("inf")


def safe_norm(x: Tensor, dim=-1, keepdim=False, eps=1e-20) -> Tensor:
    """L2 norm with a tiny epsilon under the sqrt (finite at x = 0)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def safe_normalize(x: Tensor, eps=1e-20) -> Tensor:
    return x / safe_norm(x, keepdim=True, eps=eps)


# ---------------------------------------------------------------------------
# Primitive t-grids: rays [R, 3] x prims [N, ...] -> t [R, N] (+inf = miss)
# ---------------------------------------------------------------------------


def _aabb_slab(o, d, center, half_extents):
    """Raw slab interval (t_near, t_far), each [R, N]. o, d: [R, 1, 3].

    Zero direction components are nudged to +/-1e-12 instead of giving
    inf slopes."""
    d = torch.where(d.abs() < 1e-12, torch.copysign(
        torch.full_like(d, 1e-12), d), d)
    inv_d = 1.0 / d
    t0 = (center - half_extents - o) * inv_d
    t1 = (center + half_extents - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return t_near, t_far


def _slab_hit_t(t_near, t_far, active):
    miss = (t_near > t_far) | (t_far < 0.0)
    t = torch.where(t_near > 0.0, t_near, t_far)
    t = t.masked_fill(miss, INF)
    if active is not None:
        t = t.masked_fill(~active, INF)
    return t


def aabb_t(o: Tensor, d: Tensor, center: Tensor, half_extents: Tensor,
           active: Tensor | None = None) -> Tensor:
    """Hit distance grid for AABBs. o, d: [R, 3]; center/half: [N, 3]."""
    t_near, t_far = _aabb_slab(o[..., None, :], d[..., None, :], center,
                               half_extents)
    return _slab_hit_t(t_near, t_far, active)


def obb_t(o: Tensor, d: Tensor, center: Tensor, half_extents: Tensor,
          inv_rot: Tensor, active: Tensor | None = None) -> Tensor:
    """Hit distance grid for OBBs: rotate into the local frame with the
    stored inverse quaternion, then the slab test (cs:314-320)."""
    local_o = quaternion.rotate(inv_rot, o[..., None, :] - center)
    local_d = quaternion.rotate(inv_rot, d[..., None, :])
    t_near, t_far = _aabb_slab(local_o, local_d, 0.0, half_extents)
    return _slab_hit_t(t_near, t_far, active)


def sphere_t(o: Tensor, d: Tensor, center: Tensor, radius: Tensor,
             active: Tensor | None = None) -> Tensor:
    """Hit distance grid for spheres (full quadratic, near root first).
    o, d: [R, 3]; center: [N, 3]; radius: [N]."""
    oc = o[..., None, :] - center
    a = torch.sum(d * d, dim=-1)[..., None]
    b = 2.0 * torch.sum(oc * d[..., None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    hit_disc = disc >= 0.0
    sqrt_disc = torch.sqrt(torch.where(hit_disc, disc, 1.0))
    t0 = (-b - sqrt_disc) / (2.0 * a)
    t1 = (-b + sqrt_disc) / (2.0 * a)
    t = torch.where(t0 >= 0.0, t0, torch.where(t1 >= 0.0, t1, INF))
    t = t.masked_fill(~hit_disc, INF)
    if active is not None:
        t = t.masked_fill(~active, INF)
    return t


# ---------------------------------------------------------------------------
# Closest hit over the whole scene
# ---------------------------------------------------------------------------


def _owners(scene: Scene) -> Tensor:
    return torch.cat([scene.spheres.target_id, scene.aabbs.target_id,
                      scene.obbs.target_id])


def scene_t_grid(o: Tensor, d: Tensor, scene: Scene,
                 skip_target_id=None) -> Tensor:
    """[R, P] hit-distance grid in reference scan order [sphere, aabb, obb].

    ``skip_target_id`` ([R] int32 or an int): primitives owned by that
    audio target count as misses (AudioRaytracerJobBatched.cs:405-449).
    """
    ts = sphere_t(o, d, scene.spheres.center, scene.spheres.radius,
                  scene.spheres.active)
    ta = aabb_t(o, d, scene.aabbs.center, scene.aabbs.half_extents,
                scene.aabbs.active)
    tb = obb_t(o, d, scene.obbs.center, scene.obbs.half_extents,
               scene.obbs.inv_rot, scene.obbs.active)
    t = torch.cat([ts, ta, tb], dim=-1)
    if skip_target_id is not None:
        skip = torch.as_tensor(skip_target_id, device=t.device)[..., None]
        t = t.masked_fill(skip == _owners(scene), INF)
    return t


def closest_hit(o: Tensor, d: Tensor, scene: Scene):
    """(hit [R] bool, t [R], prim_index [R] int32) over all primitives.

    ``prim_index`` addresses the [sphere, aabb, obb] order; the first
    index of the minimum reproduces the reference's strict-< scan order
    (AudioRaytracerJobBatched.cs:239-276)."""
    t_grid = scene_t_grid(o, d, scene)
    if t_grid.shape[-1] == 0:
        shape = t_grid.shape[:-1]
        return (torch.zeros(shape, dtype=torch.bool, device=o.device),
                torch.full(shape, INF, device=o.device),
                torch.zeros(shape, dtype=torch.int32, device=o.device))
    t, idx = torch.min(t_grid, dim=-1)
    return torch.isfinite(t), t, idx.to(torch.int32)


def any_hit_within(o: Tensor, d: Tensor, limit: Tensor, scene: Scene,
                   skip_target_id=None) -> Tensor:
    """Occlusion: does any primitive hit strictly closer than ``limit``
    [R]? (CanRaySeePoint inverted: AudioRaytracerJobBatched.cs:365-449.)"""
    t_grid = scene_t_grid(o, d, scene, skip_target_id)
    return torch.any(t_grid < limit[..., None], dim=-1)


# ---------------------------------------------------------------------------
# Permeation chords
# ---------------------------------------------------------------------------


def _box_chord(t_near, t_far, active, density):
    chord = torch.clamp(t_far - torch.clamp(t_near, min=0.0), min=0.0)
    valid = (t_near <= t_far) & (t_far >= 0.0) & active
    return torch.where(valid, chord, 0.0) * density


def permeation_loss(o: Tensor, d: Tensor, scene: Scene,
                    skip_target_id=None) -> Tensor:
    """Per ray: sum over primitives of chord length x material density
    (Jobs/AudioPermeationJobBatched.cs:225-328). o, d: [R, 3] with d
    normalized (the sphere test assumes |d| = 1). Returns [R]."""
    o_b = o[..., None, :]
    d_b = d[..., None, :]
    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs

    # Spheres: half-b quadratic (cs:303-328).
    oc = o_b - sp.center
    b = torch.sum(oc * d_b, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - sp.radius ** 2
    disc = b * b - c
    hit_disc = disc >= 0.0
    sqrt_disc = torch.sqrt(torch.where(hit_disc, disc, 1.0))
    t_enter = -b - sqrt_disc
    t_exit = -b + sqrt_disc
    s_chord = torch.clamp(t_exit - torch.clamp(t_enter, min=0.0), min=0.0)
    s_valid = hit_disc & (t_exit >= 0.0) & sp.active
    s_loss = torch.where(s_valid, s_chord, 0.0) * sp.material.density

    # AABBs (cs:265-288).
    a_near, a_far = _aabb_slab(o_b, d_b, ab.center, ab.half_extents)
    a_loss = _box_chord(a_near, a_far, ab.active, ab.material.density)

    # OBBs (cs:294-300).
    local_o = quaternion.rotate(ob.inv_rot, o_b - ob.center)
    local_d = quaternion.rotate(ob.inv_rot, d_b)
    b_near, b_far = _aabb_slab(local_o, local_d, 0.0, ob.half_extents)
    b_loss = _box_chord(b_near, b_far, ob.active, ob.material.density)

    if skip_target_id is not None:
        skip = torch.as_tensor(skip_target_id, device=o.device)[..., None]
        s_loss = s_loss.masked_fill(skip == sp.target_id, 0.0)
        a_loss = a_loss.masked_fill(skip == ab.target_id, 0.0)
        b_loss = b_loss.masked_fill(skip == ob.target_id, 0.0)

    return s_loss.sum(-1) + a_loss.sum(-1) + b_loss.sum(-1)


# ---------------------------------------------------------------------------
# Unified (gather-friendly) scene view for reflection / materials
# ---------------------------------------------------------------------------


def unified_arrays(scene: Scene) -> dict:
    """Per-type primitive data concatenated in [sphere, aabb, obb] order:
    kind (0 sphere, 1 aabb, 2 obb) [P] int32, center [P, 3],
    half_extents [P, 3] (radius replicated for spheres), inv_rot [P, 4]
    (identity for spheres and AABBs), absorption / echo / density [P],
    target_id [P]."""
    sp, ab, ob = scene.spheres, scene.aabbs, scene.obbs
    ns, na, nb = sp.count, ab.count, ob.count
    dev = scene.device
    kind = torch.cat([
        torch.zeros((ns,), dtype=torch.int32, device=dev),
        torch.ones((na,), dtype=torch.int32, device=dev),
        torch.full((nb,), 2, dtype=torch.int32, device=dev),
    ])
    center = torch.cat([sp.center, ab.center, ob.center], dim=0)
    half_extents = torch.cat([sp.radius[:, None].expand(ns, 3),
                              ab.half_extents, ob.half_extents], dim=0)
    identity_q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(
        ns + na, 4)
    inv_rot = torch.cat([identity_q, ob.inv_rot], dim=0)

    def cat(field):
        return torch.cat([getattr(sp.material, field),
                          getattr(ab.material, field),
                          getattr(ob.material, field)])

    return dict(kind=kind, center=center, half_extents=half_extents,
                inv_rot=inv_rot, absorption=cat("absorption"),
                echo=cat("echo"), density=cat("density"),
                target_id=_owners(scene))


_PACKED_WIDTH = 16  # 13 used columns, padded


def packed_unified_table(uni: dict) -> Tensor:
    """[P, 16] float32 row view of ``unified_arrays``: kind, center xyz,
    half_extents xyz, inv_rot xyzw, absorption, echo, zero padding. One
    row gather replaces 13 column gathers on the winner index."""
    cols = [uni["kind"].to(torch.float32)[:, None], uni["center"],
            uni["half_extents"], uni["inv_rot"],
            uni["absorption"][:, None], uni["echo"][:, None]]
    packed = torch.cat(cols, dim=1)
    return torch.nn.functional.pad(packed,
                                   (0, _PACKED_WIDTH - packed.shape[1]))


def unpack_attr_rows(rows: Tensor) -> dict:
    """[..., 16] gathered rows -> the closest_hit attrs dict."""
    return dict(kind=rows[..., 0].to(torch.int32), center=rows[..., 1:4],
                half_extents=rows[..., 4:7], inv_rot=rows[..., 7:11],
                absorption=rows[..., 11], echo=rows[..., 12])


# ---------------------------------------------------------------------------
# Reflection
# ---------------------------------------------------------------------------


def _box_axis_normal(local_point: Tensor, half_extents: Tensor) -> Tensor:
    """Face normal from the closest axis with the reference's strict-<
    axis selection, ties falling through to z
    (AudioRaytracerJobBatched.cs:471-482, 497-508)."""
    delta = half_extents - local_point.abs()
    dx, dy, dz = delta.unbind(-1)
    pick_x = (dx < dy) & (dx < dz)
    pick_y = ~pick_x & (dy < dx) & (dy < dz)
    pick_z = ~(pick_x | pick_y)
    sign = torch.sign(local_point)
    pick = torch.stack([pick_x, pick_y, pick_z], dim=-1)
    return torch.where(pick, sign, 0.0)


def reflection_normal(hit_point: Tensor, kind: Tensor, center: Tensor,
                      half_extents: Tensor, inv_rot: Tensor) -> Tensor:
    """Surface normal at the hit point of the selected primitive.

    Parity quirk, kept: for OBBs the reference's ReflectRay treats the
    stored inverse quaternion as if it were the forward orientation — it
    maps the hit point to "local" with inverse(stored) and the local
    normal back with stored (AudioRaytracerJobBatched.cs:489, 510), the
    opposite pairing of its own intersection test.
    """
    sphere_n = safe_normalize(hit_point - center)
    aabb_n = _box_axis_normal(hit_point - center, half_extents)
    fwd_rot = quaternion.inverse(inv_rot)
    local_hit = quaternion.rotate(fwd_rot, hit_point - center)
    obb_n = quaternion.rotate(
        inv_rot, _box_axis_normal(local_hit, half_extents))
    kind = kind[..., None]
    return torch.where(kind == 0, sphere_n,
                       torch.where(kind == 1, aabb_n, obb_n))


def reflect(d: Tensor, normal: Tensor) -> Tensor:
    """math.reflect: d - 2 dot(d, n) n (cs:525)."""
    return d - 2.0 * torch.sum(d * normal, dim=-1, keepdim=True) * normal
