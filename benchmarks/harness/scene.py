"""Scene layouts, listener paths and the program's scene built from them.

A layout is the benchmark's own record of a scene: a dict of float32 and
int64 tensors, one set per primitive type (centres, sizes, materials as
(absorption, density, echo), owning target or -1) and the target
positions. The program and the reference are each handed the same
layout; the program gets it as its ``Scene`` (``port_scene``) or through
its registry (``fill_registry``), the reference reads the layout itself.

``random_layout`` draws the distributions of the upstream-shaped random
scene (``random_scene`` of both packages): positions uniform in
+/- extent, sizes uniform in ``size_range``, absorption in (0, 0.3),
density in (0.2, 2), echo in (0.5, 2), OBB rotations about a normal axis
by a uniform angle (stored inverted), targets uniform in +/- 0.8 extent.
The draws come from a ``torch.Generator`` on the given device, in one
call per quantity, so a seed gives the same layout on the same kind of
device.
"""

from __future__ import annotations

import math

import torch

TYPES = ("sph", "aabb", "obb")


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number;
    taken modulo 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, lo, hi, shape, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def random_layout(seed: int, spheres: int, aabbs: int, obbs: int,
                  targets: int, extent: float, size_range, device) -> dict:
    """A layout drawn from ``seed`` on ``device`` (see the module)."""
    g = generator(seed, device)
    lo, hi = size_range

    def mats(n):
        cols = [_uniform(g, a, b, (n,), device)
                for a, b in ((0.0, 0.3), (0.2, 2.0), (0.5, 2.0))]
        return torch.stack(cols, dim=-1)

    def pos(n):
        return _uniform(g, -extent, extent, (n, 3), device)

    out = dict(sph_center=pos(spheres),
               sph_radius=_uniform(g, lo, hi, (spheres,), device),
               sph_mat=mats(spheres),
               aabb_center=pos(aabbs),
               aabb_half=_uniform(g, lo, hi, (aabbs, 3), device),
               aabb_mat=mats(aabbs))
    axis = torch.randn((obbs, 3), generator=g, device=device)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = 0.5 * _uniform(g, 0.0, 2.0 * math.pi, (obbs,), device)
    rot = torch.cat([axis * torch.sin(half)[:, None],
                     torch.cos(half)[:, None]], dim=-1)
    out.update(obb_center=pos(obbs),
               obb_half=_uniform(g, lo, hi, (obbs, 3), device),
               obb_inv_rot=torch.cat([-rot[:, :3], rot[:, 3:]], dim=-1),
               obb_mat=mats(obbs),
               targets=_uniform(g, -0.8 * extent, 0.8 * extent,
                                (targets, 3), device))
    for k, n in zip(TYPES, (spheres, aabbs, obbs)):
        out[f"{k}_owner"] = torch.full((n,), -1, dtype=torch.int64,
                                       device=device)
    return out


def with_aabb(layout: dict, index: int, center) -> dict:
    """The layout with AABB ``index`` moved to ``center``."""
    out = dict(layout)
    c = layout["aabb_center"].clone()
    c[index] = torch.as_tensor(center, dtype=c.dtype, device=c.device)
    out["aabb_center"] = c
    return out


def port_scene(layout: dict):
    """The program's ``Scene`` of the layout's tensors, on their device."""
    from audio_raytracer_tpu_torch.types import (
        Aabbs,
        Materials,
        Obbs,
        Scene,
        Spheres,
    )

    def mat(k):
        return Materials(*(c.contiguous()
                           for c in layout[f"{k}_mat"].unbind(-1)))

    def common(k):
        n = layout[f"{k}_owner"].shape[0]
        return dict(material=mat(k),
                    target_id=layout[f"{k}_owner"].to(torch.int32),
                    active=torch.ones((n,), dtype=torch.bool,
                                      device=layout[f"{k}_owner"].device))

    return Scene(
        spheres=Spheres(layout["sph_center"], layout["sph_radius"],
                        **common("sph")),
        aabbs=Aabbs(layout["aabb_center"], layout["aabb_half"],
                    **common("aabb")),
        obbs=Obbs(layout["obb_center"], layout["obb_half"],
                  layout["obb_inv_rot"], **common("obb")),
        target_positions=layout["targets"])


def fill_registry(reg, layout: dict) -> list:
    """Add every collider and target of a host layout to the program's
    ``SceneRegistry`` in layout order; returns the AABBs' handles."""
    h = {k: v.tolist() for k, v in layout.items()}
    for c, r, m, t in zip(h["sph_center"], h["sph_radius"], h["sph_mat"],
                          h["sph_owner"]):
        reg.add_sphere(c, r, tuple(m), t)
    handles = [reg.add_aabb(c, e, tuple(m), t) for c, e, m, t in zip(
        h["aabb_center"], h["aabb_half"], h["aabb_mat"], h["aabb_owner"])]
    for c, e, q, m, t in zip(h["obb_center"], h["obb_half"],
                             h["obb_inv_rot"], h["obb_mat"], h["obb_owner"]):
        reg.add_obb(c, e, q, tuple(m), t)
    for p in h["targets"]:
        reg.add_target(p)
    return handles


def loop_path(points, n: int, step: float) -> torch.Tensor:
    """[n, 3] float32 positions on the host: a closed loop through
    ``points`` ([K, 3]), starting at the first, walked at ``step`` metres
    a step."""
    pts = torch.as_tensor(points, dtype=torch.float64).reshape(-1, 3)
    seg = pts.roll(-1, 0) - pts
    seg_len = torch.linalg.vector_norm(seg, dim=-1)
    ends = torch.cumsum(seg_len, 0)
    s = (torch.arange(n, dtype=torch.float64) * step) % float(ends[-1])
    k = torch.searchsorted(ends, s, right=True).clamp(max=len(pts) - 1)
    start = ends[k] - seg_len[k]
    frac = ((s - start) / seg_len[k])[:, None]
    return (pts[k] + frac * seg[k]).to(torch.float32)


def waypoint_path(seed: int, ticks: int, waypoints: int, extent: float,
                  step: float) -> torch.Tensor:
    """[ticks, 3] float32 listener positions on the host: a closed loop
    through ``waypoints`` points drawn from ``seed`` in +/- extent, walked
    at ``step`` metres a tick."""
    g = generator(seed, "cpu")
    return loop_path(_uniform(g, -extent, extent, (waypoints, 3), "cpu"),
                     ticks, step)


def fixed_steps(ticks: int, rate_hz: int, fixed_hz: int) -> list[int]:
    """How many fixed-step updates (at ``fixed_hz``) an engine has run by
    each of ``ticks`` frames at ``rate_hz``: tick k sees k x fixed / rate
    of them, rounded down."""
    return [k * fixed_hz // rate_hz for k in range(ticks)]


def mover_centres(center, offsets, ticks: int, rate_hz: int,
                  fixed_hz: int, speed: float) -> tuple[list, list]:
    """A waypoint platform moved on the engine's fixed step (the upstream
    PlatformMover): it walks the closed loop through ``center`` +
    ``offsets`` at ``speed`` m/s, ``speed / fixed_hz`` metres a fixed
    step. Returns each tick's centre and whether it moved since the tick
    before (tick 0 counts as moved)."""
    n = fixed_steps(ticks, rate_hz, fixed_hz)
    pts = (torch.as_tensor(center, dtype=torch.float64).reshape(1, 3)
           + torch.as_tensor(offsets, dtype=torch.float64).reshape(-1, 3))
    path = loop_path(pts, n[-1] + 1, speed / fixed_hz).tolist()
    return ([path[j] for j in n],
            [k == 0 or n[k] != n[k - 1] for k in range(ticks)])
