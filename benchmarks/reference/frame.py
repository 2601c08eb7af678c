"""Plain PyTorch reference of one audio-raytrace frame.

The semantics of the upstream project's Burst jobs, written from them and
not from the program under test: the main trace
(Jobs/AudioRaytracerJobBatched.cs:61-215), the permeation job with its
overwrite quirk (Jobs/AudioPermeationJobBatched.cs), the reverb impulse
response (a linear splat of each clear echo onto its two arrival-time
bins) and the reduce to per-target settings (Jobs/ProcessAudioDataJob.cs).
Every operation is a plain tensor operation in float32, on whatever
device the inputs lie on, over blocks of rays so that a frame of a million
rays fits: no kernel, cache or batching of the program. It imports
nothing of the program and takes nothing the program made: the scene is
the benchmark's own ``layout`` (``harness/scene.py``) and the directions
are made here.

Conventions kept from the upstream code:

- Closest hit scans spheres, then AABBs, then OBBs with a strict ``<``:
  the earliest index wins a tie.
- The AABB slab test returns t_far when the origin is inside the box; a
  zero direction component is nudged to +/-1e-12.
- The sphere test is the full quadratic with a = d.d and takes the near
  root when it is >= 0.
- OBBs store the inverse rotation (xyzw); the reflection maps the hit
  point with the inverse of the stored quaternion and the normal back
  with the stored one (the upstream pairing, opposite to its own
  intersection test).
- Occlusion of a ray set skips the primitives owned by its target.
- Permeation keeps only the last hitting ray of each accumulation batch.
- Reverb volume counts zero echo slots as returned hits, and the average
  echo distance divides by rays x slots.
"""

from __future__ import annotations

import math

import torch

INF = float("inf")
# Elements of one [rays, primitives] grid of a block.
GRID_ELEMS = 1 << 24
# Rays traced together through every bounce.
RAY_BLOCK = 1 << 16
# "Skip no target": matches no owner id (owners are -1 or a target).
NO_SKIP = -(2**31)


def fibonacci_directions(count: int, device) -> torch.Tensor:
    """[count, 3] golden-angle spiral directions in float32, the upstream
    FibonacciDirectionsJobParallel.cs:25-34 (n - 1 denominator)."""
    i = torch.arange(count, dtype=torch.float32, device=device)
    five = torch.tensor(5.0, dtype=torch.float32, device=device)
    phi = math.pi * (3.0 - torch.sqrt(five))
    denom = torch.tensor(count - 1, dtype=torch.float32, device=device)
    y = 1.0 - (i / denom) * 2.0
    radius = torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    theta = phi * i
    return torch.stack([torch.cos(theta) * radius, y,
                        torch.sin(theta) * radius], dim=-1)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def rotate(q, v):
    """v rotated by the unit quaternion q (xyzw): v + w t + q.xyz x t with
    t = 2 q.xyz x v (Unity's math.mul(quaternion, float3))."""
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def _norm(x):
    return torch.sqrt(_dot(x, x) + 1e-20)


def _nudge(d):
    return torch.where(d.abs() < 1e-12,
                       torch.copysign(torch.full_like(d, 1e-12), d), d)


class Scene:
    """The layout's tensors on one device, with the per-type views the
    tests need (AABB bounds, concatenated materials and owners)."""

    def __init__(self, layout: dict, device):
        def get(k, dtype=torch.float32):
            return torch.as_tensor(layout[k]).to(device=device, dtype=dtype)

        self.sc, self.sr = get("sph_center"), get("sph_radius")
        self.ac, self.ah = get("aabb_center"), get("aabb_half")
        self.alo, self.ahi = self.ac - self.ah, self.ac + self.ah
        self.oc, self.oh = get("obb_center"), get("obb_half")
        self.oq = get("obb_inv_rot")
        # Rotation into each OBB's frame by its stored (inverse)
        # quaternion, as a matrix: rows [No, 3, 3], and [3, 3 No] for
        # directions (d @ rot_t is each box's rotated d, box-major).
        self.rot = _matrix(self.oq)
        self.rot_t = self.rot.permute(2, 0, 1).reshape(3, -1).contiguous()
        self.targets = get("targets")
        self.counts = (self.sc.shape[0], self.ac.shape[0], self.oc.shape[0])
        self.owner = torch.cat([get(f"{k}_owner", torch.int64)
                                for k in ("sph", "aabb", "obb")])
        mat = torch.cat([get(f"{k}_mat") for k in ("sph", "aabb", "obb")])
        self.absorption, self.density, self.echo = mat.unbind(-1)

    @property
    def total(self) -> int:
        return sum(self.counts)

    def owners(self, kind: int):
        start = sum(self.counts[:kind])
        return self.owner[start:start + self.counts[kind]]


# -- hit distances: rays [n, 3] x one type's primitives -> t [n, N] ----------


def _matrix(q):
    """[N, 3, 3] rotation matrices M with M v = rotate(q, v)."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _slab(lo, hi, inv):
    """(t_near, t_far) [n, N] of the slabs whose bounds, less the ray
    origin, are lo and hi [n, N, 3], for 1 / direction ``inv``."""
    t0, t1 = lo * inv, hi * inv
    return (torch.minimum(t0, t1).amax(dim=-1),
            torch.maximum(t0, t1).amin(dim=-1))


def _slab_t(t_near, t_far):
    t = torch.where(t_near > 0.0, t_near, t_far)
    return t.masked_fill((t_near > t_far) | (t_far < 0.0), INF)


class _Origins:
    """The terms of ray origins o [n, 3] against every primitive that do
    not depend on the direction, shared by every ray set leaving them."""

    def __init__(self, sc: "Scene", o):
        self.oc = o[:, None, :] - sc.sc
        self.c = _dot(self.oc, self.oc) - sc.sr * sc.sr
        self.a_lo, self.a_hi = sc.alo - o[:, None, :], sc.ahi - o[:, None, :]
        v = o[:, None, :] - sc.oc
        local = torch.stack([_dot(sc.rot[:, i], v) for i in range(3)], -1)
        self.b_lo, self.b_hi = -sc.oh - local, sc.oh - local

    def grids(self, sc: "Scene", d):
        """The per-type t grids [n, N] (+inf on a miss) of directions d."""
        a = _dot(d, d)[:, None]
        b = 2.0 * _dot(self.oc, d[:, None, :])
        disc = b * b - 4.0 * a * self.c
        s = torch.sqrt(torch.where(disc > 0.0, disc, 0.0))
        t0 = (-b - s) / (2.0 * a)
        t1 = (-b + s) / (2.0 * a)
        ts = torch.where(t0 >= 0.0, t0, torch.where(t1 >= 0.0, t1, INF))
        ts = ts.masked_fill(disc < 0.0, INF)
        ta = _slab_t(*_slab(self.a_lo, self.a_hi, 1.0 / _nudge(d)[:, None]))
        n, no = d.shape[0], sc.counts[2]
        ld = (d @ sc.rot_t).view(n, no, 3)
        tb = _slab_t(*_slab(self.b_lo, self.b_hi, 1.0 / _nudge(ld)))
        return ts, ta, tb


def _blocks(n: int, total: int):
    step = max(1, GRID_ELEMS // max(total, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def closest_hit(sc: Scene, o, d):
    """(t [n] (+inf on a miss), index [n] int64 in sphere -> AABB -> OBB
    order) by the strict-< scan."""
    n = o.shape[0]
    t_out = torch.full((n,), INF, device=o.device)
    i_out = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for b in _blocks(n, sc.total):
        best_t = torch.full((b.stop - b.start,), INF, device=o.device)
        best_i = torch.zeros_like(best_t, dtype=torch.int64)
        start = 0
        for grid, cnt in zip(_Origins(sc, o[b]).grids(sc, d[b]), sc.counts):
            if cnt:
                t, i = torch.min(grid, dim=1)
                better = t < best_t
                best_t = torch.where(better, t, best_t)
                best_i = torch.where(better, i + start, best_i)
            start += cnt
        t_out[b], i_out[b] = best_t, best_i
    return t_out, i_out


def occluded(sc: Scene, o, sets):
    """[n, S] bool for ray sets sharing the origins o [n, 3]: ``sets`` of
    (directions [n, 3], limits [n], skipped target, open [n] bool). A ray
    of a set is occluded when a primitive not owned by the skipped target
    hits it at t < its limit; lanes not open come back False."""
    n = o.shape[0]
    out = torch.zeros((n, len(sets)), dtype=torch.bool, device=o.device)
    for b in _blocks(n, sc.total):
        org = _Origins(sc, o[b])
        for k, (d, limit, skip, open_) in enumerate(sets):
            lim = limit[b][:, None]
            acc = torch.zeros((b.stop - b.start,), dtype=torch.bool,
                              device=o.device)
            for kind, grid in enumerate(org.grids(sc, d[b])):
                if grid.shape[1]:
                    hit = (grid < lim) & (sc.owners(kind) != skip)
                    acc |= hit.any(dim=1)
            out[b, k] = acc & open_[b]
    return out


def chord_loss(sc: Scene, o, d, skip: int):
    """[n] sum over primitives not owned by ``skip`` of the chord length
    through each along the unbounded ray times its density (|d| = 1)."""
    ns, na, _ = sc.counts
    dens = (sc.density[:ns], sc.density[ns:ns + na], sc.density[ns + na:])
    own = [sc.owners(k) != skip for k in range(3)]
    # Spheres: the half-b quadratic.
    oc = o[:, None, :] - sc.sc
    b = _dot(oc, d[:, None, :])
    c = _dot(oc, oc) - sc.sr * sc.sr
    disc = b * b - c
    s = torch.sqrt(torch.where(disc > 0.0, disc, 0.0))
    t_in, t_out = -b - s, -b + s
    chord = torch.clamp(t_out - torch.clamp(t_in, min=0.0), min=0.0)
    ok = (disc >= 0.0) & (t_out >= 0.0) & own[0]
    loss = (torch.where(ok, chord, 0.0) * dens[0]).sum(-1)

    def box(t_near, t_far, mask, density):
        ch = torch.clamp(t_far - torch.clamp(t_near, min=0.0), min=0.0)
        ok = (t_near <= t_far) & (t_far >= 0.0) & mask
        return (torch.where(ok, ch, 0.0) * density).sum(-1)

    org = _Origins(sc, o)
    loss = loss + box(*_slab(org.a_lo, org.a_hi, 1.0 / _nudge(d)[:, None]),
                      own[1], dens[1])
    ld = (d @ sc.rot_t).view(d.shape[0], -1, 3)
    return loss + box(*_slab(org.b_lo, org.b_hi, 1.0 / _nudge(ld)),
                      own[2], dens[2])


# -- reflection -------------------------------------------------------------


def _axis_normal(local, half):
    delta = half - local.abs()
    dx, dy, dz = delta.unbind(-1)
    px = (dx < dy) & (dx < dz)
    py = ~px & (dy < dx) & (dy < dz)
    pz = ~(px | py)
    return torch.where(torch.stack([px, py, pz], dim=-1),
                       torch.sign(local), 0.0)


def _normal(sc: Scene, p, idx):
    """Face normal at hit points p [n, 3] of primitives idx [n]."""
    ns, na, _ = sc.counts
    n = torch.zeros_like(p)
    sph = idx < ns
    box = (idx >= ns) & (idx < ns + na)
    obb = idx >= ns + na
    if sph.any():
        v = p[sph] - sc.sc[idx[sph]]
        n[sph] = v / _norm(v)[:, None]
    if box.any():
        j = idx[box] - ns
        n[box] = _axis_normal(p[box] - sc.ac[j], sc.ah[j])
    if obb.any():
        j = idx[obb] - ns - na
        q = sc.oq[j]
        fwd = torch.cat([-q[:, :3], q[:, 3:]], dim=-1)
        local = rotate(fwd, p[obb] - sc.oc[j])
        n[obb] = rotate(q, _axis_normal(local, sc.oh[j]))
    return n


# -- the frame --------------------------------------------------------------


def batch_ids(ray_count: int, num_batches: int, device):
    """Per-ray accumulation batch, the upstream thread-batch mapping."""
    size = -(-ray_count // num_batches)
    r = torch.arange(ray_count, device=device)
    return ((r // size) * size * num_batches) // ray_count


@torch.no_grad()
def frame(layout: dict, origin, cfg: dict, device, directions=None):
    """One frame for the listener at ``origin`` [3]: a dict of the
    per-target settings (muffle [T], reverb_strength, reverb_volume,
    perceived_position [T, 3]), the impulse response ``reverb_ir``
    [num_reverb_bins] (when on), the raw ``echo_distances`` [R, H],
    ``muffle_hits`` [B, T] and ``permeation`` [B, T], and ``counts``: per
    bounce the rays alive on entry, the live hits and the open (ray, set)
    pairs of the occlusion tests. ``cfg`` holds the trace settings by
    their ``TraceConfig`` names; ``directions`` default to the Fibonacci
    set. Matrix products run in full float32 (no TF32)."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _frame(layout, origin, cfg, device, directions)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def _frame(layout: dict, origin, cfg: dict, device, directions=None):
    sc = Scene(layout, device)
    R, H = cfg["ray_count"], cfg["max_bounces"] + 1
    B, T = cfg["num_accum_batches"], sc.targets.shape[0]
    eps, life0 = cfg["epsilon"], cfg["max_ray_life"]
    far = cfg["max_muffle_hit_distance"]
    origin = torch.as_tensor(origin, dtype=torch.float32).to(device)
    d_all = (fibonacci_directions(R, device) if directions is None
             else directions.to(device=device, dtype=torch.float32))
    bid = batch_ids(R, B, device)
    echo = torch.zeros((R, H), device=device)
    muffle = torch.zeros((B, T), dtype=torch.int64, device=device)
    first_t = torch.full((R,), INF, device=device)
    counts = dict(alive=[0] * H, live=[0] * H, open_pairs=[0] * H)

    # All bounces of a block of rays at a time (the grids inside are
    # blocked again by their primitive count).
    for start in range(0, R, RAY_BLOCK):
        blk = slice(start, min(start + RAY_BLOCK, R))
        n = blk.stop - blk.start
        rows = torch.arange(blk.start, blk.stop, device=device)
        o = origin.expand(n, 3).clone()
        d = d_all[blk].clone()
        life = torch.full((n,), life0, device=device)
        alive = torch.ones((n,), dtype=torch.bool, device=device)
        for step in range(H):
            a_idx = alive.nonzero().squeeze(1)
            counts["alive"][step] += int(a_idx.numel())
            if a_idx.numel() == 0:
                break
            t_a, w_a = closest_hit(sc, o[a_idx], d[a_idx])
            if step == 0:
                first_t[rows[a_idx]] = t_a
            hit = torch.isfinite(t_a)
            idx = a_idx[hit]  # live hits, as block positions
            w = w_a[hit]
            counts["live"][step] += int(idx.numel())
            if idx.numel() == 0:
                break
            t = t_a[hit]
            oi, di = o[idx], d[idx]
            p = oi + di * t[:, None]
            lf = life[idx] - t
            off = p - di * eps
            # Echo ray back to the listener (cs:121-147).
            dist_echo = _norm(origin - p)
            to_o = origin - off
            sets = [(to_o / _norm(to_o)[:, None], dist_echo, NO_SKIP,
                     torch.ones_like(dist_echo, dtype=torch.bool))]
            # One muffle ray per target (cs:150-175).
            for k in range(T):
                to_t = sc.targets[k] - off
                dist = _norm(to_t)
                sets.append((to_t / dist[:, None], dist, k, dist < far))
            for _, _, _, open_ in sets:
                counts["open_pairs"][step] += int(open_.sum())
            vis = ~occluded(sc, off, sets)
            vis = [vis[:, k] & sets[k][3] for k in range(len(sets))]
            echo[rows[idx], step] = torch.where(
                vis[0], dist_echo * sc.echo[w], 0.0)
            if T:
                inc = torch.stack(vis[1:], dim=-1).to(torch.int64)
                muffle.index_add_(0, bid[rows[idx]], inc)
            # Termination and reflection (cs:179-193, 456-532).
            go = (lf > 0.0) & (step + 1 < H)
            nrm = _normal(sc, p, w)
            d_new = di - 2.0 * _dot(di, nrm)[:, None] * nrm
            lf_new = lf - life0 * sc.absorption[w]
            o[idx] = torch.where(go[:, None], p + d_new * eps, p)
            d[idx] = torch.where(go[:, None], d_new, di)
            life[idx] = torch.where(go, lf_new, lf)
            alive = torch.zeros_like(alive)
            alive[idx] = go & (lf_new >= 0.0)

    perm = _permeation(sc, origin, d_all, first_t, bid, cfg)
    out = _process(echo, muffle, perm, sc.targets, cfg)
    if cfg["num_reverb_bins"] > 0:
        out["reverb_ir"] = impulse_response(echo, cfg)
    out["counts"] = counts
    out["echo_distances"] = echo
    out["muffle_hits"] = muffle
    out["permeation"] = perm
    return out


def _permeation(sc: Scene, origin, d_all, first_t, bid, cfg):
    """[B, T]: the last hitting ray of each batch overwrites its slot
    (AudioPermeationJobBatched.cs:85); batches with no hit keep 0."""
    R = d_all.shape[0]
    B, T = cfg["num_accum_batches"], sc.targets.shape[0]
    out = torch.zeros((B, T), device=d_all.device)
    hit = torch.isfinite(first_t)
    for b in range(B):
        rays = (hit & (bid == b)).nonzero().squeeze(1)
        if rays.numel() == 0 or T == 0:
            continue
        r = rays[-1]
        d = d_all[r]
        p = origin + d * first_t[r]
        off = (p - d * cfg["epsilon"])[None]
        for k in range(T):
            to_t = sc.targets[k] - off
            dirs = to_t / _norm(to_t)[:, None]
            loss = chord_loss(sc, off, dirs, k)[0]
            out[b, k] = R * cfg["permeation_strength_per_ray"] - loss
    return out


def impulse_response(echo, cfg):
    """[n_bins] echo count per arrival-time bin: each clear echo splats
    linearly onto its two neighbouring bins; beyond the window, the last."""
    n = cfg["num_reverb_bins"]
    dist = echo.reshape(-1)
    w = (dist > 0.0).to(torch.float32)
    pos = torch.clamp(dist * (n / cfg["ir_max_distance"]), 0.0, n - 1.0)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    ir = torch.zeros((n,), device=echo.device)
    ir.index_add_(0, i0, w * (1.0 - frac))
    ir.index_add_(0, i1, w * frac)
    return ir


def _process(echo, muffle, perm, targets, cfg):
    """ProcessAudioDataJob: reverb statistics and per-target muffle,
    saturated to [0, 1]."""
    R, H = echo.shape
    slots = R * H
    strength = torch.sum(echo) / slots / cfg["max_reverb_distance"]
    volume = torch.sum(echo == 0.0).to(torch.float32) / slots
    hits = muffle.sum(0).to(torch.float32)
    m = 1.0 - hits / slots * cfg["muffle_effectiveness"]
    p = (perm.sum(0) / R / cfg["permeation_strength_per_ray"]
         * cfg["permeation_effectiveness"])
    return dict(muffle=torch.clamp(m - p, 0.0, 1.0),
                reverb_strength=torch.clamp(strength, 0.0, 1.0),
                reverb_volume=torch.clamp(volume, 0.0, 1.0),
                perceived_position=targets.clone())
