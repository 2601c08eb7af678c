"""B2-B5: the fused multi-ray-set kernels and the chord adjoints.

``run_multi_any_hit`` replaces the TPU kernel
``audio_raytracer_tpu/ops/pallas/fused.py::multi_any_hit_kernel`` and
``run_multi_chord`` replaces ``fused.py::multi_chord_kernel``. Both take
S ray sets that share one origin and walk the primitives once for all
sets (the one-pass structure of the reference's bounce body,
AudioRaytracerJobBatched.cs:104-207, and of its permeation job,
AudioPermeationJobBatched.cs:57-89). ``run_multi_chord_dens_bwd`` (B4)
and ``run_multi_chord_bwd`` (B5) replace ``fused.py::
multi_chord_dens_bwd_kernel`` and ``multi_chord_bwd_kernel``, the
hand-closed adjoints of B3 that ``ops/cuda/diff.py`` wires into autograd.

On a CUDA tensor each wrapper launches its kernel (``csrc/*.cu``); on a
CPU tensor it runs the plain version beside it, which repeats the
kernel's arithmetic. A CUDA tensor never takes the plain version.
"""

from __future__ import annotations

import torch

from audio_raytracer_tpu_torch.ops.backend import ray_chunks
from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.ops.cuda.kernels import (
    A_DENS,
    A_MISS,
    A_TGT,
    O_DENS,
    O_M,
    O_MISS,
    O_TGT,
    S_DENS,
    S_R2,
    S_TGT,
    Fields,
    box_inv_dirs,
    box_terms,
    check_operands,
    ids,
    mat_rotate,
    occlusion_tables,
    on_cpu,
    ray_cols,
    safe_inv,
    skips_arg,
    slab,
    slab_hit,
    stream_of,
    table_args,
    table_ptr,
)

Tensor = torch.Tensor

# Ray sets one launch takes (csrc/fields.cuh MAX_SETS); the wrappers
# launch once per group of at most this many sets.
MAX_SETS = 16

# Float operations per (live ray, primitive) as (shared, per set), for
# the op-count bounds. B4 does B3's work per (ray, primitive, set) with g
# in place of the density (CHORD_OPS); CHORD_BWD_OPS counts B5's ray
# kernel (csrc/multi_chord_bwd.cu), the chord itself included. B5's
# density gradients add one multiply-add of gv x chord per (ray,
# primitive, set), which it computes by running B4's kernel.
OCC_OPS = {"sphere": (10, 15), "aabb": (6, 21), "obb": (27, 42)}
CHORD_OPS = {"sphere": (9, 18), "aabb": (7, 23), "obb": (28, 44)}
CHORD_BWD_OPS = {"sphere": (9, 62), "aabb": (7, 111), "obb": (46, 156)}
# The same ray kernel under the BALANCED tie rule (B8's, at S = 1): the
# tie tests of max(., 0) add 4 per sphere (a compare and a select each);
# a box adds the 11 compares that find a tie (csrc/chord.cuh::box_tie)
# and, with none, takes B5's closed form. The balanced chains that run
# only on a tie are not counted: random rays meet none.
CHORD_BWD_BALANCED_OPS = {"sphere": (9, 66), "aabb": (7, 122),
                          "obb": (46, 167)}


def set_groups(S: int) -> list[slice]:
    """The sets of one launch each: consecutive groups of at most
    MAX_SETS."""
    if S < 1:
        raise ValueError("no ray sets")
    return [slice(a, min(a + MAX_SETS, S)) for a in range(0, S, MAX_SETS)]


def _stack_dirs(dirs):
    """Direction tensors [R, 3] -> one contiguous [S, R, 3]."""
    return torch.stack([x.to(torch.float32) for x in dirs]).contiguous()


# ---------------------------------------------------------------------------
# B2: multi-set occlusion
# ---------------------------------------------------------------------------


def multi_any_hit_plain(fields: Fields, o: Tensor, dirs, limits: Tensor,
                        skips, init_occ: Tensor) -> Tensor:
    """Plain version of B2: [R, S] bool, init lanes True."""
    R, S = limits.shape
    out = init_occ.clone()
    for c in ray_chunks(R, fields.total):
        ox, oy, oz = ray_cols(o, c)
        sets = [ray_cols(x, c) for x in dirs]
        lims = [limits[c, s:s + 1] for s in range(S)]
        occ = out[c]  # a view: updated in place
        if fields.counts[0]:
            sph = fields.sph
            tgt = ids(sph, S_TGT)
            ocx, ocy, ocz = ox - sph[:, 0], oy - sph[:, 1], oz - sph[:, 2]
            cc = (ocx * ocx + ocy * ocy + ocz * ocz) - sph[:, S_R2]
            c_pos = cc >= 0.0
            for s, (dx, dy, dz) in enumerate(sets):
                lim = lims[s]
                h = ocx * dx + ocy * dy + ocz * dz
                hl = h + lim
                q = lim * (hl + h) + cc
                entering = c_pos & (h <= 0.0) & ((hl > 0.0) | (q < 0.0))
                inside = ~c_pos & (hl > 0.0) & (q > 0.0)
                hits = (h * h >= cc) & (entering | inside) & (tgt != skips[s])
                occ[:, s] |= hits.any(dim=-1)
        for kind, tab, miss, tcol in (("aabb", fields.aabb, A_MISS, A_TGT),
                                      ("obb", fields.obb, O_MISS, O_TGT)):
            if not tab.shape[0]:
                continue
            tgt = ids(tab, tcol)
            terms = box_terms(fields, kind, ox, oy, oz)
            for s, (dx, dy, dz) in enumerate(sets):
                inv = box_inv_dirs(fields, kind, dx, dy, dz)
                t = slab_hit(*slab(*terms, *inv)) + tab[:, miss]
                occ[:, s] |= ((t < lims[s]) & (tgt != skips[s])).any(dim=-1)
    return out


def occlusion_args(fields: Fields, skips, device) -> list:
    """The tables' arguments of one B2 launch: per type (pointer, free
    rows, owned rows), each table checked by ``table_ptr``."""
    args = []
    for tab, n_free, n_owned in occlusion_tables(fields, skips):
        args += [table_ptr(tab, device), n_free, n_owned]
    return args


def run_multi_any_hit(fields: Fields, o: Tensor, dirs, limits: Tensor,
                      skips, init_occ: Tensor) -> Tensor:
    """B2: occlusion of S ray sets sharing the origins o [R, 3].

    dirs: S tensors [R, 3], normalized (the sphere test assumes
    |d| = 1); limits: [R, S] float32; skips: S ints (NO_SKIP or the
    target id whose colliders the set ignores); init_occ: [R, S] bool
    pre-resolved lanes. Returns [R, S] bool, init lanes True. One launch
    per group of at most MAX_SETS sets."""
    if on_cpu(o):
        return multi_any_hit_plain(fields, o, dirs, limits, skips, init_occ)
    lib = build.load("multi_any_hit")
    dev = o.device
    R, S = limits.shape
    check_operands(dev, o, limits)
    check_operands(dev, init_occ, dtypes=(torch.bool,))
    parts = []
    for g in set_groups(S):
        stacked = _stack_dirs(dirs[g])
        check_operands(dev, stacked)
        lim, init = limits[:, g].contiguous(), init_occ[:, g].contiguous()
        occ = torch.empty((R, g.stop - g.start), dtype=torch.bool,
                          device=dev)
        keep, skips_ptr = skips_arg(skips[g])
        err = lib.multi_any_hit(o.data_ptr(), stacked.data_ptr(),
                                lim.data_ptr(), init.data_ptr(), R,
                                g.stop - g.start, skips_ptr,
                                *occlusion_args(fields, skips[g], dev),
                                occ.data_ptr(), stream_of(dev))
        build.check("multi_any_hit", err)
        if R:
            run_multi_any_hit.launches += 1
        parts.append(occ)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


run_multi_any_hit.launches = 0


# ---------------------------------------------------------------------------
# B3: multi-set permeation chords
# ---------------------------------------------------------------------------


def _sphere_oc(sph, ox, oy, oz):
    """(oc xyz, |oc|^2 - r2) grids shared by every set of one sphere."""
    ocx, ocy, ocz = ox - sph[:, 0], oy - sph[:, 1], oz - sph[:, 2]
    return ocx, ocy, ocz, (ocx * ocx + ocy * ocy + ocz * ocz) - sph[:, S_R2]


def _sphere_chord(ocx, ocy, ocz, cc, dx, dy, dz) -> dict:
    """Chord of the unbounded ray through a sphere (half-b quadratic,
    |d| = 1) and the intermediates its adjoint needs (csrc/chord.cuh::
    sphere_chord)."""
    b = ocx * dx + ocy * dy + ocz * dz
    disc = b * b - cc
    hit = disc >= 0.0
    sq = torch.sqrt(torch.where(hit, disc, 1.0))
    t_exit = -b + sq
    enter_raw = -b - sq
    chord_raw = t_exit - torch.clamp(enter_raw, min=0.0)
    return dict(b=b, hit=hit, sq=sq, t_exit=t_exit, enter_raw=enter_raw,
                chord_raw=chord_raw, chord=torch.clamp(chord_raw, min=0.0))


def _box_chord(terms, inv):
    """(t_near, t_far, chord_raw, chord, valid-interval) of one set
    against each box, from the shared (bound - origin) terms."""
    tn, tf = slab(*terms, *inv)
    chord_raw = tf - torch.clamp(tn, min=0.0)
    return tn, tf, chord_raw, torch.clamp(chord_raw, min=0.0), \
        (tn <= tf) & (tf >= 0.0)


def multi_chord_plain(fields: Fields, o: Tensor, dirs, skips) -> Tensor:
    """Plain version of B3: [R, S] float32 chord x density sums."""
    R, S = o.shape[0], len(dirs)
    out = torch.zeros((R, S), device=o.device)
    for c in ray_chunks(R, fields.total):
        ox, oy, oz = ray_cols(o, c)
        sets = [ray_cols(x, c) for x in dirs]
        acc = out[c]  # a view: updated in place
        if fields.counts[0]:
            sph = fields.sph
            tgt, dens = ids(sph, S_TGT), sph[:, S_DENS]
            ocx, ocy, ocz, cc = _sphere_oc(sph, ox, oy, oz)
            for s, (dx, dy, dz) in enumerate(sets):
                c_ = _sphere_chord(ocx, ocy, ocz, cc, dx, dy, dz)
                valid = c_["hit"] & (c_["t_exit"] >= 0.0) & (tgt != skips[s])
                acc[:, s] += (torch.where(valid, c_["chord"], 0.0)
                              * dens).sum(-1)
        for kind, tab, miss, tcol, dcol in (
                ("aabb", fields.aabb, A_MISS, A_TGT, A_DENS),
                ("obb", fields.obb, O_MISS, O_TGT, O_DENS)):
            if not tab.shape[0]:
                continue
            tgt, dens = ids(tab, tcol), tab[:, dcol]
            ok = tab[:, miss] == 0.0
            terms = box_terms(fields, kind, ox, oy, oz)
            for s, (dx, dy, dz) in enumerate(sets):
                inv = box_inv_dirs(fields, kind, dx, dy, dz)
                _, _, _, chord, meet = _box_chord(terms, inv)
                valid = meet & (tgt != skips[s]) & ok
                acc[:, s] += (torch.where(valid, chord, 0.0) * dens).sum(-1)
    return out


def run_multi_chord(fields: Fields, o: Tensor, dirs, skips) -> Tensor:
    """B3: permeation chord x density sums along the unbounded rays of S
    target sets sharing the origins o [R, 3]. dirs: S normalized [R, 3];
    skips: S target ids. Returns [R, S] float32. One launch per group of
    at most MAX_SETS sets."""
    if on_cpu(o):
        return multi_chord_plain(fields, o, dirs, skips)
    lib = build.load("multi_chord")
    dev = o.device
    R, S = o.shape[0], len(dirs)
    check_operands(dev, o)
    parts = []
    for g in set_groups(S):
        stacked = _stack_dirs(dirs[g])
        check_operands(dev, stacked)
        out = torch.empty((R, g.stop - g.start), device=dev)
        keep, skips_ptr = skips_arg(skips[g])
        err = lib.multi_chord(o.data_ptr(), stacked.data_ptr(), R,
                              g.stop - g.start, skips_ptr,
                              *table_args(fields, dev), out.data_ptr(),
                              stream_of(dev))
        build.check("multi_chord", err)
        if R:
            run_multi_chord.launches += 1
        parts.append(out)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


run_multi_chord.launches = 0


# ---------------------------------------------------------------------------
# B4 and B5: the chord adjoints
# ---------------------------------------------------------------------------


def _gbar_cols(gbar: Tensor, c: slice, S: int):
    return [gbar[c, s:s + 1] for s in range(S)]


def multi_chord_dens_bwd_plain(fields: Fields, o: Tensor, dirs, skips,
                               gbar: Tensor):
    """Plain version of B4: per primitive, the sum over rays and sets of
    gbar x chord, as (sphere [ns], aabb [na], obb [no]) float32. Each
    (ray, primitive) first sums its sets in order, as the kernel does."""
    R, S = o.shape[0], len(dirs)
    grads = [torch.zeros((n,), device=o.device) for n in fields.counts]
    for c in ray_chunks(R, fields.total):
        ox, oy, oz = ray_cols(o, c)
        sets = [ray_cols(x, c) for x in dirs]
        gs = _gbar_cols(gbar, c, S)
        if fields.counts[0]:
            sph = fields.sph
            tgt = ids(sph, S_TGT)
            ocx, ocy, ocz, cc = _sphere_oc(sph, ox, oy, oz)
            gd = torch.zeros_like(ocx)
            for s, (dx, dy, dz) in enumerate(sets):
                c_ = _sphere_chord(ocx, ocy, ocz, cc, dx, dy, dz)
                valid = c_["hit"] & (c_["t_exit"] >= 0.0) & (tgt != skips[s])
                gd = gd + torch.where(valid, c_["chord"], 0.0) * gs[s]
            grads[0] += gd.sum(0)
        for i, kind, tab, miss, tcol in ((1, "aabb", fields.aabb, A_MISS,
                                          A_TGT),
                                         (2, "obb", fields.obb, O_MISS,
                                          O_TGT)):
            if not tab.shape[0]:
                continue
            tgt = ids(tab, tcol)
            ok = tab[:, miss] == 0.0
            terms = box_terms(fields, kind, ox, oy, oz)
            gd = torch.zeros_like(terms[0])
            for s, (dx, dy, dz) in enumerate(sets):
                inv = box_inv_dirs(fields, kind, dx, dy, dz)
                _, _, _, chord, meet = _box_chord(terms, inv)
                valid = meet & (tgt != skips[s]) & ok
                gd = gd + torch.where(valid, chord, 0.0) * gs[s]
            grads[i] += gd.sum(0)
    return tuple(grads)


def _box_chord_adjoint(gv, dens, valid, tn, tf, chord_raw, mn, mx, inv):
    """Adjoint of one box chord with respect to its slab inputs
    (csrc/chord.cuh::box_chord_adjoint; JAX ops/pallas/fused.py::
    _box_chord_adjoint). Returns per axis (g_mn, g_mx, g_inv).
    Subgradients: a one-hot on the first axis whose slab bound equals
    t_near / t_far, and t0 taken as the near side on ties."""
    g_chord = torch.where(valid, dens, 0.0) * gv * (chord_raw > 0.0)
    g_tnear = -g_chord * (tn > 0.0)
    t0 = [m * i for m, i in zip(mn, inv)]
    t1 = [m * i for m, i in zip(mx, inv)]
    fx = tf == torch.maximum(t0[0], t1[0])
    fy = (tf == torch.maximum(t0[1], t1[1])) & ~fx
    nx = tn == torch.minimum(t0[0], t1[0])
    ny = (tn == torch.minimum(t0[1], t1[1])) & ~nx
    far, near = (fx, fy, ~(fx | fy)), (nx, ny, ~(nx | ny))
    g_mn, g_mx, g_inv = [], [], []
    for a in range(3):
        g_tfa = torch.where(far[a], g_chord, 0.0)
        g_tna = torch.where(near[a], g_tnear, 0.0)
        t0_near = t0[a] <= t1[a]
        g_t0 = torch.where(t0_near, g_tna, g_tfa)
        g_t1 = torch.where(t0_near, g_tfa, g_tna)
        g_mn.append(g_t0 * inv[a])
        g_mx.append(g_t1 * inv[a])
        g_inv.append(g_t0 * mn[a] + g_t1 * mx[a])
    return g_mn, g_mx, g_inv


def _inv_dir_grad(g_inv, d, inv):
    """Pull g_inv back through inv = 1 / nudged(d): zero where |d| < 1e-12
    (the nudge region)."""
    return -g_inv * inv * inv * (d.abs() >= 1e-12)


def _mat_rotate_t(tab: Tensor, vx, vy, vz):
    """M^T v for the 9 matrix columns O_M.. of an OBB table."""
    m = [tab[:, O_M + k] for k in range(9)]
    return (m[0] * vx + m[3] * vy + m[6] * vz,
            m[1] * vx + m[4] * vy + m[7] * vz,
            m[2] * vx + m[5] * vy + m[8] * vz)


def multi_chord_bwd_plain(fields: Fields, o: Tensor, dirs, skips,
                          gbar: Tensor):
    """Plain version of B5: (d_o [R, 3], d_dirs S x [R, 3], density grads
    as B4 returns them). Per (ray, primitive, set) the same arithmetic as
    csrc/multi_chord_bwd.cu; the sums over primitives run in another
    order."""
    R, S = o.shape[0], len(dirs)
    d_o = torch.zeros((R, 3), device=o.device)
    d_dirs = [torch.zeros((R, 3), device=o.device) for _ in range(S)]
    for c in ray_chunks(R, fields.total):
        ox, oy, oz = ray_cols(o, c)
        sets = [ray_cols(x, c) for x in dirs]
        gs = _gbar_cols(gbar, c, S)
        go = [0.0, 0.0, 0.0]  # per-(ray, primitive) grids, summed below
        gd = [[0.0, 0.0, 0.0] for _ in range(S)]

        def add(acc, terms):
            for a in range(3):
                acc[a] = acc[a] + terms[a].sum(-1, keepdim=True)

        if fields.counts[0]:
            sph = fields.sph
            tgt, dens = ids(sph, S_TGT), sph[:, S_DENS]
            ocx, ocy, ocz, cc = _sphere_oc(sph, ox, oy, oz)
            for s, (dx, dy, dz) in enumerate(sets):
                c_ = _sphere_chord(ocx, ocy, ocz, cc, dx, dy, dz)
                hit = c_["hit"]
                valid = hit & (c_["t_exit"] >= 0.0) & (tgt != skips[s])
                gv = torch.where(valid, gs[s], 0.0)
                g_chord = gv * dens * (c_["chord_raw"] > 0.0)
                g_enter = -g_chord * (c_["enter_raw"] > 0.0)
                g_b = -g_chord - g_enter
                g_sq = g_chord - g_enter
                # Zero where the ray is exactly tangent (sq == 0).
                g_disc = torch.where(hit & (c_["sq"] > 0.0),
                                     g_sq * 0.5 / c_["sq"], 0.0)
                g_b = g_b + 2.0 * c_["b"] * g_disc
                g_cc = -g_disc
                add(go, [g_b * d_ + 2.0 * oc * g_cc
                         for d_, oc in ((dx, ocx), (dy, ocy), (dz, ocz))])
                add(gd[s], [g_b * ocx, g_b * ocy, g_b * ocz])
        if fields.counts[1]:
            tab = fields.aabb
            tgt, dens = ids(tab, A_TGT), tab[:, A_DENS]
            ok = tab[:, A_MISS] == 0.0
            terms = box_terms(fields, "aabb", ox, oy, oz)
            for s, (dx, dy, dz) in enumerate(sets):
                inv = box_inv_dirs(fields, "aabb", dx, dy, dz)
                tn, tf, chord_raw, _, meet = _box_chord(terms, inv)
                valid = meet & (tgt != skips[s]) & ok
                gv = torch.where(valid, gs[s], 0.0)
                g_mn, g_mx, g_inv = _box_chord_adjoint(
                    gv, dens, valid, tn, tf, chord_raw, terms[:3], terms[3:],
                    inv)
                add(go, [-(g_mn[a] + g_mx[a]) for a in range(3)])
                add(gd[s], [_inv_dir_grad(g_inv[a], d_, inv[a])
                            for a, d_ in enumerate((dx, dy, dz))])
        if fields.counts[2]:
            tab = fields.obb
            tgt, dens = ids(tab, O_TGT), tab[:, O_DENS]
            ok = tab[:, O_MISS] == 0.0
            terms = box_terms(fields, "obb", ox, oy, oz)
            g_lo = [0.0, 0.0, 0.0]
            for s, (dx, dy, dz) in enumerate(sets):
                ld = mat_rotate(tab, dx, dy, dz)
                inv = tuple(safe_inv(v) for v in ld)
                tn, tf, chord_raw, _, meet = _box_chord(terms, inv)
                valid = meet & (tgt != skips[s]) & ok
                gv = torch.where(valid, gs[s], 0.0)
                g_mn, g_mx, g_inv = _box_chord_adjoint(
                    gv, dens, valid, tn, tf, chord_raw, terms[:3], terms[3:],
                    inv)
                g_lo = [g_lo[a] - (g_mn[a] + g_mx[a]) for a in range(3)]
                g_ld = [_inv_dir_grad(g_inv[a], ld[a], inv[a])
                        for a in range(3)]
                add(gd[s], _mat_rotate_t(tab, *g_ld))
            add(go, _mat_rotate_t(tab, *g_lo))
        for a in range(3):
            d_o[c, a:a + 1] = go[a]
            for s in range(S):
                d_dirs[s][c, a:a + 1] = gd[s][a]
    return d_o, d_dirs, multi_chord_dens_bwd_plain(fields, o, dirs, skips,
                                                   gbar)


def _dens_outs(fields: Fields, device):
    return tuple(torch.zeros((n,), device=device) for n in fields.counts)


# B4 stages its ray records in tiles (csrc/multi_chord_dens_bwd.cu
# RAY_TILE_PAD): the record list is padded to a multiple of this many.
RAY_TILE_PAD = 128


def dens_records(o: Tensor, stacked: Tensor, g: Tensor):
    """B4's ray records for o [R, 3], the directions stacked [S, R, 3] and
    the cotangents g [R, S]: two [Rp, 1 + S, 4] float32 tensors, Rp = R
    padded to a multiple of RAY_TILE_PAD. Record r is a head (o[r], live)
    and per set s (d[s, r], g[r, s]) in the first, (safe_inv(d[s, r]),
    g[r, s]) in the second; live is 1.0 where a cotangent of the ray is
    nonzero, else 0.0. Padding records are zero (not live)."""
    R, S = o.shape[0], stacked.shape[0]
    Rp = -(-R // RAY_TILE_PAD) * RAY_TILE_PAD
    d = stacked.transpose(0, 1)
    live = (g != 0).any(dim=1).to(torch.float32)
    out = []
    for x in (d, safe_inv(d)):
        rec = torch.zeros((Rp, 1 + S, 4), device=o.device)
        rec[:R, 0, :3] = o
        rec[:R, 0, 3] = live
        rec[:R, 1:, :3] = x
        rec[:R, 1:, 3] = g
        out.append(rec)
    return tuple(out)


def launch_dens_bwd(lib, fields: Fields, o, stacked, g, skips, outs):
    """One launch of B4's kernel for the sets of ``stacked`` [S, R, 3]
    (S <= MAX_SETS) with cotangents g [R, S] and skip targets ``skips``,
    adding into the density gradients ``outs``. B5 and B8 launch it too."""
    dev = o.device
    rec_d, rec_inv = dens_records(o, stacked, g)
    keep, skips_ptr = skips_arg(skips)
    err = lib.multi_chord_dens_bwd(
        rec_d.data_ptr(), rec_inv.data_ptr(), rec_d.shape[0],
        stacked.shape[0], skips_ptr, *table_args(fields, dev),
        *(x.data_ptr() for x in outs), stream_of(dev))
    build.check("multi_chord_dens_bwd", err)


def _bwd_groups(o, dirs, gbar):
    """Checked operands per launch group: (slice, stacked dirs, gbar
    columns)."""
    dev = o.device
    check_operands(dev, o, gbar)
    for g in set_groups(len(dirs)):
        stacked = _stack_dirs(dirs[g])
        cols = gbar[:, g].contiguous()
        check_operands(dev, stacked, cols)
        yield g, stacked, cols


def run_multi_chord_dens_bwd(fields: Fields, o: Tensor, dirs, skips,
                             gbar: Tensor):
    """B4: the density adjoint of B3. o [R, 3], dirs S normalized [R, 3],
    skips S ids, gbar [R, S] cotangents of B3's output. Returns (sphere,
    aabb, obb) density gradients, each [n_type] float32. One launch per
    group of at most MAX_SETS sets, accumulating into the same outputs."""
    if on_cpu(o):
        return multi_chord_dens_bwd_plain(fields, o, dirs, skips, gbar)
    lib = build.load("multi_chord_dens_bwd")
    dev, R = o.device, o.shape[0]
    outs = _dens_outs(fields, dev)
    for g, stacked, cols in _bwd_groups(o, dirs, gbar):
        launch_dens_bwd(lib, fields, o, stacked, cols, skips[g], outs)
        if R:
            run_multi_chord_dens_bwd.launches += 1
    return outs


run_multi_chord_dens_bwd.launches = 0


def run_multi_chord_bwd(fields: Fields, o: Tensor, dirs, skips,
                        gbar: Tensor):
    """B5: the full adjoint of B3. Returns (d_o [R, 3], d_dirs S x [R, 3],
    density gradients as B4 returns them).

    Per group of at most MAX_SETS sets it makes two launches, both
    counted here: the ray-parallel kernel of csrc/multi_chord_bwd.cu for
    d_o and d_dirs, and B4's primitive-parallel kernel for the density
    gradients (the same quantity, gv x chord)."""
    if on_cpu(o):
        return multi_chord_bwd_plain(fields, o, dirs, skips, gbar)
    lib = build.load("multi_chord_bwd")
    dens_lib = build.load("multi_chord_dens_bwd")
    dev, R = o.device, o.shape[0]
    outs = _dens_outs(fields, dev)
    d_o = torch.zeros((R, 3), device=dev)
    d_dirs = []
    for g, stacked, cols in _bwd_groups(o, dirs, gbar):
        keep, skips_ptr = skips_arg(skips[g])
        part_o = torch.empty((R, 3), device=dev)
        part_d = torch.empty_like(stacked)
        err = lib.multi_chord_bwd(o.data_ptr(), stacked.data_ptr(),
                                  cols.data_ptr(), R, stacked.shape[0],
                                  skips_ptr, *table_args(fields, dev),
                                  part_o.data_ptr(), part_d.data_ptr(),
                                  stream_of(dev))
        build.check("multi_chord_bwd", err)
        launch_dens_bwd(dens_lib, fields, o, stacked, cols, skips[g], outs)
        if R:
            run_multi_chord_bwd.launches += 2
        d_o += part_o
        d_dirs += list(part_d.unbind(0))
    return d_o, d_dirs, outs


run_multi_chord_bwd.launches = 0
