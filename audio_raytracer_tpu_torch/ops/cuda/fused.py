"""B2 and B3: the fused multi-ray-set kernels.

``run_multi_any_hit`` replaces the TPU kernel
``audio_raytracer_tpu/ops/pallas/fused.py::multi_any_hit_kernel`` and
``run_multi_chord`` replaces ``fused.py::multi_chord_kernel``. Both take
S ray sets that share one origin and walk the primitives once for all
sets (the one-pass structure of the reference's bounce body,
AudioRaytracerJobBatched.cs:104-207, and of its permeation job,
AudioPermeationJobBatched.cs:57-89).

On a CUDA tensor each wrapper launches its kernel (``csrc/*.cu``); on a
CPU tensor it runs the plain version beside it, which repeats the
kernel's arithmetic. A CUDA tensor never takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from audio_raytracer_tpu_torch.ops.backend import ray_chunks
from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.ops.cuda.kernels import (
    A_DENS,
    A_MISS,
    A_TGT,
    O_DENS,
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
    on_cpu,
    ray_cols,
    slab,
    slab_hit,
    stream_of,
    table_args,
)

Tensor = torch.Tensor

# Ray sets one launch takes (csrc/fields.cuh MAX_SETS); the wrappers
# launch once per group of at most this many sets.
MAX_SETS = 16

# Float operations per (live ray, primitive) as (shared, per set), for
# the op-count bounds.
OCC_OPS = {"sphere": (10, 15), "aabb": (6, 21), "obb": (27, 42)}
CHORD_OPS = {"sphere": (9, 18), "aabb": (7, 23), "obb": (28, 44)}


def _skips_arg(skips):
    arr = (ctypes.c_int * len(skips))(*skips)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


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
        keep, skips_ptr = _skips_arg(skips[g])
        err = lib.multi_any_hit(o.data_ptr(), stacked.data_ptr(),
                                lim.data_ptr(), init.data_ptr(), R,
                                g.stop - g.start, skips_ptr,
                                *table_args(fields, dev), occ.data_ptr(),
                                stream_of(dev))
        build.check("multi_any_hit", err)
        if R:
            run_multi_any_hit.launches += 1
        parts.append(occ)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


run_multi_any_hit.launches = 0


# ---------------------------------------------------------------------------
# B3: multi-set permeation chords
# ---------------------------------------------------------------------------


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
            ocx, ocy, ocz = ox - sph[:, 0], oy - sph[:, 1], oz - sph[:, 2]
            cc = (ocx * ocx + ocy * ocy + ocz * ocz) - sph[:, S_R2]
            for s, (dx, dy, dz) in enumerate(sets):
                b = ocx * dx + ocy * dy + ocz * dz
                disc = b * b - cc
                hit = disc >= 0.0
                sq = torch.sqrt(torch.where(hit, disc, 1.0))
                t_exit = -b + sq
                enter = torch.clamp(-b - sq, min=0.0)
                chord = torch.clamp(t_exit - enter, min=0.0)
                valid = hit & (t_exit >= 0.0) & (tgt != skips[s])
                acc[:, s] += (torch.where(valid, chord, 0.0) * dens).sum(-1)
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
                tn, tf = slab(*terms, *inv)
                chord = torch.clamp(tf - torch.clamp(tn, min=0.0), min=0.0)
                valid = (tn <= tf) & (tf >= 0.0) & (tgt != skips[s]) & ok
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
        keep, skips_ptr = _skips_arg(skips[g])
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
