"""Speed-of-light roofline of the port on one NVIDIA card.

The counterpart of the JAX package's ``tools/roofline.py``, in four parts,
and a fifth of its own:

1. ``ceiling()``: B9 (``ops/cuda/calibrate.py``) runs counted chains of
   the production op mix, "fma4" and "occl", at 88 and 176 float32
   operations per primitive. The marginal rate between the two cancels
   the per-primitive loop overhead and is the card's instruction-rate
   ceiling for that stream; the ceiling is the larger of the two mixes
   (the JAX tool's convention). It also reads the machine code back
   (``cuobjdump -sass``): each loop body must hold exactly the counted
   float32 instructions, with no FFMA fusion and no hoisting.
2. ``participation()``: the hit-count histogram of the compacted headline
   forward at max_ray_life 300 and 125, P(hit_count >= k), and the sum
   of those shares, the number of full sweeps of the closest-hit and
   occlusion kernels over all rays (a lower estimate).
3. ``standalone()``: B1-B8 alone at the JAX tool's shapes (1,048,576
   rays, origins uniform in (-50, 50), Fibonacci directions and their
   rolls, limits 80, cotangents |N(0, 1)| x 1e-3), CUDA-event medians,
   each rate against the ceiling with the port's own op counts
   (``ops/cuda/kernels.py::OPS``, ``ops/cuda/fused.py``) on the headline
   scene's 1,024 spheres, 2,048 AABBs and 1,024 OBBs.
4. ``floors()``: counted operations x participation / ceiling for the
   forward at both lives and for the materials training step, beside
   measured medians.
5. The attribution of B1, B2, B4 and B6 (``chip_smoke.py`` phases 2a, 3,
   6 and 9 call it; ``attribution()`` runs it at part 3's shapes):
   ``loop_histograms()`` (opcode classes of their innermost loops),
   ``occupancy()``, ``by_type()`` and ``type_ablation()`` (each type's
   table alone against its bound), ``resolution_shares()`` (how early B2's
   walk could stop per warp), ``sphere_branch_shares()`` (how often B1's
   square root runs), and ``any_hit_lockstep()`` and
   ``any_hit_rotation()`` (what a walk in lock-step, and what lane refill
   over a cyclic stream, would cost B6 over the walks its bound counts).

Run on the card: ``python -m audio_raytracer_tpu_torch.tools.roofline``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from audio_raytracer_tpu_torch.ops.backend import NO_SKIP, ray_chunks
from audio_raytracer_tpu_torch.ops.cuda import calibrate as C
from audio_raytracer_tpu_torch.ops.cuda import fused as F
from audio_raytracer_tpu_torch.ops.cuda import kernels as K
from audio_raytracer_tpu_torch.types import TraceConfig, resolve_device

R = 1 << 20
HEADLINE_SCENE = dict(num_spheres=1024, num_aabbs=2048, num_obbs=1024,
                      num_targets=4, extent=60.0, size_range=(0.5, 4.0))
LIVES = (300.0, 125.0)
# Calibration shape: lanes in blocks of the JAX tool's (8, 512) ray block,
# enough of them for WAVES full waves of resident threads on every SM (a
# partial last wave would scale both points of the marginal rate, not
# cancel), and the JAX tool's 4,096 primitives, so that a 176-op call
# takes four times the 6.4 ms it took with 1,024 primitives on an H100,
# where the marginal rate spread over 5 % between runs.
LANES_PER_BLOCK = 8 * 512
WAVES = 4
CAL_PRIMS = 4096


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def headline_scene(device="cuda"):
    from audio_raytracer_tpu_torch.models.raytracer import random_scene

    return random_scene(0, **HEADLINE_SCENE, device=device)


# ---------------------------------------------------------------------------
# Counted operations
# ---------------------------------------------------------------------------


def pair_ops(fields: K.Fields, rays: int, S: int, table) -> int:
    """Float operations of ``rays`` rays x S sets against every primitive,
    from per-type (shared, per set) counts."""
    return rays * sum(n * (a + b * S) for n, (a, b) in zip(
        fields.counts, (table["sphere"], table["aabb"], table["obb"])))


def closest_ops(fields: K.Fields, rays: int) -> int:
    """B1's float operations for ``rays`` live rays."""
    return pair_ops(fields, rays, 0, {k: (v, 0) for k, v in K.OPS.items()})


def occl_ops(fields: K.Fields, live: int, open_pairs: int) -> int:
    """B2's float operations: the shared terms for every live ray, the
    per-set tests for the (ray, set) pairs not resolved on entry."""
    return sum(n * (live * a + open_pairs * b) for n, (a, b) in zip(
        fields.counts, (F.OCC_OPS["sphere"], F.OCC_OPS["aabb"],
                        F.OCC_OPS["obb"])))


def any_hit_walks(fields: K.Fields, o, d, limit, skip):
    """([R] int64 primitives each ray walks in scan order up to and
    including its first occluder, P = all of them when nothing occludes
    it; [R] bool occluded)."""
    P = fields.total
    limit = K.ray_limits(limit, o.shape[0], o.device)
    n = torch.empty(o.shape[0], dtype=torch.int64, device=o.device)
    occ = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    for c in ray_chunks(o.shape[0], P):
        grid = K.any_hit_grid(fields, o[c], d[c], limit[c], skip)
        occ[c] = grid.any(dim=-1)
        n[c] = torch.where(occ[c], grid.to(torch.uint8).argmax(dim=-1) + 1, P)
    return n, occ


def walked_by_type(fields: K.Fields, n) -> list:
    """Per type (spheres, AABBs, OBBs): [R] primitives of that type among
    the first n[r] in scan order."""
    out, start = [], 0
    for cnt in fields.counts:
        out.append((n - start).clamp(0, cnt))
        start += cnt
    return out


def any_hit_work(fields: K.Fields, o, d, limit, skip) -> tuple:
    """(ray, primitive) pairs per type that B6 must test: each ray walks
    the primitives in scan order up to its first occluder, all of them
    when nothing occludes it."""
    n, _ = any_hit_walks(fields, o, d, limit, skip)
    return tuple(int(w.sum()) for w in walked_by_type(fields, n))


def any_hit_ops(fields: K.Fields, o, d, limit, skip) -> int:
    work = any_hit_work(fields, o, d, limit, skip)
    return sum(w * K.OPS[k] for w, k in zip(work, ("sphere", "aabb", "obb")))


def any_hit_lockstep(fields: K.Fields, o, d, limit, skip, lanes=(32, 256),
                     log=print) -> dict:
    """How much a walk in lock-step costs B6 over the walks its bound
    counts. A ray's walk is the counted operations (``OPS``) of the
    primitives up to its first occluder in scan order; a group of
    ``lanes`` consecutive rays that walks until its last ray resolves
    pays lanes x its longest walk. Returns {lanes: sum over groups of
    lanes x longest walk / sum of the walks} (over the whole groups), and
    "never_occluded" (share of rays), "median_walk_occluded" and
    "p90_walk_occluded" (primitives, over the occluded rays)."""
    n, occ = any_hit_walks(fields, o, d, limit, skip)
    walk = sum(w * K.OPS[k] for w, k in zip(walked_by_type(fields, n),
                                             ("sphere", "aabb", "obb")))
    out = {}
    for L in lanes:
        w = walk[:walk.shape[0] // L * L].reshape(-1, L)
        out[L] = float(L * w.amax(dim=1).sum()) / max(float(w.sum()), 1.0)
    hit = n[occ].double()
    out["never_occluded"] = float((~occ).double().mean())
    for key, q in (("median_walk_occluded", 0.5), ("p90_walk_occluded", 0.9)):
        out[key] = float(hit.quantile(q)) if hit.numel() else 0.0
    log(f"  B6 lock-step factor (lanes x longest walk / walks) {out}")
    return out


def any_hit_rotation(fields: K.Fields, o, d, limit, skip, sub=64,
                     log=print) -> float:
    """What lane refill costs B6 over the walks its bound counts. B6
    streams the rows round and round, and a ray that joins at row k walks
    from there, round the cycle, up to and including its first occluder
    (every row when none). Returns the counted operations (``OPS``) of
    those walks, averaged over joins at the multiples of ``sub`` rows (the
    refill points), over those of the scan-order walks."""
    P = fields.total
    dev = o.device
    cost = torch.cat([torch.full((n,), float(K.OPS[k]), dtype=torch.float64,
                                 device=dev)
                      for n, k in zip(fields.counts, ("sphere", "aabb",
                                                      "obb"))])
    # Counted operations of rows [0, i) over two turns of the cycle.
    cum = torch.cat([cost.new_zeros(1), cost.cumsum(0),
                     cost.sum() + cost.cumsum(0)])
    starts = torch.arange(0, P, sub, device=dev)
    row = torch.arange(2 * P, dtype=torch.int32, device=dev)
    limit = K.ray_limits(limit, o.shape[0], dev)
    rotated = scan = 0.0
    for c in ray_chunks(o.shape[0], P):
        grid = K.any_hit_grid(fields, o[c], d[c], limit[c], skip)
        occ = torch.cat([grid, grid], dim=1)
        # The first occluder at or after each row (2P: none).
        nxt = torch.where(occ, row, 2 * P).flip(1).cummin(1).values.flip(1)
        at = nxt[:, starts].long()
        end = torch.where(at < 2 * P, at + 1, starts + P)
        rotated += float((cum[end] - cum[starts]).mean(dim=1).sum())
        first = nxt[:, 0].long()
        scan += float(torch.where(first < 2 * P, cum[(first + 1).clamp(
            max=2 * P)], cum[P]).sum())
    out = rotated / max(scan, 1.0)
    log(f"  B6 refill walks (joins every {sub} rows) over scan-order "
        f"walks: {out:.4f}")
    return out


# ---------------------------------------------------------------------------
# 1. The ceiling
# ---------------------------------------------------------------------------


def calibration_blocks(dev) -> int:
    props = torch.cuda.get_device_properties(dev)
    threads = props.multi_processor_count * \
        props.max_threads_per_multi_processor
    return max(1, WAVES * threads // LANES_PER_BLOCK)


def calibrate(mix: str, ops_per_iter: int, blocks: int, prims: int,
              reps: int, dev):
    """(median ms, counted operations) of one B9 call."""
    x = torch.full((blocks * 8, 512), 0.5, device=dev)
    fields = [torch.linspace(0.9, 1.1, prims, device=dev) + 1e-3 * i
              for i in range(6)]
    ms = cuda_ms(lambda: C.run_calibrate(mix, ops_per_iter, x, fields), reps)
    return ms, C.counted_ops(mix, ops_per_iter, x.numel(), prims)


def ceiling(device="cuda", prims=CAL_PRIMS, reps=9, log=print) -> dict:
    """The measured float32 rate ceiling (operations per second) and
    what it rests on: per mix the (ms, ops) points and marginal rate, the
    calibration shape, and the SASS loop-body counts."""
    dev = resolve_device(device)
    blocks = calibration_blocks(dev)
    lanes = blocks * LANES_PER_BLOCK
    log(f"calibration shape: {lanes} lanes ({blocks} blocks of (8, 512)) x "
        f"{prims} primitives")
    rates, points = {}, {}
    for mix in C.MIXES:
        pts = {n: calibrate(mix, n, blocks, prims, reps, dev)
               for n in C.OPS_PER_ITER}
        for n, (ms, ops) in pts.items():
            log(f"  {mix} {n} ops/iter: {ms:.4f} ms "
                f"({ops / ms / 1e9:.3f} T ops/s raw)")
        (ms1, o1), (ms2, o2) = (pts[n] for n in C.OPS_PER_ITER)
        rates[mix] = (o2 - o1) / ((ms2 - ms1) * 1e-3)
        points[mix] = pts
        log(f"  {mix} marginal: {rates[mix] / 1e12:.3f} T ops/s")
    ceil = max(rates.values())
    log(f"measured ceiling: {ceil / 1e12:.3f} T float32 ops/s")
    sass = C.sass_loop_counts()
    for key in sorted(sass):
        fp32, hist = sass[key]
        log(f"  SASS loop body {key[0]} {key[1]}: {fp32} float32 "
            f"instructions; opcodes {hist}")
    return dict(ceiling=ceil, rates=rates, points=points, sass=sass,
                lanes=lanes, prims=prims)


# ---------------------------------------------------------------------------
# 2. Participation
# ---------------------------------------------------------------------------


def participation(scene, dirs, lives=LIVES, max_bounces=4, device="cuda",
                  log=print) -> dict:
    """{life: dict(ge=[P(hit_count >= k) for k = 1..H], sweeps=sum)} of
    the compacted forward from the origin along ``dirs``."""
    from audio_raytracer_tpu_torch.models.raytracer import forward

    dev = resolve_device(device)
    out = {}
    for life in lives:
        cfg = TraceConfig(ray_count=dirs.shape[0], max_bounces=max_bounces,
                          max_ray_life=life, max_muffle_hit_distance=250.0,
                          compact_rays=True)
        with torch.no_grad():
            res, _ = forward(torch.zeros(3, device=dev), dirs, scene, cfg,
                             collect_debug=True, backend="kernel",
                             device=dev)
        hist = torch.bincount(res.hit_counts.long(),
                              minlength=cfg.max_hits_per_ray + 1)
        hist = hist.double() / dirs.shape[0]
        ge = hist.flip(0).cumsum(0).flip(0)[1:].tolist()
        out[life] = dict(ge=ge, sweeps=sum(ge))
        log(f"life={life}: P(hit_count >= 1..{len(ge)}) = "
            f"{[round(x, 4) for x in ge]} -> closest/occlusion sweeps "
            f"(lower) = {out[life]['sweeps']:.4f}")
    return out


# ---------------------------------------------------------------------------
# 3. Standalone kernel rates
# ---------------------------------------------------------------------------


def standalone_inputs(dirs, dev):
    """Part 3's rays: origins uniform in (-50, 50) from seed 1, the
    directions ``dirs`` and four rolls of them (5 sets), and cotangents
    |N(0, 1)| x 1e-3 for 4 sets."""
    n = dirs.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    o = torch.rand((n, 3), generator=gen, device=dev) * 100.0 - 50.0
    dirs5 = [dirs] + [torch.roll(dirs, 17 * (i + 1), dims=0).contiguous()
                      for i in range(4)]
    gbar = torch.randn((n, 4), generator=gen, device=dev).abs() * 1e-3
    return o, dirs5, gbar


def standalone(scene, dirs, ceil, device="cuda", reps=5, log=print) -> dict:
    """{kernel: (median ms, counted ops)} of B1-B8 at the JAX tool's
    shapes, each rate printed against the ceiling."""
    from audio_raytracer_tpu_torch.ops.cuda.backend import prepare_fields

    fields = prepare_fields(scene)
    n = dirs.shape[0]
    o, dirs5, gbar = standalone_inputs(dirs, resolve_device(device))
    limits = torch.full((n, 5), 80.0, device=o.device)
    init = torch.zeros((n, 5), dtype=torch.bool, device=o.device)
    g1 = gbar[:, 0].contiguous()
    skips4 = (0, 1, 2, 3)
    cases = (
        ("B1 closest", lambda: K.run_closest_hit(fields, o, dirs),
         closest_ops(fields, n)),
        ("B2 occl S=5", lambda: F.run_multi_any_hit(
            fields, o, dirs5, limits, (NO_SKIP,) + skips4, init),
         pair_ops(fields, n, 5, F.OCC_OPS)),
        ("B3 chord S=4", lambda: F.run_multi_chord(fields, o, dirs5[1:],
                                                   skips4),
         pair_ops(fields, n, 4, F.CHORD_OPS)),
        ("B4 dens-bwd S=4", lambda: F.run_multi_chord_dens_bwd(
            fields, o, dirs5[1:], skips4, gbar),
         pair_ops(fields, n, 4, F.CHORD_OPS)),
        ("B5 full-bwd S=4", lambda: F.run_multi_chord_bwd(
            fields, o, dirs5[1:], skips4, gbar),
         pair_ops(fields, n, 4, F.CHORD_BWD_OPS) + 2 * 4 * n * fields.total),
        ("B6 any-hit", lambda: K.run_any_hit(fields, o, dirs, 80.0, NO_SKIP),
         any_hit_ops(fields, o, dirs, 80.0, NO_SKIP)),
        ("B7 chord", lambda: K.run_chord_loss(fields, o, dirs, 0),
         pair_ops(fields, n, 1, F.CHORD_OPS)),
        ("B8 chord-bwd", lambda: K.run_chord_loss_bwd(fields, o, dirs, 0, g1),
         pair_ops(fields, n, 1, F.CHORD_BWD_BALANCED_OPS)
         + 2 * n * fields.total),
    )
    out = {}
    for name, fn, ops in cases:
        ms = cuda_ms(fn, reps)
        rate = ops / (ms * 1e-3)
        out[name] = (ms, ops)
        log(f"{name}: {ms:.4f} ms, {ops / 1e12:.4f}e12 counted ops, "
            f"{rate / 1e12:.3f} T ops/s = {rate / ceil:.1%} of the ceiling")
    return out


# ---------------------------------------------------------------------------
# 4. Floors
# ---------------------------------------------------------------------------


def floors(ceil, sweeps, fields: K.Fields, rays=R, measured=None,
           log=print) -> dict:
    """{cell: floor ms}: counted ops x participation / ceiling for the
    forward at each life in ``sweeps`` ("fwd life=...") and for the
    materials training step at the first life ("materials step"), beside
    ``measured`` medians (ms, same keys) where given. The forward runs B3
    on one ray per accumulation batch, which the floor leaves out."""
    measured = measured or {}
    per_sweep = closest_ops(fields, rays) + pair_ops(fields, rays, 5,
                                                    F.OCC_OPS)
    chords = pair_ops(fields, rays, 4, F.CHORD_OPS)
    cells = {f"fwd life={life:g}": s["sweeps"] * per_sweep
             for life, s in sweeps.items()}
    # B3 forward on every ray, then B4 over the same chords.
    first = next(iter(sweeps.values()))["sweeps"]
    cells["materials step"] = first * per_sweep + 2 * chords
    out = {}
    for cell, ops in cells.items():
        out[cell] = ops / ceil * 1e3
        got = measured.get(cell)
        log(f"{cell}: counted {ops / 1e12:.4f}e12 ops -> floor "
            f"{out[cell]:.2f} ms at {ceil / 1e12:.3f} T ops/s"
            + (f"; measured median {got:.2f} ms ({out[cell] / got:.1%} "
               f"of it)" if got else ""))
    return out


# ---------------------------------------------------------------------------
# 5. Attribution of B1, B2, B4 and B6
# ---------------------------------------------------------------------------

TYPES = ("sphere", "aabb", "obb")


# The kernels part 5 reads: (library, SASS name pattern of the instance).
LOOP_KERNELS = {
    "B1": ("closest_hit", r"closest_hit_kernel"),
    "B2": ("multi_any_hit", r"multi_any_hit_kernelILi5E"),
    "B4": ("multi_chord_dens_bwd", r"multi_chord_dens_bwd_kernelILi4E"),
    "B6": ("any_hit", r"^_Z\d+any_hit_kernel"),
}


def loop_histograms(kernels=tuple(LOOP_KERNELS), log=print) -> dict:
    """{kernel: [opcode classes of each innermost loop]} of B1
    (``closest_hit_kernel``), B2 at S = 5, B4 at S = 4 and B6 in the built
    libraries: static counts, so a loop holds its rare paths (a
    slow-path reciprocal, the sphere hit) beside its common one, and each
    unrolled iteration."""
    out = {}
    for key in kernels:
        name, pattern = LOOP_KERNELS[key]
        loops = C.loop_bodies(C.library_sass(name), pattern)
        out[key] = [lp["classes"] for lps in loops.values() for lp in lps]
        for i, classes in enumerate(out[key]):
            log(f"  {key} {name} loop {i}: {classes}")
    return out


def occupancy(sets=(5,)) -> dict:
    """Resident blocks per SM of B1, B6, and of B2 and B4 at each S in
    ``sets``."""
    import ctypes

    from audio_raytracer_tpu_torch.ops.cuda import build

    n = ctypes.c_int(0)
    out = {}
    for key, lib, fn in (("B1", "closest_hit", "closest_hit_occupancy"),
                         ("B6", "any_hit", "any_hit_occupancy")):
        build.check("occupancy", getattr(build.load(lib), fn)(
            ctypes.byref(n)))
        out[key] = n.value
    for S in sets:
        for key, lib in (("B2", "multi_any_hit"),
                         ("B4", "multi_chord_dens_bwd")):
            build.check("occupancy", getattr(build.load(lib),
                                             f"{lib}_occupancy")(
                S, ctypes.byref(n)))
            out[f"{key} S={S}"] = n.value
    return out


def one_type(fields: K.Fields, kind: str) -> K.Fields:
    """``fields`` with every type but ``kind`` emptied."""
    tabs = [fields.sph, fields.aabb, fields.obb]
    return K.Fields(*(t if k == kind else t[:0]
                      for k, t in zip(TYPES, tabs)))


def by_type(fields: K.Fields, run, ops, ceil, reps=5, name="",
            log=print) -> dict:
    """A kernel on each type's table alone: {type: dict(ms, bound_ms)},
    ``run(f)`` launching it on the tables ``f`` and ``ops(f)`` counting
    its operations there, the bound against the ceiling ``ceil``."""
    out = {}
    for kind in TYPES:
        f = one_type(fields, kind)
        out[kind] = dict(ms=cuda_ms(lambda: run(f), reps),
                         bound_ms=ops(f) / ceil * 1e3)
        log(f"  {name} {kind} alone: {out[kind]['ms']:.4f} ms (bound "
            f"{out[kind]['bound_ms']:.4f})")
    return out


def type_ablation(fields: K.Fields, b1_args, b2_args, ceil, reps=5,
                  log=print) -> dict:
    """B1 (o, d, alive) and B2 (o, dirs, limits, skips, init) on each
    type's table alone: {"B1": {type: dict(ms, bound_ms)}, "B2": ...},
    the bounds against the ceiling ``ceil``."""
    o, d, alive = b1_args
    o2, dirs, limits, skips, init = b2_args
    live1 = int(alive.sum())
    live2, open2 = int((~init.all(dim=1)).sum()), int((~init).sum())
    return {
        "B1": by_type(fields, lambda f: K.run_closest_hit(f, o, d, alive),
                      lambda f: closest_ops(f, live1), ceil, reps, "B1",
                      log),
        "B2": by_type(fields, lambda f: F.run_multi_any_hit(
            f, o2, dirs, limits, skips, init),
            lambda f: occl_ops(f, live2, open2), ceil, reps, "B2", log)}


def _occluders(fields: K.Fields, o, d, lim) -> torch.Tensor:
    """[c, P] bool in scan order: primitive p occludes the unit ray (o, d)
    within lim [c, 1] by B2's tests (skip targets aside)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sph = fields.sph
    ocx, ocy, ocz = ox - sph[:, 0], oy - sph[:, 1], oz - sph[:, 2]
    cc = (ocx * ocx + ocy * ocy + ocz * ocz) - sph[:, K.S_R2]
    c_pos = cc >= 0.0
    h = ocx * dx + ocy * dy + ocz * dz
    hl = h + lim
    q = lim * (hl + h) + cc
    entering = c_pos & (h <= 0.0) & ((hl > 0.0) | (q < 0.0))
    inside = ~c_pos & (hl > 0.0) & (q > 0.0)
    grids = [(h * h >= cc) & (entering | inside)]
    for kind, tab, miss in (("aabb", fields.aabb, K.A_MISS),
                            ("obb", fields.obb, K.O_MISS)):
        terms = K.box_terms(fields, kind, ox, oy, oz)
        inv = K.box_inv_dirs(fields, kind, dx, dy, dz)
        grids.append(K.slab_hit(*K.slab(*terms, *inv)) + tab[:, miss] < lim)
    return torch.cat(grids, dim=-1)


def resolution_shares(fields: K.Fields, o, dirs, limits, init,
                      lanes=(32, 64), log=print) -> dict:
    """How early B2's walk could stop per group of ``lanes`` consecutive
    rays: {lanes: (share of groups whose every (ray, set) pair is resolved
    by mid-walk, by three quarters, by the end)}; "pairs" the share of open
    pairs that meet an occluder at all. A pair resolves at its first
    occluder in scan order, or on entry (init)."""
    R, S = limits.shape
    P = fields.total
    first = torch.full((R, S), P + 1, dtype=torch.int64, device=o.device)
    for c in ray_chunks(R, P):
        for s in range(S):
            g = _occluders(fields, o[c], dirs[s][c], limits[c, s:s + 1])
            idx = g.to(torch.uint8).argmax(dim=-1) + 1
            first[c, s] = torch.where(g.any(dim=-1), idx, P + 1)
    out = dict(pairs=float((first[~init] <= P).float().mean()))
    first = first.masked_fill(init, 0)
    for n in lanes:
        done = first[:R // n * n].reshape(-1, n * S).amax(dim=-1)
        out[n] = tuple(float((done <= frac * P).float().mean())
                       for frac in (0.5, 0.75, 1.0))
        log(f"  B2 groups of {n} rays resolved by mid-walk, 3/4, the end: "
            f"{out[n]}")
    log(f"  B2 open (ray, set) pairs that meet an occluder: {out['pairs']}")
    return out


def sphere_branch_shares(fields: K.Fields, o, d, lanes=(1, 32, 64),
                         log=print) -> dict:
    """{lanes: share of (group of ``lanes`` consecutive rays, sphere)
    pairs in which some ray meets the sphere (disc >= 0)}: how often B1's
    square-root branch runs."""
    R, sph = o.shape[0], fields.sph
    hit = []
    for c in ray_chunks(R, fields.total):
        ox, oy, oz = K.ray_cols(o, c)
        dx, dy, dz = K.ray_cols(d, c)
        ocx, ocy, ocz = ox - sph[:, 0], oy - sph[:, 1], oz - sph[:, 2]
        b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
        cc = (ocx * ocx + ocy * ocy + ocz * ocz) - sph[:, K.S_R2]
        hit.append(b * b - 4.0 * (dx * dx + dy * dy + dz * dz) * cc >= 0.0)
    hit = torch.cat(hit)
    out = {n: float(hit[:R // n * n].reshape(-1, n, hit.shape[1]).any(dim=1)
                    .float().mean()) for n in lanes}
    log(f"  B1 sphere branch taken per group of rays: {out}")
    return out


def attribution(scene, dirs, ceil, device="cuda", reps=5, log=print) -> dict:
    """Part 5 at part 3's shapes: the loop classes and resident blocks of
    B1, B2, B4 and B6, B4 (S = 4) and B6 on each type's table alone
    against their bounds, and B6's lock-step and refill factors."""
    from audio_raytracer_tpu_torch.ops.cuda.backend import prepare_fields

    fields = prepare_fields(scene)
    o, dirs5, gbar = standalone_inputs(dirs, resolve_device(device))
    out = dict(loops=loop_histograms(log=log), resident_blocks=occupancy(
        sets=(1, 4, 5)))
    log(f"resident blocks per SM: {out['resident_blocks']}")
    skips4 = (0, 1, 2, 3)
    out["B4"] = by_type(
        fields, lambda f: F.run_multi_chord_dens_bwd(f, o, dirs5[1:], skips4,
                                                     gbar),
        lambda f: pair_ops(f, o.shape[0], 4, F.CHORD_OPS), ceil, reps, "B4",
        log)
    out["B6"] = by_type(
        fields, lambda f: K.run_any_hit(f, o, dirs, 80.0, NO_SKIP),
        lambda f: any_hit_ops(f, o, dirs, 80.0, NO_SKIP), ceil, reps, "B6",
        log)
    out["B6 lockstep"] = any_hit_lockstep(fields, o, dirs, 80.0, NO_SKIP,
                                          log=log)
    out["B6 rotation"] = any_hit_rotation(fields, o, dirs, 80.0, NO_SKIP,
                                          log=log)
    return out


def measure_medians(scene, dirs, dev, steps=3) -> dict:
    """Host-clock medians (ms) of the compacted headline frame
    (``compact_rays`` and ``compact_unordered``, bench.py's production
    forward) at each life, and of the materials training step."""
    from audio_raytracer_tpu_torch.models import differentiable as D
    from audio_raytracer_tpu_torch.models.raytracer import make_forward

    def median(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    origin = torch.zeros(3, device=dev)
    out = {}
    base = TraceConfig(ray_count=dirs.shape[0], max_bounces=4,
                       max_muffle_hit_distance=250.0, compact_rays=True,
                       compact_unordered=True)
    for life in LIVES:
        step = make_forward(dataclasses.replace(base, max_ray_life=life),
                            device=dev)
        out[f"fwd life={life:g}"] = median(lambda: step(origin, dirs, scene))
    cfg = dataclasses.replace(base, max_ray_life=LIVES[0],
                              compact_rays=False, compact_unordered=False)
    target = D.Loudness(
        muffle=torch.full((scene.num_targets,), 0.3, device=dev),
        permeation=torch.full((scene.num_targets,), 0.2, device=dev),
        reverb_energy=torch.tensor(0.05, device=dev))
    params = D.SceneParams.from_scene(scene)
    train, init = D.make_train_step(cfg, device=dev)
    opt = init(params)
    out["materials step"] = median(
        lambda: train(params, opt, scene, origin, dirs, target))
    return out


def main():
    from audio_raytracer_tpu_torch.ops.cuda.backend import prepare_fields
    from audio_raytracer_tpu_torch.ops.fibonacci import fibonacci_directions

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    print("device:", torch.cuda.get_device_name(dev))
    ceil = ceiling(dev)["ceiling"]
    scene = headline_scene(dev)
    dirs = fibonacci_directions(R, device=dev)
    sweeps = participation(scene, dirs, device=dev)
    standalone(scene, dirs, ceil, device=dev)
    attribution(scene, dirs, ceil, device=dev)
    floors(ceil, sweeps, prepare_fields(scene),
           measured=measure_medians(scene, dirs, dev))
    print(f"roofline: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
