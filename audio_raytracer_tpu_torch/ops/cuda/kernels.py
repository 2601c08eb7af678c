"""B1 closest hit, the single-set kernels B6-B8, and the field layout the
kernels share.

Each wrapper replaces a TPU kernel of ``audio_raytracer_tpu/ops/pallas/
kernels.py``: ``run_closest_hit`` its ``closest_hit_kernel`` (B1),
``run_any_hit`` its ``any_hit_kernel`` (B6), ``run_chord_loss`` its
``chord_loss_kernel`` (B7) and ``run_chord_loss_bwd`` its
``chord_bwd_kernel`` (B8). On a CUDA tensor a wrapper launches its kernel
(``csrc/*.cu``); on a CPU tensor it runs the plain version beside it, the
same arithmetic as plain tensor ops. There is no fallback between the
two: a CUDA tensor gets the kernel or an error.

Primitive fields are one float32 table per type (``Fields``), one row per
primitive, in the column order of ``csrc/fields.cuh``. Target ids are
stored as the int32 bit pattern of their column.

The plain versions repeat the kernels' arithmetic operation for operation
(same order, exact reciprocals), so on one device the two agree bit for
bit except for the order of float sums. They work on ray chunks so their
[rays, prims] grids stay within a few GB.

B1, B2 and B3 also run in the bfloat16 tier (``compute_dtype=
torch.bfloat16``, the JAX wrappers' ``dtype=jnp.bfloat16``): the rays and
the tables' geometry are rounded to bfloat16, the geometry arithmetic runs
on bfloat16 tensors (each op rounds once, as the kernels' instructions
do), and the f32 islands of the JAX tier (``.float()`` below) hold the
quadratic, the reciprocals, the compares and the sums. In float32 every
rounding and widening below is the identity. B1's and B2's bfloat16
kernels take two rays a thread in packed ``bf16x2`` words and read tables
rounded once (``bf16x2_table``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from audio_raytracer_tpu_torch.ops.backend import ray_chunks
from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.ops.intersect import _sqrt_disc
from audio_raytracer_tpu_torch.utils import profiling

Tensor = torch.Tensor
INF = float("inf")
INT_MAX = 2**31 - 1

# Row widths and columns (csrc/fields.cuh).
SPH_W, AABB_W, OBB_W = 8, 12, 20
S_R2, S_TGT, S_DENS = 3, 4, 5  # sphere: cx cy cz r2 tgt dens
A_MISS, A_TGT, A_DENS = 6, 7, 8  # aabb: min xyz, max xyz, miss tgt dens
O_M, O_MISS, O_TGT, O_DENS = 6, 15, 16, 17  # obb: c xyz, h xyz, m 9, ...

# The compute types of B1-B3 (the JAX tier's f32 and bf16).
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(compute_dtype) -> torch.dtype:
    """``compute_dtype`` if it is one of COMPUTE_DTYPES, else a
    ValueError."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype}: expected "
                         "torch.float32 or torch.bfloat16")
    return compute_dtype


def count_launch(wrapper, bf16: bool) -> None:
    """One launch of ``wrapper``'s kernel: in ``launches_bf16`` for the
    bfloat16 instantiation, else in ``launches``."""
    if bf16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


# Float operations per (live ray, primitive) in the B1 loop body, for the
# op-count bound (the sphere counts only its always-executed part). B6
# runs the same per-primitive t with the limit compare in place of B1's
# running-minimum compare, over the primitives up to a ray's first
# occluder.
OPS = {"sphere": 19, "aabb": 27, "obb": 69}


@dataclasses.dataclass(frozen=True)
class Fields:
    """Per-type primitive tables: sph [ns, 8], aabb [na, 12], obb [no, 20].
    ``derived`` caches tables built from them for one kernel (``cached``)."""

    sph: Tensor
    aabb: Tensor
    obb: Tensor
    derived: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def counts(self) -> tuple[int, int, int]:
        return self.sph.shape[0], self.aabb.shape[0], self.obb.shape[0]

    @property
    def total(self) -> int:
        return sum(self.counts)

    def nbytes(self) -> int:
        return sum(t.numel() * 4 for t in (self.sph, self.aabb, self.obb))

    def cached(self, key, make):
        """``make()``, built once per key for these tables."""
        if key not in self.derived:
            self.derived[key] = make()
        return self.derived[key]

    def rounded(self, compute_dtype) -> "Fields":
        """The tables rounded to ``compute_dtype`` (self in float32): the
        geometry columns the plain versions read in the compute type. The
        miss, target and density columns are read from ``self``."""
        if compute_dtype == torch.float32:
            return self
        return self.cached(("rounded", compute_dtype), lambda: Fields(
            *(t.to(compute_dtype) for t in (self.sph, self.aabb, self.obb))))


# ---------------------------------------------------------------------------
# Tables padded to whole tiles (B1, B2)
# ---------------------------------------------------------------------------

# Rows per shared-memory tile of B1 and B2 (csrc/fields.cuh RING_TILE). They
# stage whole tiles with one bulk copy each, so their tables come padded to
# a multiple of TILE rows with rows that never hit.
TILE = 128


def miss_row(width: int, device) -> Tensor:
    """A [width] row of a type table that no ray hits: a sphere of r2 =
    -1e30, a box with miss = +inf (the encodings of an inactive
    primitive), owned by no target (-1), at the origin, zero density."""
    row = torch.zeros((width,), device=device)
    miss = {SPH_W: (S_R2, -1e30), AABB_W: (A_MISS, INF),
            OBB_W: (O_MISS, INF)}[width]
    tgt = {SPH_W: S_TGT, AABB_W: A_TGT, OBB_W: O_TGT}[width]
    # fill_ of a one-element slice: a scalar, no tensor from host data.
    row[miss[0]:miss[0] + 1].fill_(miss[1])
    row.view(torch.int32)[tgt:tgt + 1].fill_(-1)
    return row


# The host waits of the frame path, beside the B1-B9 launch counts (each
# ``host_wait``; counted on every device, on the card each one waits for
# every kernel queued before it).
host_syncs = 0


@contextlib.contextmanager
def host_wait():
    """A block that waits for the device once: counted in
    ``host_syncs``, inside an ``art.sync`` host span."""
    global host_syncs
    host_syncs += 1
    with profiling.span("sync"):
        yield


def select_rows(tab: Tensor, mask: Tensor) -> Tensor:
    """``tab[mask]``, a host wait: the row count comes from the
    device."""
    with host_wait():
        return tab[mask]


def pad_to_tiles(tab: Tensor) -> Tensor:
    """tab [n, W] followed by miss rows up to a multiple of TILE rows."""
    n, width = tab.shape
    pad = -n % TILE
    if not pad:
        return tab.contiguous()
    return torch.cat([tab, miss_row(width, tab.device).expand(pad, width)])


def closest_tables(fields: Fields, compute_dtype=torch.float32):
    """B1's tables: each type's table padded to whole tiles; in bfloat16
    rounded by ``bf16x2_table``. The ranks the kernel reports are the scan
    indices of ``fields``."""
    if compute_dtype == torch.bfloat16:
        return fields.cached(("closest", compute_dtype), lambda: tuple(
            bf16x2_table(t) for t in closest_tables(fields)))
    return fields.cached("closest", lambda: tuple(
        pad_to_tiles(t) for t in (fields.sph, fields.aabb, fields.obb)))


def active_rows(tab: Tensor) -> Tensor:
    """[n] bool: the rows of a type table that can hit (sphere r2 >= 0,
    box miss = 0; prepare_fields encodes an inactive primitive as r2 =
    -1e30 or miss = +inf)."""
    if tab.shape[1] == SPH_W:
        return tab[:, S_R2] >= 0.0
    return tab[:, A_MISS if tab.shape[1] == AABB_W else O_MISS] == 0.0


def occlusion_tables(fields: Fields, skips, compute_dtype=torch.float32):
    """The occlusion kernels' tables for a launch with these skip targets
    (B2's, and B6's with one): per type (spheres, AABBs, OBBs) a table
    whose active rows owned by none of ``skips`` come first, padded to
    whole tiles, then its active rows owned by one of them, padded
    likewise; inactive rows are left out. Returns ((table, free rows,
    owned rows), ...); in bfloat16 each table rounded by ``bf16x2_table``.
    Occlusion is an OR over the primitives, so neither the order nor the
    ranks matter."""
    key = tuple(sorted(set(skips)))
    if compute_dtype == torch.bfloat16:
        return fields.cached(("occlusion", key, compute_dtype), lambda: tuple(
            (bf16x2_table(tab), n_free, n_owned)
            for tab, n_free, n_owned in occlusion_tables(fields, key)))

    def make():
        out = []
        for tab, col in ((fields.sph, S_TGT), (fields.aabb, A_TGT),
                         (fields.obb, O_TGT)):
            act = active_rows(tab)
            # NO_SKIP matches no row: unowned rows carry -1. Compared
            # with each id as a scalar: no tensor made from host data.
            tid = ids(tab, col)
            owned = torch.zeros_like(act)
            for k in key:
                owned |= tid == k
            free = select_rows(tab, act & ~owned)
            mine = select_rows(tab, act & owned)
            out.append((torch.cat([pad_to_tiles(free), pad_to_tiles(mine)]),
                        free.shape[0], mine.shape[0]))
        return tuple(out)

    return fields.cached(("occlusion", key), make)


# The geometry columns of each table width: the ones the bfloat16 tier
# computes with (sphere centre; AABB bounds; OBB centre, half extents and
# matrix), before the sphere's r2 and the miss, target and density columns.
GEOMETRY_COLUMNS = {SPH_W: S_R2, AABB_W: A_MISS, OBB_W: O_MISS}


def bf16x2_words(x: Tensor) -> Tensor:
    """int32 words holding x's bfloat16 rounding in both 16-bit halves:
    the packed operands (``bf16x2``) of B1-bf16 and B2-bf16."""
    h = x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    w = h * 0x10001
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def bf16x2_table(tab: Tensor) -> Tensor:
    """A padded type table for B1-bf16 and B2-bf16 (``csrc/fields.cuh``
    BF16X2): its geometry columns rounded to bfloat16 once, each a
    ``bf16x2_words`` word; a sphere's r2 the float32 of its bfloat16
    rounding (the kernels widen it as they read it); the miss, target,
    density and padding columns keep their float32 bits. The kernels
    read the words as they are, where the float32 tables were rounded at
    every load: ``cvt.rn`` rounds alike every time, so the bits are the
    same."""
    out = tab.clone()
    n = GEOMETRY_COLUMNS[tab.shape[1]]
    out.view(torch.int32)[:, :n] = bf16x2_words(tab[:, :n])
    if tab.shape[1] == SPH_W:
        out[:, S_R2] = tab[:, S_R2].to(torch.bfloat16).float()
    return out


# ---------------------------------------------------------------------------
# Plain building blocks (rays [c, 1] against table columns [n] -> [c, n])
# ---------------------------------------------------------------------------


def ids(tab: Tensor, col: int) -> Tensor:
    """Target-id column of a table, as int32."""
    return tab[:, col].contiguous().view(torch.int32)


def safe_inv(x: Tensor) -> Tensor:
    """1 / x with |x| < 1e-12 nudged to +/-1e-12 (ops.intersect._aabb_slab)."""
    nudge = torch.copysign(torch.full_like(x, 1e-12), x)
    return 1.0 / torch.where(x.abs() < 1e-12, nudge, x)


def inv_dir(x: Tensor) -> Tensor:
    """``safe_inv`` in float32, rounded back to x's compute type (the f32
    island of the JAX tier's ``_inv_dir``)."""
    return safe_inv(x.float()).to(x.dtype)


def slab(mnx, mny, mnz, mxx, mxy, mxz, ix, iy, iz):
    """(t_near, t_far) from precomputed (bound - origin) terms: products
    and min / max chains in the inputs' compute type, the results
    widened to float32."""
    t0x, t1x = mnx * ix, mxx * ix
    t0y, t1y = mny * iy, mxy * iy
    t0z, t1z = mnz * iz, mxz * iz
    mn, mx = torch.minimum, torch.maximum
    t_near = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
    t_far = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    return t_near.float(), t_far.float()


def slab_hit(t_near, t_far):
    """t_near if > 0 else t_far; +inf on a miss."""
    miss = (t_near > t_far) | (t_far < 0.0)
    return torch.where(t_near > 0.0, t_near, t_far).masked_fill(miss, INF)


def mat_rotate(tab: Tensor, vx, vy, vz):
    """Rotate by the 9 matrix columns O_M.. of an OBB table."""
    m = [tab[:, O_M + k] for k in range(9)]
    return (m[0] * vx + m[1] * vy + m[2] * vz,
            m[3] * vx + m[4] * vy + m[5] * vz,
            m[6] * vx + m[7] * vy + m[8] * vz)


def box_terms(fields: Fields, kind: str, ox, oy, oz):
    """Per-(ray, box) (bound - origin) terms shared by all ray sets: six
    [c, n] grids, min xyz then max xyz (in the OBB's local frame)."""
    if kind == "aabb":
        a = fields.aabb
        return tuple(a[:, k] - v for k, v in
                     enumerate((ox, oy, oz, ox, oy, oz)))
    b = fields.obb
    lo = mat_rotate(b, ox - b[:, 0], oy - b[:, 1], oz - b[:, 2])
    h = (b[:, 3], b[:, 4], b[:, 5])
    return (-h[0] - lo[0], -h[1] - lo[1], -h[2] - lo[2],
            h[0] - lo[0], h[1] - lo[1], h[2] - lo[2])


def box_inv_dirs(fields: Fields, kind: str, dx, dy, dz):
    """Inverse slab directions of one ray set against each box."""
    if kind == "aabb":
        return inv_dir(dx), inv_dir(dy), inv_dir(dz)
    return tuple(inv_dir(v) for v in mat_rotate(fields.obb, dx, dy, dz))


def ray_cols(x: Tensor, c: slice):
    """[R, 3] -> three [c, 1] columns of the chunk."""
    return x[c, 0:1], x[c, 1:2], x[c, 2:3]


# ---------------------------------------------------------------------------
# B1: closest hit
# ---------------------------------------------------------------------------


def _sphere_t(sph, ox, oy, oz, dx, dy, dz, a2, a4):
    ocx, ocy, ocz = ox - sph[:, 0], oy - sph[:, 1], oz - sph[:, 2]
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz).float()
    cc = (ocx * ocx + ocy * ocy + ocz * ocz).float() - sph[:, S_R2].float()
    disc = b * b - a4 * cc
    hit = disc >= 0.0
    sq = torch.sqrt(torch.where(hit, disc, 1.0))
    t0 = (-b - sq) / a2
    t1 = (-b + sq) / a2
    t = torch.where(t0 >= 0.0, t0, torch.where(t1 >= 0.0, t1, INF))
    return t.masked_fill(~hit, INF)


def closest_grid(fields: Fields, o: Tensor, d: Tensor,
                 compute_dtype=torch.float32) -> Tensor:
    """[R, P] B1's t of every (ray, primitive) in scan order (+inf on a
    miss), in ``compute_dtype``'s tier; one [R, P] grid, so a caller
    takes few rays at a time."""
    geo = fields.rounded(compute_dtype)
    o, d = o.to(compute_dtype), d.to(compute_dtype)
    ox, oy, oz = ray_cols(o, slice(None))
    dx, dy, dz = ray_cols(d, slice(None))
    a = (dx * dx + dy * dy + dz * dz).float()
    grids = []
    if fields.counts[0]:
        grids.append(_sphere_t(geo.sph, ox, oy, oz, dx, dy, dz, 2.0 * a,
                               4.0 * a))
    for kind, tab, miss in (("aabb", fields.aabb, A_MISS),
                            ("obb", fields.obb, O_MISS)):
        if tab.shape[0]:
            terms = box_terms(geo, kind, ox, oy, oz)
            inv = box_inv_dirs(geo, kind, dx, dy, dz)
            grids.append(slab_hit(*slab(*terms, *inv)) + tab[:, miss])
    return torch.cat(grids, dim=-1)


def closest_hit_plain(fields: Fields, o: Tensor, d: Tensor,
                      alive: Tensor | None = None,
                      compute_dtype=torch.float32):
    """Plain version of B1: (t [R] (+inf miss), rank [R] int32 (INT_MAX
    on a miss or a dead lane)), in ``compute_dtype``'s tier."""
    R = o.shape[0]
    t_out = torch.full((R,), INF, device=o.device)
    rank_out = torch.full((R,), INT_MAX, dtype=torch.int32, device=o.device)
    if fields.total == 0:
        return t_out, rank_out
    for c in ray_chunks(R, fields.total):
        t, idx = torch.min(closest_grid(fields, o[c], d[c], compute_dtype),
                           dim=-1)
        t_out[c] = t
        rank_out[c] = torch.where(t == INF, INT_MAX, idx.to(torch.int32))
    if alive is not None:
        t_out = t_out.masked_fill(~alive, INF)
        rank_out = rank_out.masked_fill(~alive, INT_MAX)
    return t_out, rank_out


# ---------------------------------------------------------------------------
# B1's bounding-volume hierarchy
# ---------------------------------------------------------------------------

# B1's float32 path walks a tree of the primitives (csrc/closest_hit.cu,
# the tree kernel) where the three tables hold at least this many rows
# together, and streams every row (the tiled kernel) below it: the
# crossover measured on the card with the tree rebuilt every frame, as a
# refill of a changed scene rebuilds it (PERF.md). The tree kernel alone
# is the faster from 111 rows; what it costs below this count is its
# build, about 0.2 ms of host and device time at every refill.
BVH_MIN_ROWS = 1536

# The widening of every node box a ray tests, as a share of the ray's
# distance scale ``max |o| + S`` (``S`` the tree's largest coordinate):
# where the rounding of a primitive's own test, of its box and of the node
# test can place its hit outside the box (bounded in csrc/closest_hit.cu's
# note). BVH_MARGIN covers spheres, AABBs and the node test; an OBB needs
# BVH_MARGIN_OBB times kappa, its matrix's conditioning, which the tree
# takes where that is larger.
BVH_MARGIN = 2.0 ** -7
BVH_MARGIN_OBB = 2.0 ** -12

# Floats per tree record: the boxes (lo xyz, hi xyz) of a node's two
# children; record 0, the header, holds the root's box, S, the margin w
# and zeros.
BVH_REC = 12


def takes_bvh(fields: Fields, compute_dtype=torch.float32) -> bool:
    """Does B1 walk the tree for these tables in this tier? A rule on the
    row counts alone, so it waits for nothing."""
    return compute_dtype == torch.float32 and fields.total >= BVH_MIN_ROWS


def bvh_leaves(n: int) -> int:
    """Leaves of the tree over n primitives, one a leaf: the least power
    of two that holds them (1 for n = 0)."""
    return 1 << max(0, n - 1).bit_length()


def _sum3(a: Tensor, b: Tensor) -> Tensor:
    """sum_k a[..., k] * b[..., k], left to right (the kernel's order)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _empty_boxes(n: int, device) -> Tensor:
    """[n, 6] empty boxes (lo = +inf, hi = -inf): never entered."""
    return torch.cat([torch.full((n, 3), INF, device=device),
                      torch.full((n, 3), -INF, device=device)], 1)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """a x b over the last axis, each term as the kernel rounds it."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def morton_codes(x: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """[n] int64 30-bit Morton codes of the points x [n, 3] over the box
    (lo, hi), 10 bits an axis (csrc/closest_hit.cu::spread10); a point
    outside the box is clamped to it, a NaN coordinate reads 0."""
    q = ((x - lo) / (hi - lo) * 1024.0).nan_to_num(0.0, 0.0, 0.0)
    q = q.clamp(0.0, 1023.0).long()
    for mul, mask in ((0x00010001, 0xFF0000FF), (0x00000101, 0x0F00F00F),
                      (0x00000011, 0xC30C30C3), (0x00000005, 0x49249249)):
        q = (q * mul) & mask
    return (q[:, 0] << 2) | (q[:, 1] << 1) | q[:, 2]


def bvh_boxes(fields: Fields):
    """Plain version of the build's first kernel (csrc/closest_hit.cu::
    bvh_boxes_kernel): (box [P, 6] (lo xyz, hi xyz) in scan order, codes
    [P] int64, w []). An active primitive's box holds the primitive:
    sphere centre ± sqrt(r2) rounded up; AABB its bounds, each axis
    ordered as the slab orders it; OBB centre ± |M^-1| |h|, M the
    world->local rows the table holds, M^-1 their adjugate over the
    determinant. An inactive one's is empty (lo = +inf, hi = -inf); a NaN
    bound becomes infinite. codes: the 30-bit Morton code of the box
    centre over the bounds of the active finite centres, 2^30 for the
    rest. w: ``BVH_MARGIN``, or ``BVH_MARGIN_OBB`` times kappa where that
    is larger, kappa the active OBBs' largest ||M|| ||M^-1|| in max row
    sums (3 for a rotation, infinite for a singular M)."""
    sph, ab, ob = fields.sph, fields.aabb, fields.obb
    r = torch.sqrt(sph[:, S_R2].clamp(min=0.0))[:, None]
    r = torch.nextafter(r, torch.full_like(r, INF))
    m = ob[:, O_M:O_M + 9].reshape(-1, 3, 3)
    adj = torch.stack([_cross(m[:, 1], m[:, 2]), _cross(m[:, 2], m[:, 0]),
                       _cross(m[:, 0], m[:, 1])], -1)
    det = _sum3(m[:, 0], adj[:, :, 0]).abs()
    h = ob[:, 3:6].abs()
    ext = _sum3(adj.abs(), h[:, None, :]) / det[:, None]
    lo = torch.cat([sph[:, 0:3] - r, torch.minimum(ab[:, 0:3], ab[:, 3:6]),
                    ob[:, 0:3] - ext]).nan_to_num(-INF, INF, -INF)
    hi = torch.cat([sph[:, 0:3] + r, torch.maximum(ab[:, 0:3], ab[:, 3:6]),
                    ob[:, 0:3] + ext]).nan_to_num(INF, INF, -INF)
    act = torch.cat([active_rows(t) for t in (sph, ab, ob)])[:, None]
    box = torch.where(act, torch.cat([lo, hi], 1),
                      _empty_boxes(1, sph.device))
    # Morton codes of the centres over the active finite centres' bounds.
    c = (box[:, :3] + box[:, 3:]) * 0.5
    ok = act & torch.isfinite(c).all(-1, keepdim=True)
    cmin = torch.where(ok, c, INF).amin(0)
    cmax = torch.where(ok, c, -INF).amax(0)
    codes = torch.where(ok[:, 0], morton_codes(c, cmin, cmax), 1 << 30)
    # w: the margin, or the OBBs' where that is larger.
    w = torch.full((), BVH_MARGIN, device=sph.device)
    if fields.counts[2]:
        one = torch.ones((3,), device=sph.device)
        kappa = (_sum3(m.abs(), one).amax(-1)
                 * _sum3(adj.abs(), one).amax(-1) / det).nan_to_num(INF, INF)
        kappa = torch.where(act[-len(m):, 0], kappa, 0.0).amax()
        w = torch.maximum(w, kappa * BVH_MARGIN_OBB)
    return box, codes, w


def bvh_tree(box: Tensor, order: Tensor, w: Tensor):
    """Plain version of the build's second kernel (csrc/closest_hit.cu::
    bvh_tree_kernel): (records [L, BVH_REC], slots [L] int32) of the
    complete binary tree over L = ``bvh_leaves(P)`` leaves in heap order
    (node k's children 2k + 1 and 2k + 2; nodes L - 1 on are the leaves),
    leaf i holding primitive ``order[i]`` (its scan rank in ``slots``;
    past P an empty box and INT_MAX), each node's box the union of its
    children's. Record k + 1 holds internal node k's two child boxes;
    record 0 the root's box, S (its largest |coordinate|, 0 when it is
    empty), ``w`` and zeros. Shapes depend on P alone."""
    P, dev = box.shape[0], box.device
    L = bvh_leaves(P)
    level = torch.cat([box.index_select(0, order), _empty_boxes(L - P, dev)])
    levels = [level]
    while level.shape[0] > 1:
        pair = level.view(-1, 2, 6)
        level = torch.cat([torch.minimum(pair[:, 0, :3], pair[:, 1, :3]),
                           torch.maximum(pair[:, 0, 3:], pair[:, 1, 3:])], 1)
        levels.append(level)
    root = level[0]
    scale = torch.where((root[:3] <= root[3:]).all(), root.abs().amax(), 0.0)
    header = torch.cat([root, scale[None], w[None], root.new_zeros(4)])
    rec = torch.cat([header[None]]
                    + [lv.view(-1, BVH_REC) for lv in levels[-2::-1]])
    slots = torch.cat([order.to(torch.int32),
                       torch.full((L - P,), INT_MAX, dtype=torch.int32,
                                  device=dev)])
    return rec, slots


def closest_bvh(fields: Fields):
    """B1's tree over every primitive, (records, slots, L): its boxes and
    Morton codes (``bvh_boxes``), the codes' stable order, the tree
    (``bvh_tree``); on the card two kernels around ``torch.sort``, with no
    host wait. Cached on ``fields``."""

    def make():
        if on_cpu(fields.sph):
            box, codes, w = bvh_boxes(fields)
            order = torch.sort(codes, stable=True).indices
            return (*bvh_tree(box, order, w), bvh_leaves(fields.total))
        return _bvh_build(fields)

    return fields.cached("bvh", make)


# ---------------------------------------------------------------------------
# Launch helpers
# ---------------------------------------------------------------------------


def on_cpu(x: Tensor) -> bool:
    """The plain version runs only for tensors on the CPU; any other
    device takes the kernel."""
    return x.device.type == "cpu"


def check_operands(device, *tensors, dtypes=(torch.float32,)):
    """Raise unless every tensor is a contiguous tensor of ``dtypes`` on
    ``device``."""
    for x in tensors:
        if x.device != device:
            raise ValueError(f"operand on {x.device}, expected {device}")
        if x.dtype not in dtypes:
            raise ValueError(f"operand dtype {x.dtype}, expected {dtypes}")
        if not x.is_contiguous():
            raise ValueError("operands must be contiguous")


def table_ptr(tab: Tensor, device) -> int:
    """The pointer of a type table, checked for the kernels' 16-byte row
    loads and bulk copies."""
    check_operands(device, tab)
    if tab.data_ptr() % 16:
        raise ValueError("primitive tables must be 16-byte aligned")
    return tab.data_ptr()


def table_args(fields: Fields, device) -> list:
    """(pointer, count) pairs of the three tables."""
    args = []
    for tab in (fields.sph, fields.aabb, fields.obb):
        args += [table_ptr(tab, device), tab.shape[0]]
    return args


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device) -> int:
    """The streaming multiprocessors of the card ``device`` lies on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def skips_arg(skips):
    """(array, pointer) of an int array of skip target ids; keep the array
    alive while the kernel's C entry point reads it."""
    arr = (ctypes.c_int * len(skips))(*skips)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _closest_operands(o: Tensor, d: Tensor, alive: Tensor | None):
    """B1's library, rays and alive mask checked, and its empty outputs
    (t [R], rank [R] int32)."""
    lib = build.load("closest_hit")
    dev = o.device
    check_operands(dev, o, d)
    if alive is not None:
        check_operands(dev, alive, dtypes=(torch.bool,))
    R = o.shape[0]
    return lib, torch.empty((R,), device=dev), \
        torch.empty((R,), dtype=torch.int32, device=dev)


def _bvh_build(fields: Fields):
    """``closest_bvh`` on the card: csrc/closest_hit.cu's bvh_boxes and
    bvh_tree kernels around ``torch.sort``, counted in
    ``closest_bvh.launches`` (two a build)."""
    lib, dev = build.load("closest_hit"), fields.sph.device
    P, L = fields.total, bvh_leaves(fields.total)
    box = torch.empty((P, 6), device=dev)
    codes = torch.empty((P,), dtype=torch.int64, device=dev)
    w = torch.empty((1,), device=dev)
    build.check("bvh_boxes", lib.bvh_boxes(
        *table_args(fields, dev), box.data_ptr(), codes.data_ptr(),
        w.data_ptr(), BVH_MARGIN, BVH_MARGIN_OBB, stream_of(dev)))
    order = torch.sort(codes, stable=True).indices
    rec = torch.empty((L, BVH_REC), device=dev)
    slots = torch.empty((L,), dtype=torch.int32, device=dev)
    build.check("bvh_tree", lib.bvh_tree(
        box.data_ptr(), order.data_ptr(), P, L, w.data_ptr(), rec.data_ptr(),
        slots.data_ptr(), stream_of(dev)))
    closest_bvh.launches += 2
    return rec, slots, L


closest_bvh.launches = 0


def _launch_bvh(lib, fields, o, d, alive, t, rank, visits) -> None:
    rec, slots, leaves = closest_bvh(fields)
    dev = o.device
    err = lib.closest_hit_bvh(o.data_ptr(), d.data_ptr(),
                              None if alive is None else alive.data_ptr(),
                              o.shape[0], table_ptr(rec, dev),
                              slots.data_ptr(), leaves,
                              *table_args(fields, dev), t.data_ptr(),
                              rank.data_ptr(),
                              None if visits is None else visits.data_ptr(),
                              stream_of(dev))
    build.check("closest_hit_bvh", err)


def run_closest_hit(fields: Fields, o: Tensor, d: Tensor,
                    alive: Tensor | None = None,
                    compute_dtype=torch.float32):
    """B1: o, d [R, 3] float32 -> (t [R] float32, +inf on a miss;
    rank [R] int32 in [sphere, aabb, obb] order, INT_MAX on a miss).
    ``alive`` [R] bool: dead lanes skip the scan and report a miss.
    ``compute_dtype``: torch.float32, or torch.bfloat16 for the bfloat16
    tier (its launches counted in ``launches_bf16``). In float32 at
    ``BVH_MIN_ROWS`` rows or more the kernel walks the tree of
    ``closest_bvh`` (``_run_tree``), else it streams every row
    (``_run_tiled``): the same bits."""
    check_compute_dtype(compute_dtype)
    if on_cpu(o):
        return closest_hit_plain(fields, o, d, alive, compute_dtype)
    if takes_bvh(fields, compute_dtype):
        return _run_tree(fields, o, d, alive)
    return _run_tiled(fields, o, d, alive, compute_dtype)


run_closest_hit.launches = 0
run_closest_hit.launches_bf16 = 0
run_closest_hit.launches_bvh = 0


def _run_tree(fields: Fields, o: Tensor, d: Tensor,
              alive: Tensor | None = None):
    """B1's tree kernel on the card, whatever the row count; counted in
    ``run_closest_hit.launches`` and ``.launches_bvh``."""
    lib, t, rank = _closest_operands(o, d, alive)
    _launch_bvh(lib, fields, o, d, alive, t, rank, None)
    if o.shape[0]:
        run_closest_hit.launches += 1
        run_closest_hit.launches_bvh += 1
    return t, rank


def _run_tiled(fields: Fields, o: Tensor, d: Tensor,
               alive: Tensor | None = None, compute_dtype=torch.float32):
    """B1's tiled kernel on the card, whatever the row count: every row
    streamed through the block (the tree kernel's yardstick, and the
    bfloat16 tier's pair kernel); counted in ``run_closest_hit.launches``
    or ``.launches_bf16``."""
    bf16 = check_compute_dtype(compute_dtype) == torch.bfloat16
    lib, t, rank = _closest_operands(o, d, alive)
    R, dev = o.shape[0], o.device
    args = []  # the padded tables with the real counts, for the ranks
    for tab, n in zip(closest_tables(fields, compute_dtype), fields.counts):
        args += [table_ptr(tab, dev), n]
    fn = lib.closest_hit_bf16 if bf16 else lib.closest_hit
    # The pair kernel's block shrinks at few rays (pair_threads).
    sms = [sm_count(dev)] if bf16 else []
    err = fn(o.data_ptr(), d.data_ptr(),
             None if alive is None else alive.data_ptr(), R, *args,
             t.data_ptr(), rank.data_ptr(), *sms, stream_of(dev))
    build.check("closest_hit", err)
    if R:
        count_launch(run_closest_hit, bf16)
    return t, rank


def closest_hit_bvh_visits(fields: Fields, o: Tensor, d: Tensor,
                           alive: Tensor | None = None):
    """The tree kernel's diagnostic, on the card only, whatever the row
    count, and never on the frame path: (t, rank) as ``run_closest_hit``
    and visits [R, 2] int32, the nodes each ray entered (leaves included)
    and the primitives it tested. Counted in no launch count."""
    if on_cpu(o):
        raise ValueError("the tree kernel's diagnostic runs on the card")
    lib, t, rank = _closest_operands(o, d, alive)
    visits = torch.empty((o.shape[0], 2), dtype=torch.int32, device=o.device)
    _launch_bvh(lib, fields, o, d, alive, t, rank, visits)
    return t, rank, visits


# ---------------------------------------------------------------------------
# B6: single-set occlusion
# ---------------------------------------------------------------------------


def ray_limits(limit, R: int, device) -> Tensor:
    """``limit`` ([R] or anything that broadcasts to it) as a contiguous
    [R] float32 tensor."""
    lim = torch.as_tensor(limit, dtype=torch.float32, device=device)
    return lim.expand(R).contiguous()


def any_hit_grid(fields: Fields, o: Tensor, d: Tensor, limit: Tensor,
                 skip: int) -> Tensor:
    """[R, P] bool in scan order: primitive p is not owned by ``skip`` and
    hits ray r at t < limit[r] (B1's per-primitive t, +inf on a miss)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    grids = []
    if fields.counts[0]:
        a = dx * dx + dy * dy + dz * dz
        grids.append(_sphere_t(fields.sph, ox, oy, oz, dx, dy, dz, 2.0 * a,
                               4.0 * a)
                     .masked_fill(ids(fields.sph, S_TGT) == skip, INF))
    for kind, tab, miss, tcol in (("aabb", fields.aabb, A_MISS, A_TGT),
                                  ("obb", fields.obb, O_MISS, O_TGT)):
        if tab.shape[0]:
            terms = box_terms(fields, kind, ox, oy, oz)
            inv = box_inv_dirs(fields, kind, dx, dy, dz)
            t = slab_hit(*slab(*terms, *inv)) + tab[:, miss]
            grids.append(t.masked_fill(ids(tab, tcol) == skip, INF))
    return torch.cat(grids, dim=-1) < limit[:, None]


def any_hit_plain(fields: Fields, o: Tensor, d: Tensor, limit: Tensor,
                  skip: int) -> Tensor:
    """Plain version of B6: [R] bool, ``any_hit_grid`` reduced over the
    primitives."""
    out = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for c in ray_chunks(o.shape[0], fields.total):
        out[c] = any_hit_grid(fields, o[c], d[c], limit[c], skip).any(-1)
    return out


def any_hit_args(fields: Fields, skip: int, device) -> list:
    """B6's table arguments for one skip target: per type (pointer, free
    rows) of ``occlusion_tables(fields, (skip,))``. The kernel walks only
    the free rows (active, not owned by ``skip``, padded to whole
    tiles)."""
    args = []
    for tab, n_free, _ in occlusion_tables(fields, (skip,)):
        args += [table_ptr(tab, device), n_free]
    return args


def run_any_hit(fields: Fields, o: Tensor, d: Tensor, limit, skip: int):
    """B6: o, d [R, 3] float32 (d of any length), ``limit`` [R] or
    broadcast, ``skip`` a target id (NO_SKIP for none) -> [R] bool: does
    a primitive not owned by ``skip`` hit at t < limit?"""
    limit = ray_limits(limit, o.shape[0], o.device)
    if on_cpu(o):
        return any_hit_plain(fields, o, d, limit, skip)
    lib = build.load("any_hit")
    dev = o.device
    check_operands(dev, o, d, limit)
    R = o.shape[0]
    occ = torch.empty((R,), dtype=torch.bool, device=dev)
    # The kernel's ray counter: warps take rays from it in chunks.
    next_ray = torch.zeros((1,), dtype=torch.int32, device=dev)
    err = lib.any_hit(o.data_ptr(), d.data_ptr(), limit.data_ptr(), R,
                      *any_hit_args(fields, skip, dev), next_ray.data_ptr(),
                      occ.data_ptr(), stream_of(dev))
    build.check("any_hit", err)
    if R:
        run_any_hit.launches += 1
    return occ


run_any_hit.launches = 0


# ---------------------------------------------------------------------------
# B7 and B8: single-set permeation chords and their adjoint
# ---------------------------------------------------------------------------


def _chord_sum(fields: Fields, o: Tensor, d: Tensor, skip: int, dens):
    """[c] sums of chord x density along the unbounded rays o, d [c, 3]
    (d unit length), skipping primitives owned by ``skip``; ``dens`` are
    the (sphere, aabb, obb) densities. The JAX kernel's arithmetic as it
    is written (ops/pallas/kernels.py:507-546), max(0, .) as a maximum,
    so that autograd takes jax.vjp's derivative, ties included. Where a
    ray is exactly tangent to a sphere (disc = 0) the derivative is 0
    (``intersect._sqrt_disc``), not JAX's NaN."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    zero = o.new_zeros(())
    mx = torch.maximum
    total = o.new_zeros(o.shape[0])
    if fields.counts[0]:
        sph = fields.sph
        ocx, ocy, ocz = ox - sph[:, 0], oy - sph[:, 1], oz - sph[:, 2]
        b = ocx * dx + ocy * dy + ocz * dz
        cc = (ocx * ocx + ocy * ocy + ocz * ocz) - sph[:, S_R2]
        disc = b * b - cc
        hit = disc >= 0.0
        sq = _sqrt_disc(disc)
        t_exit = -b + sq
        chord = mx(zero, t_exit - mx(-b - sq, zero))
        valid = hit & (t_exit >= 0.0) & (ids(sph, S_TGT) != skip)
        total = total + (torch.where(valid, chord, 0.0) * dens[0]).sum(-1)
    for i, kind, tab, miss, tcol in ((1, "aabb", fields.aabb, A_MISS, A_TGT),
                                     (2, "obb", fields.obb, O_MISS, O_TGT)):
        if not tab.shape[0]:
            continue
        terms = box_terms(fields, kind, ox, oy, oz)
        t_near, t_far = slab(*terms, *box_inv_dirs(fields, kind, dx, dy, dz))
        chord = mx(zero, t_far - mx(t_near, zero))
        valid = ((t_near <= t_far) & (t_far >= 0.0)
                 & (ids(tab, tcol) != skip) & (tab[:, miss] == 0.0))
        total = total + (torch.where(valid, chord, 0.0) * dens[i]).sum(-1)
    return total


def _table_dens(fields: Fields):
    return (fields.sph[:, S_DENS], fields.aabb[:, A_DENS],
            fields.obb[:, O_DENS])


def chord_loss_plain(fields: Fields, o: Tensor, d: Tensor,
                     skip: int) -> Tensor:
    """Plain version of B7: [R] float32 chord x density sums."""
    out = torch.zeros((o.shape[0],), device=o.device)
    dens = _table_dens(fields)
    for c in ray_chunks(o.shape[0], fields.total):
        out[c] = _chord_sum(fields, o[c], d[c], skip, dens)
    return out


def run_chord_loss(fields: Fields, o: Tensor, d: Tensor, skip: int):
    """B7: permeation chord x density sums along the unbounded rays o, d
    [R, 3] (d unit length), skipping the colliders of target ``skip``
    (NO_SKIP for none). Returns [R] float32.

    Its kernel is B3's at S = 1 (``csrc/multi_chord.cu``, in the launch
    shape ``fused.chord_splits`` picks: B3 at one set with per-ray origins
    is exactly this function); it counts its own launches."""
    if on_cpu(o):
        return chord_loss_plain(fields, o, d, skip)
    from audio_raytracer_tpu_torch.ops.cuda import fused

    lib = build.load("multi_chord")
    dev = o.device
    check_operands(dev, o, d)
    R = o.shape[0]
    out = torch.empty((R,), device=dev)
    fused.launch_multi_chord(lib, fields, o, d[None], [skip], out,
                             fused.chord_splits(R, fields.total,
                                                fused.sm_count(dev)))
    if R:
        run_chord_loss.launches += 1
    return out


run_chord_loss.launches = 0


def chord_loss_bwd_plain(fields: Fields, o: Tensor, d: Tensor, skip: int,
                         gbar: Tensor):
    """Plain version of B8: autograd through ``_chord_sum`` per ray chunk.
    Returns (d_o [R, 3], d_d [R, 3], (sphere, aabb, obb) density
    gradients)."""
    d_o, d_d = torch.zeros_like(o), torch.zeros_like(d)
    dens = [x.detach().clone().requires_grad_(True)
            for x in _table_dens(fields)]
    g_dens = [torch.zeros_like(x) for x in dens]
    with torch.enable_grad():
        for c in ray_chunks(o.shape[0], fields.total):
            oc = o[c].detach().requires_grad_(True)
            dc = d[c].detach().requires_grad_(True)
            loss = _chord_sum(fields, oc, dc, skip, dens)
            grads = torch.autograd.grad(loss, [oc, dc, *dens], gbar[c],
                                        allow_unused=True)
            d_o[c], d_d[c] = grads[0], grads[1]
            for acc, g in zip(g_dens, grads[2:]):
                if g is not None:
                    acc += g
    return d_o, d_d, tuple(g_dens)


def run_chord_loss_bwd(fields: Fields, o: Tensor, d: Tensor, skip: int,
                       gbar: Tensor):
    """B8: the adjoint of B7 as jax.vjp takes it (ties split evenly at
    every max and min). gbar [R]: the cotangent of B7's output. Returns
    (d_o [R, 3], d_d [R, 3], (sphere, aabb, obb) density gradients).

    Two launches, both counted here, as B5's: B5's ray kernel at S = 1
    under the BALANCED tie rule (``csrc/multi_chord_bwd.cu::
    chord_loss_bwd``) for d_o and d_d, and B4's primitive-parallel kernel
    at S = 1 for the densities (the same gbar x chord)."""
    if on_cpu(o):
        return chord_loss_bwd_plain(fields, o, d, skip, gbar)
    from audio_raytracer_tpu_torch.ops.cuda.fused import launch_dens_bwd

    lib = build.load("multi_chord_bwd")
    dens_lib = build.load("multi_chord_dens_bwd")
    dev, R = o.device, o.shape[0]
    check_operands(dev, o, d, gbar)
    d_o, d_d = torch.empty((R, 3), device=dev), torch.empty((R, 3),
                                                            device=dev)
    dens = tuple(torch.zeros((n,), device=dev) for n in fields.counts)
    err = lib.chord_loss_bwd(o.data_ptr(), d.data_ptr(), gbar.data_ptr(), R,
                             skip, *table_args(fields, dev), d_o.data_ptr(),
                             d_d.data_ptr(), stream_of(dev))
    build.check("chord_loss_bwd", err)
    launch_dens_bwd(dens_lib, fields, o, d[None], gbar[:, None], [skip],
                    dens)
    if R:
        run_chord_loss_bwd.launches += 2
    return d_o, d_d, dens


run_chord_loss_bwd.launches = 0
