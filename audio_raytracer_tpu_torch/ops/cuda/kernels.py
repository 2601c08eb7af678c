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
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from audio_raytracer_tpu_torch.ops.backend import ray_chunks
from audio_raytracer_tpu_torch.ops.cuda import build
from audio_raytracer_tpu_torch.ops.intersect import _sqrt_disc

Tensor = torch.Tensor
INF = float("inf")
INT_MAX = 2**31 - 1

# Row widths and columns (csrc/fields.cuh).
SPH_W, AABB_W, OBB_W = 8, 12, 20
S_R2, S_TGT, S_DENS = 3, 4, 5  # sphere: cx cy cz r2 tgt dens
A_MISS, A_TGT, A_DENS = 6, 7, 8  # aabb: min xyz, max xyz, miss tgt dens
O_M, O_MISS, O_TGT, O_DENS = 6, 15, 16, 17  # obb: c xyz, h xyz, m 9, ...

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
    row[miss[0]] = miss[1]
    row[tgt:tgt + 1] = torch.tensor([-1], dtype=torch.int32,
                                    device=device).view(torch.float32)
    return row


def pad_to_tiles(tab: Tensor) -> Tensor:
    """tab [n, W] followed by miss rows up to a multiple of TILE rows."""
    n, width = tab.shape
    pad = -n % TILE
    if not pad:
        return tab.contiguous()
    return torch.cat([tab, miss_row(width, tab.device).expand(pad, width)])


def closest_tables(fields: Fields):
    """B1's tables: each type's table padded to whole tiles. The ranks the
    kernel reports are the scan indices of ``fields``."""
    return fields.cached("closest", lambda: tuple(
        pad_to_tiles(t) for t in (fields.sph, fields.aabb, fields.obb)))


def active_rows(tab: Tensor) -> Tensor:
    """[n] bool: the rows of a type table that can hit (sphere r2 >= 0,
    box miss = 0; prepare_fields encodes an inactive primitive as r2 =
    -1e30 or miss = +inf)."""
    if tab.shape[1] == SPH_W:
        return tab[:, S_R2] >= 0.0
    return tab[:, A_MISS if tab.shape[1] == AABB_W else O_MISS] == 0.0


def occlusion_tables(fields: Fields, skips):
    """The occlusion kernels' tables for a launch with these skip targets
    (B2's, and B6's with one): per type (spheres, AABBs, OBBs) a table
    whose active rows owned by none of ``skips`` come first, padded to
    whole tiles, then its active rows owned by one of them, padded
    likewise; inactive rows are left out. Returns ((table, free rows,
    owned rows), ...). Occlusion is an OR over the primitives, so neither
    the order nor the ranks matter."""
    key = tuple(sorted(set(skips)))

    def make():
        out = []
        for tab, col in ((fields.sph, S_TGT), (fields.aabb, A_TGT),
                         (fields.obb, O_TGT)):
            act = active_rows(tab)
            # NO_SKIP matches no row: unowned rows carry -1.
            owned = torch.isin(ids(tab, col), torch.tensor(
                key, dtype=torch.int32, device=tab.device))
            free, mine = tab[act & ~owned], tab[act & owned]
            out.append((torch.cat([pad_to_tiles(free), pad_to_tiles(mine)]),
                        free.shape[0], mine.shape[0]))
        return tuple(out)

    return fields.cached(("occlusion", key), make)


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


def slab(mnx, mny, mnz, mxx, mxy, mxz, ix, iy, iz):
    """(t_near, t_far) from precomputed (bound - origin) terms."""
    t0x, t1x = mnx * ix, mxx * ix
    t0y, t1y = mny * iy, mxy * iy
    t0z, t1z = mnz * iz, mxz * iz
    mn, mx = torch.minimum, torch.maximum
    t_near = mx(mx(mn(t0x, t1x), mn(t0y, t1y)), mn(t0z, t1z))
    t_far = mn(mn(mx(t0x, t1x), mx(t0y, t1y)), mx(t0z, t1z))
    return t_near, t_far


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
        return safe_inv(dx), safe_inv(dy), safe_inv(dz)
    return tuple(safe_inv(v) for v in mat_rotate(fields.obb, dx, dy, dz))


def ray_cols(x: Tensor, c: slice):
    """[R, 3] -> three [c, 1] columns of the chunk."""
    return x[c, 0:1], x[c, 1:2], x[c, 2:3]


# ---------------------------------------------------------------------------
# B1: closest hit
# ---------------------------------------------------------------------------


def _sphere_t(sph, ox, oy, oz, dx, dy, dz, a2, a4):
    ocx, ocy, ocz = ox - sph[:, 0], oy - sph[:, 1], oz - sph[:, 2]
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    cc = (ocx * ocx + ocy * ocy + ocz * ocz) - sph[:, S_R2]
    disc = b * b - a4 * cc
    hit = disc >= 0.0
    sq = torch.sqrt(torch.where(hit, disc, 1.0))
    t0 = (-b - sq) / a2
    t1 = (-b + sq) / a2
    t = torch.where(t0 >= 0.0, t0, torch.where(t1 >= 0.0, t1, INF))
    return t.masked_fill(~hit, INF)


def closest_hit_plain(fields: Fields, o: Tensor, d: Tensor,
                      alive: Tensor | None = None):
    """Plain version of B1: (t [R] (+inf miss), rank [R] int32 (INT_MAX
    on a miss or a dead lane))."""
    R = o.shape[0]
    t_out = torch.full((R,), INF, device=o.device)
    rank_out = torch.full((R,), INT_MAX, dtype=torch.int32, device=o.device)
    if fields.total == 0:
        return t_out, rank_out
    for c in ray_chunks(R, fields.total):
        ox, oy, oz = ray_cols(o, c)
        dx, dy, dz = ray_cols(d, c)
        a = dx * dx + dy * dy + dz * dz
        grids = []
        if fields.counts[0]:
            grids.append(_sphere_t(fields.sph, ox, oy, oz, dx, dy, dz,
                                   2.0 * a, 4.0 * a))
        for kind, tab, miss in (("aabb", fields.aabb, A_MISS),
                                ("obb", fields.obb, O_MISS)):
            if tab.shape[0]:
                terms = box_terms(fields, kind, ox, oy, oz)
                inv = box_inv_dirs(fields, kind, dx, dy, dz)
                grids.append(slab_hit(*slab(*terms, *inv)) + tab[:, miss])
        t, idx = torch.min(torch.cat(grids, dim=-1), dim=-1)
        t_out[c] = t
        rank_out[c] = torch.where(t == INF, INT_MAX, idx.to(torch.int32))
    if alive is not None:
        t_out = t_out.masked_fill(~alive, INF)
        rank_out = rank_out.masked_fill(~alive, INT_MAX)
    return t_out, rank_out


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


def skips_arg(skips):
    """(array, pointer) of an int array of skip target ids; keep the array
    alive while the kernel's C entry point reads it."""
    arr = (ctypes.c_int * len(skips))(*skips)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def run_closest_hit(fields: Fields, o: Tensor, d: Tensor,
                    alive: Tensor | None = None):
    """B1: o, d [R, 3] float32 -> (t [R] float32, +inf on a miss;
    rank [R] int32 in [sphere, aabb, obb] order, INT_MAX on a miss).
    ``alive`` [R] bool: dead lanes skip the scan and report a miss."""
    if on_cpu(o):
        return closest_hit_plain(fields, o, d, alive)
    lib = build.load("closest_hit")
    dev = o.device
    check_operands(dev, o, d)
    if alive is not None:
        check_operands(dev, alive, dtypes=(torch.bool,))
    R = o.shape[0]
    t = torch.empty((R,), device=dev)
    rank = torch.empty((R,), dtype=torch.int32, device=dev)
    args = []  # the padded tables with the real counts, for the ranks
    for tab, n in zip(closest_tables(fields), fields.counts):
        args += [table_ptr(tab, dev), n]
    err = lib.closest_hit(o.data_ptr(), d.data_ptr(),
                          None if alive is None else alive.data_ptr(), R,
                          *args, t.data_ptr(), rank.data_ptr(),
                          stream_of(dev))
    build.check("closest_hit", err)
    if R:
        run_closest_hit.launches += 1
    return t, rank


run_closest_hit.launches = 0


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

    Its kernel is B3's at S = 1 (``csrc/multi_chord.cu``,
    ``multi_chord_kernel<1>``: B3 at one set with per-ray origins is
    exactly this function); it counts its own launches."""
    if on_cpu(o):
        return chord_loss_plain(fields, o, d, skip)
    lib = build.load("multi_chord")
    dev = o.device
    check_operands(dev, o, d)
    R = o.shape[0]
    out = torch.empty((R,), device=dev)
    keep, skips_ptr = skips_arg([skip])
    err = lib.multi_chord(o.data_ptr(), d.data_ptr(), R, 1, skips_ptr,
                          *table_args(fields, dev), out.data_ptr(),
                          stream_of(dev))
    build.check("multi_chord", err)
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
