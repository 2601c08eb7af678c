// B2: fused occlusion of S ray sets that share one origin.
//
// Replaces the TPU kernel audio_raytracer_tpu/ops/pallas/fused.py::
// multi_any_hit_kernel (wrapper run_multi_any_hit). Per ray and set s:
// occluded if any primitive not owned by skips[s] hits at t < limit_s
// (CanRaySeePoint / CanRaySeeAudioTarget, AudioRaytracerJobBatched.cs:
// 365-449). The sphere test runs in the sign domain, with no sqrt and no
// division, and needs |d| = 1 (the trace normalizes every set):
//   h = oc.d, c = |oc|^2 - r^2, q(lim) = lim^2 + 2 h lim + c
//   entering: c >= 0, h <= 0, and (h + lim > 0 or q < 0)
//   inside:   c < 0, h + lim > 0 and q > 0
//   occluded: h^2 >= c and (entering or inside)
// Box tests share the per-primitive (bound - origin) terms across sets.
// Lanes with init bits set come back occluded.
//
// Bound on the H100: float32 operations outside the tensor cores, per
// (live ray, primitive): sphere 10 + 15 S, AABB 6 + 21 S, OBB 27 + 42 S
// (ops/cuda/fused.py::OCC_OPS; the per-set part only for the (ray, set)
// pairs not resolved on entry), against the issue ceiling that B9
// measures (about 33.7 T ops/s). S = 1 + T is 5 on the headline workload.
//
// What the machine code showed (PERF.md): at S = 5 the loop bodies
// issued 128, 167 and 540 instructions per (ray, sphere / AABB / OBB) for
// 85, 111 and 237 counted: per set the skip-target compare and a
// short-circuit branch around the accumulator; per OBB reciprocal nvcc's
// range test and slow-path branch (15 per (ray, OBB)). Staging and
// occupancy cost little. The design:
//
// - The wrapper splits each type's rows into those owned by none of the
//   launch's skip targets, walked with no skip compare, and those owned by
//   one, walked with it; inactive rows are left out (they never hit, and
//   the occlusion is an OR, so the order and the rows' ranks are free).
// - Set results are OR-ed into a bit mask by predicated instructions; the
//   miss select of the slab folds into the limit test (slab_within).
// - OBB reciprocals through rcp_newton, bit-identical to 1.0f / x, with one
//   range test per (ray, OBB) for all sets, which also stands in for the
//   nudge; a ray outside the range recomputes that row with safe_inv.
// - Tiles staged by TMA into a two-buffer ring (fields.cuh ring_*), one
//   barrier per tile.
// - One thread per ray: in float32, two rays per thread (at S = 5 they
//   need 128 registers and halve the resident warps), and packing a
//   block's live rays onto its first warps, were built and measured and
//   bought nothing (PERF.md). A lane whose sets are all resolved on entry
//   skips the rows, a block of such lanes the tiles.
// - The walk does not stop early: on the headline frame's bounce rays no
//   warp has every set resolved by mid-walk (PERF.md).
//
// What still holds it back: the compare, min / max, select and predicate
// instructions (about 80 of the 127 per (ray, AABB) at S = 5), which
// appear to issue at most every other cycle; the bound counts them at
// the FFMA rate.
//
// The bfloat16 tier (the JAX wrapper's dtype=jnp.bfloat16, entry
// multi_any_hit_bf16) is multi_any_hit_pairs_kernel: the rounding points
// of the JAX tier (fields.cuh, "Compute types") with two rays a thread in
// bf16x2 words (BF16X2), as closest_hit.cu's pairs kernel, on tables the
// wrapper rounds once (bf16x2_table). In float32 a second ray doubled the
// registers and the instructions; packed, the two share both: at S = 5 a
// pair holds 3 + 6 S packed words and 3 S limits. Per pair:
// - the differences, dot products, rotations, slab products and min /
//   max chains packed; the sphere's sign tests on h, hl, q and c in
//   float32 per ray on the widened halves; the OBB reciprocals by
//   rcp_newton per ray, repacked by one cvt, safe_inv where a ray with a
//   set open falls outside rcp_in_range;
// - the slab's test packed (slab_within2): t (t_near if > 0 else t_far)
//   below the limit rounded up to bfloat16 (fields.cuh bf16_up), which
//   decides as the float32 t < limit does, masked by the per-half miss
//   masks; the tables' miss column is 0 or +inf, so + miss < limit is a
//   per-row test of miss == 0;
// - acc keeps ray 2i's sets in bits 0-15 and ray 2i + 1's in bits 16-31.
// Bound: its bfloat16 operations and packed compares and selects at the
// packed rates of chip_smoke.py phase 2b, each at least twice the float32
// ceiling, the float32 islands at the ceiling. At the frame loop's few
// rays the pairs run 1.06x the one-ray-a-thread kernel, as B1's (PERF.md).

#include "fields.cuh"

// Most threads a block of the bfloat16 tier's kernel (pair_threads), two
// rays each: 256 against 128 ran faster at the headline shape (PERF.md).
#define PAIR_BLOCK 256

// One ray's S sets in float32.
template <int S>
struct OccRay {
  float ox, oy, oz;
  float dx[S], dy[S], dz[S], lim[S], ix[S], iy[S], iz[S];
  unsigned acc;  // bit s: set s occluded or resolved on entry
};

template <int S, bool OWNED>
__device__ __forceinline__ void sphere_row(const float* p, OccRay<S>& y,
                                           const Skips& sk) {
  const int tgt = as_id(p[4]);
  const float ocx = y.ox - p[0], ocy = y.oy - p[1], ocz = y.oz - p[2];
  const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - p[3];
  const bool c_pos = c >= 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float h = ocx * y.dx[s] + ocy * y.dy[s] + ocz * y.dz[s];
    const float hl = h + y.lim[s];
    const float q = y.lim[s] * (hl + h) + c;
    const bool entering = c_pos & (h <= 0.0f) & ((hl > 0.0f) | (q < 0.0f));
    const bool inside = !c_pos & (hl > 0.0f) & (q > 0.0f);
    bool occ = (h * h >= c) & (entering | inside);
    if constexpr (OWNED) occ &= tgt != sk.v[s];
    if (occ) y.acc |= 1u << s;
  }
}

// slab_hit(tn, tf) + miss < lim without the select of a miss: a miss is
// +inf there, below no limit.
__device__ __forceinline__ bool slab_within(float tn, float tf, float miss,
                                            float lim) {
  return !(tn > tf) & !(tf < 0.0f) & ((tn > 0.0f ? tn : tf) + miss < lim);
}

template <int S, bool OWNED>
__device__ __forceinline__ void aabb_row(const float* p, OccRay<S>& y,
                                         const Skips& sk) {
  const int tgt = as_id(p[7]);
  const float mnx = p[0] - y.ox, mny = p[1] - y.oy, mnz = p[2] - y.oz;
  const float mxx = p[3] - y.ox, mxy = p[4] - y.oy, mxz = p[5] - y.oz;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float tn, tf;
    slab(mnx, mny, mnz, mxx, mxy, mxz, y.ix[s], y.iy[s], y.iz[s], tn, tf);
    bool occ = slab_within(tn, tf, p[6], y.lim[s]);
    if constexpr (OWNED) occ &= tgt != sk.v[s];
    if (occ) y.acc |= 1u << s;
  }
}

// The sets an OBB row occludes; NEWTON selects rcp_newton for the
// reciprocals (ok: every local direction component in rcp_in_range) or
// safe_inv.
template <int S, bool OWNED, bool NEWTON>
__device__ __forceinline__ unsigned obb_hits(const float* p,
                                             const OccRay<S>& y,
                                             const Skips& sk, bool& ok) {
  const int tgt = as_id(p[16]);
  float lox, loy, loz;
  mat_rotate(p + 6, y.ox - p[0], y.oy - p[1], y.oz - p[2], lox, loy, loz);
  const float mnx = -p[3] - lox, mny = -p[4] - loy, mnz = -p[5] - loz;
  const float mxx = p[3] - lox, mxy = p[4] - loy, mxz = p[5] - loz;
  unsigned hits = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float ldx, ldy, ldz;
    mat_rotate(p + 6, y.dx[s], y.dy[s], y.dz[s], ldx, ldy, ldz);
    float ix, iy, iz;
    if constexpr (NEWTON) {
      ok &= rcp_in_range(ldx) & rcp_in_range(ldy) & rcp_in_range(ldz);
      ix = rcp_newton(ldx); iy = rcp_newton(ldy); iz = rcp_newton(ldz);
    } else {
      ix = safe_inv(ldx); iy = safe_inv(ldy); iz = safe_inv(ldz);
    }
    float tn, tf;
    slab(mnx, mny, mnz, mxx, mxy, mxz, ix, iy, iz, tn, tf);
    bool occ = slab_within(tn, tf, p[15], y.lim[s]);
    if constexpr (OWNED) occ &= tgt != sk.v[s];
    if (occ) hits |= 1u << s;
  }
  return hits;
}

template <int S, bool OWNED>
__device__ __forceinline__ void obb_row(const float* p, OccRay<S>& y,
                                        const Skips& sk) {
  bool ok = true;
  unsigned hits = obb_hits<S, OWNED, true>(p, y, sk, ok);
  if (!ok) hits = obb_hits<S, OWNED, false>(p, y, sk, ok);
  y.acc |= hits;
}

// The rows of one tile against the thread's ray.
template <int S, int KIND, bool OWNED>
__device__ __forceinline__ void walk_tile(const float* tile, OccRay<S>& y,
                                          const Skips& sk) {
  constexpr int W = KIND == 0 ? SPH_W : (KIND == 1 ? AABB_W : OBB_W);
#pragma unroll 2
  for (int j = 0; j < RING_TILE; ++j) {
    const float* p = tile + j * W;
    if constexpr (KIND == 0) sphere_row<S, OWNED>(p, y, sk);
    if constexpr (KIND == 1) aabb_row<S, OWNED>(p, y, sk);
    if constexpr (KIND == 2) obb_row<S, OWNED>(p, y, sk);
  }
}

// s: six segments — per type (spheres, AABBs, OBBs) the rows owned by no
// skip target of the launch, then the rows owned by one; each padded to
// whole tiles with rows that never hit.
template <int S>
__global__ void __launch_bounds__(BLOCK)
multi_any_hit_kernel(const float* __restrict__ o,
                     const float* __restrict__ dirs,
                     const float* __restrict__ limits,
                     const unsigned char* __restrict__ init, int R,
                     Skips skips, Stream s,
                     unsigned char* __restrict__ occ_out) {
  __shared__ __align__(128) float ring[STAGES * RING_FLOATS];
  __shared__ __align__(8) unsigned long long full[STAGES];
  constexpr unsigned ALL = (1u << S) - 1u;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = r < R;

  OccRay<S> y;
  y.ox = y.oy = y.oz = 0.0f;
  y.acc = ALL;
  if (in_range) {
    y.ox = o[3 * r]; y.oy = o[3 * r + 1]; y.oz = o[3 * r + 2];
    y.acc = 0;
  }
#pragma unroll
  for (int q = 0; q < S; ++q) {
    y.dx[q] = y.dy[q] = y.dz[q] = y.lim[q] = 0.0f;
    if (in_range) {
      const size_t i = 3 * ((size_t)q * R + r);
      y.dx[q] = dirs[i]; y.dy[q] = dirs[i + 1]; y.dz[q] = dirs[i + 2];
      y.lim[q] = limits[(size_t)r * S + q];
      if (init[(size_t)r * S + q] != 0) y.acc |= 1u << q;
    }
    y.ix[q] = safe_inv(y.dx[q]);
    y.iy[q] = safe_inv(y.dy[q]);
    y.iz[q] = safe_inv(y.dz[q]);
  }
  const bool live = y.acc != ALL;

  // A block whose lanes are all resolved on entry: no primitive stream.
  if (__syncthreads_or(live)) {
    ring_start(s, ring, full);
    int t = 0;
#define WALK(SEG, KIND, OWNED)                                            \
  for (int k = 0; k < s.tiles[SEG]; ++k, ++t) {                           \
    const float* tile = ring_wait(ring, full, t);                         \
    if (live) walk_tile<S, KIND, OWNED>(tile, y, skips);                  \
    ring_release(s, ring, full, t);                                       \
  }
    WALK(0, 0, false) WALK(1, 0, true)
    WALK(2, 1, false) WALK(3, 1, true)
    WALK(4, 2, false) WALK(5, 2, true)
#undef WALK
  }
  if (in_range) {
#pragma unroll
    for (int q = 0; q < S; ++q)
      occ_out[(size_t)r * S + q] = (y.acc >> q) & 1u;
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 tier: two rays a thread
// ---------------------------------------------------------------------------

using P2 = BF16X2;

// Rays 2i and 2i + 1's S sets (fields.cuh BF16X2): the origin, directions
// and inverse directions packed; the limits in float32 per ray (the
// sphere's sign tests) and rounded up to bfloat16 (bf16_up) for the slab
// test.
template <int S>
struct OccPair {
  bf16x2_t ox, oy, oz;
  bf16x2_t dx[S], dy[S], dz[S], ix[S], iy[S], iz[S], lim_up[S];
  float lim[2][S];
  unsigned acc;  // pair_bit: set s of ray h occluded or resolved on entry
};

// The sets of a row that are not the target's own: pair_bit of every set
// whose skip target is not `tgt`.
template <int S>
__device__ __forceinline__ unsigned free_sets(int tgt, const Skips& sk) {
  unsigned m = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (tgt != sk.v[s]) m |= 0x10001u << s;
  return m;
}

// sphere_row on a pair: h and |oc|^2 packed, the sign tests per ray in
// float32. r2 is the float32 of its bfloat16 rounding.
template <int S, bool OWNED>
__device__ __forceinline__ void sphere_pair(const float* p, OccPair<S>& y,
                                            const Skips& sk) {
  const bf16x2_t ocx = P2::sub(y.ox, P2::ld(p[0])),
                 ocy = P2::sub(y.oy, P2::ld(p[1])),
                 ocz = P2::sub(y.oz, P2::ld(p[2]));
  const bf16x2_t oc2 = dot3<P2>(ocx, ocy, ocz, ocx, ocy, ocz);
  float c[2];
  bool c_pos[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    c[k] = P2::half(oc2, k) - p[3];
    c_pos[k] = c[k] >= 0.0f;
  }
  unsigned hits = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bf16x2_t h2 = dot3<P2>(ocx, ocy, ocz, y.dx[s], y.dy[s], y.dz[s]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float h = P2::half(h2, k), lim = y.lim[k][s];
      const float hl = h + lim;
      const float q = lim * (hl + h) + c[k];
      const bool entering =
          c_pos[k] & (h <= 0.0f) & ((hl > 0.0f) | (q < 0.0f));
      const bool inside = !c_pos[k] & (hl > 0.0f) & (q > 0.0f);
      if ((h * h >= c[k]) & (entering | inside)) hits |= 1u << (s + 16 * k);
    }
  }
  if constexpr (OWNED) hits &= free_sets<S>(as_id(p[4]), sk);
  y.acc |= hits;
}

// The rows of B2's bf16x2 tables are active (miss 0) or padding (miss
// +inf), so slab_hit + miss < lim is: miss == 0 and the slab's hit below
// the limit (slab_within2).
__device__ __forceinline__ unsigned active_row(float miss) {
  return miss == 0.0f ? ~0u : 0u;
}

template <int S, bool OWNED>
__device__ __forceinline__ void aabb_pair(const float* p, OccPair<S>& y,
                                          const Skips& sk) {
  const bf16x2_t mnx = P2::sub(P2::ld(p[0]), y.ox),
                 mny = P2::sub(P2::ld(p[1]), y.oy),
                 mnz = P2::sub(P2::ld(p[2]), y.oz);
  const bf16x2_t mxx = P2::sub(P2::ld(p[3]), y.ox),
                 mxy = P2::sub(P2::ld(p[4]), y.oy),
                 mxz = P2::sub(P2::ld(p[5]), y.oz);
  unsigned hits = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    bf16x2_t tn, tf;
    slab_c<P2>(mnx, mny, mnz, mxx, mxy, mxz, y.ix[s], y.iy[s], y.iz[s], tn,
               tf);
    hits |= pair_bit(slab_within2(tn, tf, y.lim_up[s]), s);
  }
  if constexpr (OWNED) hits &= free_sets<S>(as_id(p[7]), sk);
  y.acc |= hits & active_row(p[6]);
}

// obb_row on a pair. The reciprocals by rcp_newton where both rays' local
// direction components lie in rcp_in_range (a ray with nothing left to
// test counts as in it), else by safe_inv (equal to rcp_newton's in the
// range), per set.
template <int S, bool OWNED>
__device__ __forceinline__ void obb_pair(const float* p, OccPair<S>& y,
                                         const Skips& sk,
                                         const bool open[2]) {
  bf16x2_t mn[3], mx[3];
  obb_terms<P2>(p, y.ox, y.oy, y.oz, mn, mx);
  unsigned hits = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    bf16x2_t ld[3];
    mat_rotate<P2>(p + 6, y.dx[s], y.dy[s], y.dz[s], ld[0], ld[1], ld[2]);
    float f[2][3];
    bool ok = true;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int a = 0; a < 3; ++a) f[k][a] = P2::half(ld[a], k);
      ok &= !open[k] | (rcp_in_range(f[k][0]) & rcp_in_range(f[k][1]) &
                        rcp_in_range(f[k][2]));
    }
    bf16x2_t inv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      inv[a] = P2::pack(rcp_newton(f[0][a]), rcp_newton(f[1][a]));
    if (!ok) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        inv[a] = P2::pack(safe_inv(f[0][a]), safe_inv(f[1][a]));
    }
    bf16x2_t tn, tf;
    slab_c<P2>(mn[0], mn[1], mn[2], mx[0], mx[1], mx[2], inv[0], inv[1],
               inv[2], tn, tf);
    hits |= pair_bit(slab_within2(tn, tf, y.lim_up[s]), s);
  }
  if constexpr (OWNED) hits &= free_sets<S>(as_id(p[16]), sk);
  y.acc |= hits & active_row(p[15]);
}

template <int S, int KIND, bool OWNED>
__device__ __forceinline__ void walk_tile_pair(const float* tile,
                                               OccPair<S>& y,
                                               const Skips& sk,
                                               const bool open[2]) {
  constexpr int W = KIND == 0 ? SPH_W : (KIND == 1 ? AABB_W : OBB_W);
#pragma unroll 2
  for (int j = 0; j < RING_TILE; ++j) {
    const float* p = tile + j * W;
    if constexpr (KIND == 0) sphere_pair<S, OWNED>(p, y, sk);
    if constexpr (KIND == 1) aabb_pair<S, OWNED>(p, y, sk);
    if constexpr (KIND == 2) obb_pair<S, OWNED>(p, y, sk, open);
  }
}

// B2 in the bfloat16 tier: the JAX tier's decisions (the bf16 plain
// version's bits) on rays 2i and 2i + 1 in one thread, its tables rounded
// by the wrapper (ops/cuda/kernels.py::bf16x2_table). The acc and init bits stay
// per ray; a pair walks while either ray has a set open.
template <int S>
__global__ void __launch_bounds__(PAIR_BLOCK)
multi_any_hit_pairs_kernel(const float* __restrict__ o,
                           const float* __restrict__ dirs,
                           const float* __restrict__ limits,
                           const unsigned char* __restrict__ init, int R,
                           Skips skips, Stream s,
                           unsigned char* __restrict__ occ_out) {
  __shared__ __align__(128) float ring[STAGES * RING_FLOATS];
  __shared__ __align__(8) unsigned long long full[STAGES];
  constexpr unsigned ALL = (1u << S) - 1u;
  const int r0 = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  bool in_range[2];
  float fo[2][3];
  OccPair<S> y;
  y.acc = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = r0 + k;
    in_range[k] = r < R;
#pragma unroll
    for (int a = 0; a < 3; ++a) fo[k][a] = in_range[k] ? o[3 * r + a] : 0.0f;
    if (!in_range[k]) y.acc |= ALL << (16 * k);
  }
  y.ox = P2::pack(fo[0][0], fo[1][0]);
  y.oy = P2::pack(fo[0][1], fo[1][1]);
  y.oz = P2::pack(fo[0][2], fo[1][2]);
#pragma unroll
  for (int q = 0; q < S; ++q) {
    float fd[2][3];
    unsigned up[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = r0 + k;
      y.lim[k][q] = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) fd[k][a] = 0.0f;
      if (in_range[k]) {
        const size_t i = 3 * ((size_t)q * R + r);
        fd[k][0] = dirs[i]; fd[k][1] = dirs[i + 1]; fd[k][2] = dirs[i + 2];
        y.lim[k][q] = limits[(size_t)r * S + q];
        if (init[(size_t)r * S + q] != 0) y.acc |= 1u << (q + 16 * k);
      }
      up[k] = bf16_up(y.lim[k][q]);
    }
    y.lim_up[q] = bf16x2_t{up[0] | (up[1] << 16)};
    y.dx[q] = P2::pack(fd[0][0], fd[1][0]);
    y.dy[q] = P2::pack(fd[0][1], fd[1][1]);
    y.dz[q] = P2::pack(fd[0][2], fd[1][2]);
    y.ix[q] = P2::pack(safe_inv(P2::half(y.dx[q], 0)),
                       safe_inv(P2::half(y.dx[q], 1)));
    y.iy[q] = P2::pack(safe_inv(P2::half(y.dy[q], 0)),
                       safe_inv(P2::half(y.dy[q], 1)));
    y.iz[q] = P2::pack(safe_inv(P2::half(y.dz[q], 0)),
                       safe_inv(P2::half(y.dz[q], 1)));
  }
  const bool open[2] = {(y.acc & ALL) != ALL, (y.acc >> 16) != ALL};
  const bool live = open[0] | open[1];

  // A block whose rays are all resolved on entry: no primitive stream.
  if (__syncthreads_or(live)) {
    ring_start(s, ring, full);
    int t = 0;
#define WALK(SEG, KIND, OWNED)                                              \
  for (int k = 0; k < s.tiles[SEG]; ++k, ++t) {                             \
    const float* tile = ring_wait(ring, full, t);                           \
    if (live) walk_tile_pair<S, KIND, OWNED>(tile, y, skips, open);         \
    ring_release(s, ring, full, t);                                         \
  }
    WALK(0, 0, false) WALK(1, 0, true)
    WALK(2, 1, false) WALK(3, 1, true)
    WALK(4, 2, false) WALK(5, 2, true)
#undef WALK
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (in_range[k]) {
#pragma unroll
      for (int q = 0; q < S; ++q)
        occ_out[(size_t)(r0 + k) * S + q] = (y.acc >> (q + 16 * k)) & 1u;
    }
  }
}

// One launch of the float32 kernel (PAIRS: the bfloat16 tier's pairs
// kernel) at N sets.
#define LAUNCH_SETS(N)                                                      \
  case N:                                                                   \
    if constexpr (PAIRS)                                                    \
      multi_any_hit_pairs_kernel<N><<<                                      \
          ((R + 1) / 2 + threads - 1) / threads, threads, 0,                \
          (cudaStream_t)stream>>>(o, dirs, limits, init, R, sk, st,         \
                                  occ_out);                                 \
    else                                                                    \
      multi_any_hit_kernel<N><<<(R + BLOCK - 1) / BLOCK, BLOCK, 0,          \
                                (cudaStream_t)stream>>>(                    \
          o, dirs, limits, init, R, sk, st, occ_out);                       \
    break;

template <bool PAIRS>
static int launch(const float* o, const float* dirs, const float* limits,
                  const unsigned char* init, int R, int S, const int* skips,
                  const float* sph, int ns_free, int ns_owned,
                  const float* aabb, int na_free, int na_owned,
                  const float* obb, int no_free, int no_owned,
                  unsigned char* occ_out, int sms, void* stream) {
  if (S < 1 || S > MAX_SETS) return (int)cudaErrorInvalidValue;
  if (R == 0) RETURN_LAST_ERROR;
  Skips sk;
  for (int s = 0; s < MAX_SETS; ++s) sk.v[s] = s < S ? skips[s] : 0;
  Stream st{};
  stream_add(st, stream_add(st, sph, ns_free, SPH_W), ns_owned, SPH_W);
  stream_add(st, stream_add(st, aabb, na_free, AABB_W), na_owned, AABB_W);
  stream_add(st, stream_add(st, obb, no_free, OBB_W), no_owned, OBB_W);
  const int threads =
      PAIRS ? pair_threads((R + 1) / 2, PAIR_BLOCK, sms) : 0;
  switch (S) {
    LAUNCH_SETS(1) LAUNCH_SETS(2) LAUNCH_SETS(3) LAUNCH_SETS(4)
    LAUNCH_SETS(5) LAUNCH_SETS(6) LAUNCH_SETS(7) LAUNCH_SETS(8)
    LAUNCH_SETS(9) LAUNCH_SETS(10) LAUNCH_SETS(11) LAUNCH_SETS(12)
    LAUNCH_SETS(13) LAUNCH_SETS(14) LAUNCH_SETS(15) LAUNCH_SETS(16)
  }
  RETURN_LAST_ERROR;
}

// Per type: the table and its counts of rows owned by no skip target of
// this launch (first) and by one (after the first part's padding to whole
// tiles); each part is padded to whole tiles with rows that never hit.
extern "C" int multi_any_hit(const float* o, const float* dirs,
                             const float* limits, const unsigned char* init,
                             int R, int S, const int* skips,
                             const float* sph, int ns_free, int ns_owned,
                             const float* aabb, int na_free, int na_owned,
                             const float* obb, int no_free, int no_owned,
                             unsigned char* occ_out, void* stream) {
  return launch<false>(o, dirs, limits, init, R, S, skips, sph, ns_free,
                       ns_owned, aabb, na_free, na_owned, obb, no_free,
                       no_owned, occ_out, 0, stream);
}

// The bfloat16 tier: the same arguments, float32 rays and limits, the
// tables of ops/cuda/kernels.py::bf16x2_table (geometry as bf16x2 words),
// and the card's SM count for pair_threads.
extern "C" int multi_any_hit_bf16(const float* o, const float* dirs,
                                  const float* limits,
                                  const unsigned char* init, int R, int S,
                                  const int* skips, const float* sph,
                                  int ns_free, int ns_owned,
                                  const float* aabb, int na_free,
                                  int na_owned, const float* obb,
                                  int no_free, int no_owned,
                                  unsigned char* occ_out, int sms,
                                  void* stream) {
  return launch<true>(o, dirs, limits, init, R, S, skips, sph, ns_free,
                      ns_owned, aabb, na_free, na_owned, obb, no_free,
                      no_owned, occ_out, sms, stream);
}

#define OCCUPANCY_SETS(N)                                                   \
  case N:                                                                   \
    return (int)(PAIRS ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(     \
                             blocks, multi_any_hit_pairs_kernel<N>,         \
                             PAIR_BLOCK, 0)                                 \
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(     \
                             blocks, multi_any_hit_kernel<N>, BLOCK, 0));

template <bool PAIRS>
static int occupancy(int S, int* blocks) {
  switch (S) {
    OCCUPANCY_SETS(1) OCCUPANCY_SETS(2) OCCUPANCY_SETS(3) OCCUPANCY_SETS(4)
    OCCUPANCY_SETS(5) OCCUPANCY_SETS(6) OCCUPANCY_SETS(7) OCCUPANCY_SETS(8)
    OCCUPANCY_SETS(9) OCCUPANCY_SETS(10) OCCUPANCY_SETS(11)
    OCCUPANCY_SETS(12) OCCUPANCY_SETS(13) OCCUPANCY_SETS(14)
    OCCUPANCY_SETS(15) OCCUPANCY_SETS(16)
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks per SM of the kernel at S sets, and of the bfloat16
// tier's (cudaOccupancy...).
extern "C" int multi_any_hit_occupancy(int S, int* blocks, int* blocks_bf16) {
  const int err = occupancy<false>(S, blocks);
  return err ? err : occupancy<true>(S, blocks_bf16);
}
