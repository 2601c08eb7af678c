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
// - One thread per ray: two rays per thread (at S = 5 they need 128
//   registers and halve the resident warps), and packing a block's live
//   rays onto its first warps, were built and measured and bought nothing
//   (PERF.md). A lane whose sets are all resolved on entry skips the
//   rows, a block of such lanes the tiles.
// - The walk does not stop early: on the headline frame's bounce rays no
//   warp has every set resolved by mid-walk (PERF.md).
//
// What still holds it back: the compare, min / max, select and predicate
// instructions (about 80 of the 127 per (ray, AABB) at S = 5), which
// appear to issue at most every other cycle; the bound counts them at
// the FFMA rate.
//
// The bfloat16 tier (the JAX wrapper's dtype=jnp.bfloat16) is the same
// kernel at C = BF16 (multi_any_hit_bf16): the rounding points of the JAX
// tier (fields.cuh, "Compute types"); the sphere's c and h are widened to
// float32 before the sign tests, the slab's t_near and t_far before the
// limit test, and the OBB reciprocals stay float32 (rcp_newton).

#include "fields.cuh"

// One ray's S sets in the compute type C (fields.cuh): the origin,
// directions and inverse directions in C::T, the limits in float32.
template <int S, class C>
struct OccRay {
  using T = typename C::T;
  T ox, oy, oz;
  T dx[S], dy[S], dz[S], ix[S], iy[S], iz[S];
  float lim[S];
  unsigned acc;  // bit s: set s occluded or resolved on entry
};

template <int S, class C, bool OWNED>
__device__ __forceinline__ void sphere_row(const float* p, OccRay<S, C>& y,
                                           const Skips& sk) {
  using T = typename C::T;
  const int tgt = as_id(p[4]);
  const T ocx = C::sub(y.ox, C::ld(p[0])), ocy = C::sub(y.oy, C::ld(p[1])),
          ocz = C::sub(y.oz, C::ld(p[2]));
  const float c =
      C::up(dot3<C>(ocx, ocy, ocz, ocx, ocy, ocz)) - C::up(C::ld(p[3]));
  const bool c_pos = c >= 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float h = C::up(dot3<C>(ocx, ocy, ocz, y.dx[s], y.dy[s], y.dz[s]));
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

template <int S, class C, bool OWNED>
__device__ __forceinline__ void aabb_row(const float* p, OccRay<S, C>& y,
                                         const Skips& sk) {
  using T = typename C::T;
  const int tgt = as_id(p[7]);
  const T mnx = field_minus<C>(p[0], y.ox), mny = field_minus<C>(p[1], y.oy),
          mnz = field_minus<C>(p[2], y.oz);
  const T mxx = field_minus<C>(p[3], y.ox), mxy = field_minus<C>(p[4], y.oy),
          mxz = field_minus<C>(p[5], y.oz);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float tn, tf;
    slab<C>(mnx, mny, mnz, mxx, mxy, mxz, y.ix[s], y.iy[s], y.iz[s], tn, tf);
    bool occ = slab_within(tn, tf, p[6], y.lim[s]);
    if constexpr (OWNED) occ &= tgt != sk.v[s];
    if (occ) y.acc |= 1u << s;
  }
}

// The sets an OBB row occludes; NEWTON selects rcp_newton for the
// reciprocals (ok: every local direction component in rcp_in_range) or
// safe_inv, both in float32.
template <int S, class C, bool OWNED, bool NEWTON>
__device__ __forceinline__ unsigned obb_hits(const float* p,
                                             const OccRay<S, C>& y,
                                             const Skips& sk, bool& ok) {
  using T = typename C::T;
  const int tgt = as_id(p[16]);
  T mn[3], mx[3];
  obb_terms<C>(p, y.ox, y.oy, y.oz, mn, mx);
  unsigned hits = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T ldx, ldy, ldz;
    mat_rotate<C>(p + 6, y.dx[s], y.dy[s], y.dz[s], ldx, ldy, ldz);
    T ix, iy, iz;
    if constexpr (NEWTON) {
      const float fx = C::up(ldx), fy = C::up(ldy), fz = C::up(ldz);
      ok &= rcp_in_range(fx) & rcp_in_range(fy) & rcp_in_range(fz);
      ix = C::ld(rcp_newton(fx));
      iy = C::ld(rcp_newton(fy));
      iz = C::ld(rcp_newton(fz));
    } else {
      ix = inv_dir<C>(ldx); iy = inv_dir<C>(ldy); iz = inv_dir<C>(ldz);
    }
    float tn, tf;
    slab<C>(mn[0], mn[1], mn[2], mx[0], mx[1], mx[2], ix, iy, iz, tn, tf);
    bool occ = slab_within(tn, tf, p[15], y.lim[s]);
    if constexpr (OWNED) occ &= tgt != sk.v[s];
    if (occ) hits |= 1u << s;
  }
  return hits;
}

template <int S, class C, bool OWNED>
__device__ __forceinline__ void obb_row(const float* p, OccRay<S, C>& y,
                                        const Skips& sk) {
  bool ok = true;
  unsigned hits = obb_hits<S, C, OWNED, true>(p, y, sk, ok);
  if (!ok) hits = obb_hits<S, C, OWNED, false>(p, y, sk, ok);
  y.acc |= hits;
}

// The rows of one tile against the thread's ray.
template <int S, class C, int KIND, bool OWNED>
__device__ __forceinline__ void walk_tile(const float* tile, OccRay<S, C>& y,
                                          const Skips& sk) {
  constexpr int W = KIND == 0 ? SPH_W : (KIND == 1 ? AABB_W : OBB_W);
#pragma unroll 2
  for (int j = 0; j < RING_TILE; ++j) {
    const float* p = tile + j * W;
    if constexpr (KIND == 0) sphere_row<S, C, OWNED>(p, y, sk);
    if constexpr (KIND == 1) aabb_row<S, C, OWNED>(p, y, sk);
    if constexpr (KIND == 2) obb_row<S, C, OWNED>(p, y, sk);
  }
}

// s: six segments — per type (spheres, AABBs, OBBs) the rows owned by no
// skip target of the launch, then the rows owned by one; each padded to
// whole tiles with rows that never hit. The origin and directions are
// rounded to C on entry.
template <int S, class C>
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

  OccRay<S, C> y;
  float fo[3] = {0.f, 0.f, 0.f};
  y.acc = ALL;
  if (in_range) {
    fo[0] = o[3 * r]; fo[1] = o[3 * r + 1]; fo[2] = o[3 * r + 2];
    y.acc = 0;
  }
  y.ox = C::ld(fo[0]); y.oy = C::ld(fo[1]); y.oz = C::ld(fo[2]);
#pragma unroll
  for (int q = 0; q < S; ++q) {
    float fd[3] = {0.f, 0.f, 0.f};
    y.lim[q] = 0.0f;
    if (in_range) {
      const size_t i = 3 * ((size_t)q * R + r);
      fd[0] = dirs[i]; fd[1] = dirs[i + 1]; fd[2] = dirs[i + 2];
      y.lim[q] = limits[(size_t)r * S + q];
      if (init[(size_t)r * S + q] != 0) y.acc |= 1u << q;
    }
    y.dx[q] = C::ld(fd[0]); y.dy[q] = C::ld(fd[1]); y.dz[q] = C::ld(fd[2]);
    y.ix[q] = inv_dir<C>(y.dx[q]);
    y.iy[q] = inv_dir<C>(y.dy[q]);
    y.iz[q] = inv_dir<C>(y.dz[q]);
  }
  const bool live = y.acc != ALL;

  // A block whose lanes are all resolved on entry: no primitive stream.
  if (__syncthreads_or(live)) {
    ring_start(s, ring, full);
    int t = 0;
#define WALK(SEG, KIND, OWNED)                                            \
  for (int k = 0; k < s.tiles[SEG]; ++k, ++t) {                           \
    const float* tile = ring_wait(ring, full, t);                         \
    if (live) walk_tile<S, C, KIND, OWNED>(tile, y, skips);               \
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

#define LAUNCH_SETS(N)                                                      \
  case N:                                                                   \
    multi_any_hit_kernel<N, C><<<(R + BLOCK - 1) / BLOCK, BLOCK, 0,         \
                                 (cudaStream_t)stream>>>(                   \
        o, dirs, limits, init, R, sk, st, occ_out);                         \
    break;

template <class C>
static int launch(const float* o, const float* dirs, const float* limits,
                  const unsigned char* init, int R, int S, const int* skips,
                  const float* sph, int ns_free, int ns_owned,
                  const float* aabb, int na_free, int na_owned,
                  const float* obb, int no_free, int no_owned,
                  unsigned char* occ_out, void* stream) {
  if (S < 1 || S > MAX_SETS) return (int)cudaErrorInvalidValue;
  if (R == 0) RETURN_LAST_ERROR;
  Skips sk;
  for (int s = 0; s < MAX_SETS; ++s) sk.v[s] = s < S ? skips[s] : 0;
  Stream st{};
  stream_add(st, stream_add(st, sph, ns_free, SPH_W), ns_owned, SPH_W);
  stream_add(st, stream_add(st, aabb, na_free, AABB_W), na_owned, AABB_W);
  stream_add(st, stream_add(st, obb, no_free, OBB_W), no_owned, OBB_W);
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
  return launch<F32>(o, dirs, limits, init, R, S, skips, sph, ns_free,
                     ns_owned, aabb, na_free, na_owned, obb, no_free,
                     no_owned, occ_out, stream);
}

// The bfloat16 tier: the same arguments (float32 rays, limits and tables;
// the rays and the geometry rounded in the kernel).
extern "C" int multi_any_hit_bf16(const float* o, const float* dirs,
                                  const float* limits,
                                  const unsigned char* init, int R, int S,
                                  const int* skips, const float* sph,
                                  int ns_free, int ns_owned,
                                  const float* aabb, int na_free,
                                  int na_owned, const float* obb,
                                  int no_free, int no_owned,
                                  unsigned char* occ_out, void* stream) {
  return launch<BF16>(o, dirs, limits, init, R, S, skips, sph, ns_free,
                      ns_owned, aabb, na_free, na_owned, obb, no_free,
                      no_owned, occ_out, stream);
}

#define OCCUPANCY_SETS(N)                                                   \
  case N:                                                                   \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
        blocks, multi_any_hit_kernel<N, F32>, BLOCK, 0);

// Resident blocks per SM of the kernel at S sets (cudaOccupancy...).
extern "C" int multi_any_hit_occupancy(int S, int* blocks) {
  switch (S) {
    OCCUPANCY_SETS(1) OCCUPANCY_SETS(2) OCCUPANCY_SETS(3) OCCUPANCY_SETS(4)
    OCCUPANCY_SETS(5) OCCUPANCY_SETS(6) OCCUPANCY_SETS(7) OCCUPANCY_SETS(8)
    OCCUPANCY_SETS(9) OCCUPANCY_SETS(10) OCCUPANCY_SETS(11)
    OCCUPANCY_SETS(12) OCCUPANCY_SETS(13) OCCUPANCY_SETS(14)
    OCCUPANCY_SETS(15) OCCUPANCY_SETS(16)
  }
  return (int)cudaErrorInvalidValue;
}
