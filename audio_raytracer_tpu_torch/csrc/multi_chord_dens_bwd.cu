// B4: the density adjoint of the fused permeation chords (B3).
//
// Replaces the TPU kernel audio_raytracer_tpu/ops/pallas/fused.py::
// multi_chord_dens_bwd_kernel (wrapper run_multi_chord_dens_bwd). For each
// primitive p of each type: grad[p] = sum over rays r and sets s of
// gbar[r, s] x chord(r, s, p), the chord counted only where it is valid
// (hit, not behind the ray, p not owned by skips[s], p active), exactly
// the chord B3 sums. Each (ray, primitive) first sums its sets in order,
// as the plain version does; only the sum over rays runs in another order.
//
// Bound on the H100: float32 operations outside the tensor cores, the
// same per (ray, primitive) as B3 (ops/cuda/fused.py::CHORD_OPS: at S = 4
// 81 per sphere, 99 per AABB, 204 per OBB), over the rays with a nonzero
// cotangent, against the issue ceiling that B9 measures (about 33.3 T
// ops/s on an NVIDIA H100 80GB HBM3 at its 700 W power limit).
//
// What the machine code of the previous design showed (PERF.md; NVIDIA
// H100 80GB HBM3, 700 W power limit): one thread per primitive read every
// ray from shared memory as 19 scalar loads per (ray, primitive) at S = 4
// and issued 166 instructions per sphere (81 counted: per set sqrtf's
// range test, slow-path branch and call), 131 per AABB (99) and 435 per
// OBB (204: per reciprocal nvcc's range test and slow-path branch); issue
// ran at 76-84 % of the ceiling, and rays without a cotangent cost 1.7 %.
// The design:
//
// - Ray records built once per launch by the wrapper (ops/cuda/fused.py::
//   dens_records): a head (origin, live) and per set (d or safe_inv(d),
//   g), one float4 each, so a ray is 1 + S 128-bit shared loads. Spheres
//   and OBBs read the records with d, AABBs those with the inverse
//   directions, computed once per ray instead of once per primitive
//   block. The list is padded to whole tiles with dead records.
// - Records staged by TMA bulk copies into a two-buffer ring of
//   ray_tile(S)-record tiles, one barrier per tile (fields.cuh bulk_load).
// - DENS_K primitives per thread, so each ray read serves DENS_K of them
//   (one and four measured slower than two).
// - OBB reciprocals through rcp_newton and sphere square roots through
//   sqrt_newton, each bit-identical to the exact operation on a range
//   tested once per (ray, primitive) for all sets; a (ray, primitive)
//   outside it recomputes with the exact operations.
// - A ray whose cotangents are all zero (a miss) is skipped: its record's
//   live slot is 0, and every thread of the block reads the same ray, so
//   the branch never splits a warp.
// - The cross-span reduction stays one atomicAdd per (primitive, span):
//   a few hundred thousand atomics against a billion chord terms. Their
//   order varies from run to run, so the result varies in the last bits
//   of each sum.
// Blocks are type-uniform (OBB blocks first, the longest), so the branch
// on the type never splits a warp.
//
// What still holds it back (PERF.md, the same card): the AABB chord is
// mostly compares, min / max and selects (121 of 250 instructions per two
// pairs at S = 4), which issue at about half rate; the OBB and sphere
// loops issue their fast paths at about 65-75 % of the ceiling with 7
// blocks of 128 threads resident (72 registers at S = 4).

#include "chord.cuh"

#define DENS_THREADS 128
#define DENS_K 2
// Records per staged tile; the wrapper pads the record list to a multiple
// of RAY_TILE_PAD (a multiple of every ray_tile()).
#define RAY_TILE_PAD 128

__host__ __device__ constexpr int ray_tile(int S) { return S <= 8 ? 128 : 64; }

// Floats of one ray record: a float4 head and one float4 per set.
__host__ __device__ constexpr int rec_floats(int S) { return 4 * (1 + S); }

// One row's columns that the chord reads (the target id and the miss
// column become `skip` and `ok`).
template <int KIND>
struct Row {
  static constexpr int W = KIND == 0 ? SPH_W : (KIND == 1 ? AABB_W : OBB_W);
  static constexpr int USED = KIND == 0 ? 4 : (KIND == 1 ? 6 : 15);
  static constexpr int TGT = KIND == 0 ? 4 : (KIND == 1 ? 7 : 16);
  static constexpr int MISS = KIND == 1 ? 6 : 15;
};

// gd = sum over sets in order of (valid ? chord : 0) x g for one sphere
// row p against the ray (head h, sets v). FAST: sqrt_newton; clears fast
// where a square root's argument is out of its range.
template <int S, bool FAST>
__device__ __forceinline__ float sphere_gd(const float* p, unsigned skip,
                                           float4 h, const float4* v,
                                           bool& fast) {
  const float ocx = h.x - p[0], ocy = h.y - p[1], ocz = h.z - p[2];
  const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - p[3];
  float gd = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const SphereChord c = sphere_chord<FAST>(ocx, ocy, ocz, cc, v[s].x,
                                             v[s].y, v[s].z, &fast);
    const bool valid = c.hit && (c.t_exit >= 0.0f) && !((skip >> s) & 1u);
    gd = gd + (valid ? c.chord : 0.0f) * v[s].w;
  }
  return gd;
}

// The same for an AABB row; v holds the inverse directions.
template <int S>
__device__ __forceinline__ float aabb_gd(const float* p, unsigned skip,
                                         bool ok, float4 h,
                                         const float4* v) {
  float mn[3], mx[3];
  mn[0] = p[0] - h.x; mn[1] = p[1] - h.y; mn[2] = p[2] - h.z;
  mx[0] = p[3] - h.x; mx[1] = p[4] - h.y; mx[2] = p[5] - h.z;
  float gd = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float inv[3] = {v[s].x, v[s].y, v[s].z};
    const BoxChord c = box_chord(mn, mx, inv);
    const bool valid = c.meet && !((skip >> s) & 1u) && ok;
    gd = gd + (valid ? c.chord : 0.0f) * v[s].w;
  }
  return gd;
}

// The same for an OBB row; v holds the directions. NEWTON: rcp_newton for
// the reciprocals, clearing fast where a local direction component is out
// of rcp_in_range; else safe_inv.
template <int S, bool NEWTON>
__device__ __forceinline__ float obb_gd(const float* p, unsigned skip,
                                        bool ok, float4 h, const float4* v,
                                        bool& fast) {
  float lo[3], mn[3], mx[3];
  mat_rotate(p + 6, h.x - p[0], h.y - p[1], h.z - p[2], lo[0], lo[1],
             lo[2]);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mn[a] = -p[3 + a] - lo[a];
    mx[a] = p[3 + a] - lo[a];
  }
  float gd = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float ld[3], inv[3];
    mat_rotate(p + 6, v[s].x, v[s].y, v[s].z, ld[0], ld[1], ld[2]);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if constexpr (NEWTON) {
        fast &= rcp_in_range(ld[a]);
        inv[a] = rcp_newton(ld[a]);
      } else {
        inv[a] = safe_inv(ld[a]);
      }
    }
    const BoxChord c = box_chord(mn, mx, inv);
    const bool valid = c.meet && !((skip >> s) & 1u) && ok;
    gd = gd + (valid ? c.chord : 0.0f) * v[s].w;
  }
  return gd;
}

// One (ray, primitive) term, with the exact operations where the fast ones
// leave their range.
template <int S, int KIND>
__device__ __forceinline__ float pair_gd(const float* p, unsigned skip,
                                         bool ok, float4 h,
                                         const float4* v) {
  if constexpr (KIND == 1) {
    return aabb_gd<S>(p, skip, ok, h, v);
  } else if constexpr (KIND == 0) {
    bool fast = true;
    float gd = sphere_gd<S, true>(p, skip, h, v, fast);
    if (!fast) gd = sphere_gd<S, false>(p, skip, h, v, fast);
    return gd;
  } else {
    bool fast = true;
    float gd = obb_gd<S, true>(p, skip, ok, h, v, fast);
    if (!fast) gd = obb_gd<S, false>(p, skip, ok, h, v, fast);
    return gd;
  }
}

// This block's DENS_K x DENS_THREADS primitives of type KIND (rows p0 +
// k DENS_THREADS + thread) against the record tiles [tile0, tile0 +
// tiles) of rec; adds each primitive's sum into grad.
template <int S, int KIND>
__device__ __forceinline__ void dens_block(const float* __restrict__ rec,
                                           int tile0, int tiles,
                                           const Skips& skips,
                                           const float* __restrict__ tab,
                                           int n, int p0,
                                           float* __restrict__ grad,
                                           float* ring,
                                           unsigned long long* full) {
  using RowT = Row<KIND>;
  constexpr int RT = ray_tile(S);
  constexpr int REC = rec_floats(S);
  constexpr unsigned TILE_BYTES = RT * REC * sizeof(float);
  float row[DENS_K][RowT::USED];
  unsigned skip[DENS_K];
  bool ok[DENS_K];
  float acc[DENS_K];
#pragma unroll
  for (int k = 0; k < DENS_K; ++k) {
    const int p = p0 + k * DENS_THREADS + threadIdx.x;
    const bool live = p < n;
#pragma unroll
    for (int c = 0; c < RowT::USED; ++c) {
      row[k][c] = live ? tab[(size_t)p * RowT::W + c] : 0.0f;
    }
    const int tgt = live ? as_id(tab[(size_t)p * RowT::W + RowT::TGT]) : 0;
    ok[k] = live && (KIND == 0 || tab[(size_t)p * RowT::W + RowT::MISS] ==
                                      0.0f);
    skip[k] = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) skip[k] |= (unsigned)(tgt == skips.v[s]) << s;
    acc[k] = 0.0f;
  }

  if (threadIdx.x == 0) {
    bars_init(full, STAGES);
    for (int t = 0; t < STAGES && t < tiles; ++t) {
      bulk_load(ring + t * RT * REC, rec + (size_t)(tile0 + t) * RT * REC,
                TILE_BYTES, full + t);
    }
  }
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int b = t % STAGES;
    bar_wait(full + b, (t / STAGES) & 1);
    const float4* buf = reinterpret_cast<const float4*>(ring + b * RT * REC);
#pragma unroll 1
    for (int j = 0; j < RT; ++j) {
      const float4* r = buf + j * (1 + S);
      const float4 h = r[0];
      if (h.w == 0.0f) continue;  // no cotangent: every thread skips
      float4 v[S];
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = r[1 + s];
#pragma unroll
      for (int k = 0; k < DENS_K; ++k) {
        acc[k] = acc[k] + pair_gd<S, KIND>(row[k], skip[k], ok[k], h, v);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && t + STAGES < tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(ring + b * RT * REC,
                rec + (size_t)(tile0 + t + STAGES) * RT * REC, TILE_BYTES,
                full + b);
    }
  }
#pragma unroll
  for (int k = 0; k < DENS_K; ++k) {
    const int p = p0 + k * DENS_THREADS + threadIdx.x;
    if (p < n) atomicAdd(grad + p, acc[k]);
  }
}

// grid.x: bo OBB blocks, then ba AABB blocks, then the sphere blocks;
// grid.y: spans of span_tiles record tiles out of `tiles`.
template <int S>
__global__ void __launch_bounds__(DENS_THREADS)
multi_chord_dens_bwd_kernel(const float* __restrict__ rec_d,
                            const float* __restrict__ rec_inv, int tiles,
                            int span_tiles, Skips skips,
                            const float* __restrict__ sph, int ns,
                            const float* __restrict__ aabb, int na,
                            const float* __restrict__ obb, int no, int bo,
                            int ba, float* __restrict__ g_sph,
                            float* __restrict__ g_aabb,
                            float* __restrict__ g_obb) {
  __shared__ __align__(128) float ring[STAGES * ray_tile(S) * rec_floats(S)];
  __shared__ __align__(8) unsigned long long full[STAGES];
  constexpr int PB = DENS_K * DENS_THREADS;
  const int tile0 = blockIdx.y * span_tiles;
  const int n_tiles = min(span_tiles, tiles - tile0);
  const int b = blockIdx.x;
  if (b < bo) {
    dens_block<S, 2>(rec_d, tile0, n_tiles, skips, obb, no, b * PB, g_obb,
                     ring, full);
  } else if (b < bo + ba) {
    dens_block<S, 1>(rec_inv, tile0, n_tiles, skips, aabb, na,
                     (b - bo) * PB, g_aabb, ring, full);
  } else {
    dens_block<S, 0>(rec_d, tile0, n_tiles, skips, sph, ns,
                     (b - bo - ba) * PB, g_sph, ring, full);
  }
}

static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

#define LAUNCH_SETS(N)                                                     \
  case N: {                                                                \
    const int tiles = R / ray_tile(N);                                     \
    int spans = (32 * sm_count() + blocks - 1) / blocks;                   \
    spans = spans < 1 ? 1 : (spans > tiles ? tiles : spans);               \
    const int span_tiles = (tiles + spans - 1) / spans;                    \
    spans = (tiles + span_tiles - 1) / span_tiles;                         \
    multi_chord_dens_bwd_kernel<N><<<dim3(blocks, spans), DENS_THREADS, 0, \
                                     (cudaStream_t)stream>>>(              \
        rec_d, rec_inv, tiles, span_tiles, sk, sph, ns, aabb, na, obb, no, \
        bo, ba, g_sph, g_aabb, g_obb);                                     \
    break;                                                                 \
  }

// Adds the density gradients into g_sph [ns], g_aabb [na] and g_obb [no],
// which the caller zeroes first (a group of more than MAX_SETS sets takes
// one launch per group into the same outputs). rec_d, rec_inv: [R, 1 + S]
// float4 ray records (head (o, live), then per set (d, g) or (safe_inv(d),
// g)), R a multiple of RAY_TILE_PAD, 16-byte aligned.
extern "C" int multi_chord_dens_bwd(const float* rec_d, const float* rec_inv,
                                    int R, int S, const int* skips,
                                    const float* sph, int ns,
                                    const float* aabb, int na,
                                    const float* obb, int no, float* g_sph,
                                    float* g_aabb, float* g_obb,
                                    void* stream) {
  if (S < 1 || S > MAX_SETS || R % RAY_TILE_PAD) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int PB = DENS_K * DENS_THREADS;
  const int bs = (ns + PB - 1) / PB;
  const int ba = (na + PB - 1) / PB;
  const int bo = (no + PB - 1) / PB;
  const int blocks = bs + ba + bo;
  if (R == 0 || blocks == 0) RETURN_LAST_ERROR;
  Skips sk;
  for (int s = 0; s < MAX_SETS; ++s) sk.v[s] = s < S ? skips[s] : 0;
  switch (S) {
    LAUNCH_SETS(1) LAUNCH_SETS(2) LAUNCH_SETS(3) LAUNCH_SETS(4)
    LAUNCH_SETS(5) LAUNCH_SETS(6) LAUNCH_SETS(7) LAUNCH_SETS(8)
    LAUNCH_SETS(9) LAUNCH_SETS(10) LAUNCH_SETS(11) LAUNCH_SETS(12)
    LAUNCH_SETS(13) LAUNCH_SETS(14) LAUNCH_SETS(15) LAUNCH_SETS(16)
  }
  RETURN_LAST_ERROR;
}

#define OCCUPANCY_SETS(N)                                                   \
  case N:                                                                   \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(              \
        blocks, multi_chord_dens_bwd_kernel<N>, DENS_THREADS, 0);

// Resident blocks per SM of the kernel at S sets (cudaOccupancy...).
extern "C" int multi_chord_dens_bwd_occupancy(int S, int* blocks) {
  switch (S) {
    OCCUPANCY_SETS(1) OCCUPANCY_SETS(2) OCCUPANCY_SETS(3) OCCUPANCY_SETS(4)
    OCCUPANCY_SETS(5) OCCUPANCY_SETS(6) OCCUPANCY_SETS(7) OCCUPANCY_SETS(8)
    OCCUPANCY_SETS(9) OCCUPANCY_SETS(10) OCCUPANCY_SETS(11)
    OCCUPANCY_SETS(12) OCCUPANCY_SETS(13) OCCUPANCY_SETS(14)
    OCCUPANCY_SETS(15) OCCUPANCY_SETS(16)
  }
  return (int)cudaErrorInvalidValue;
}

// sqrt_newton against sqrtf on every float32 x in sqrt_in_range: adds to
// *count the number whose bits differ and to *tested the number compared.
__global__ void sqrt_mismatch_kernel(unsigned long long* count,
                                     unsigned long long* tested) {
  const unsigned long long stride =
      (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long n = 0, m = 0;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float((unsigned)i);
    if (sqrt_in_range(x)) {
      n += __float_as_uint(sqrt_newton(x)) != __float_as_uint(sqrtf(x));
      m += 1;
    }
  }
  atomicAdd(count, n);
  atomicAdd(tested, m);
}

extern "C" int sqrt_mismatches(unsigned long long* count,
                               unsigned long long* tested, void* stream) {
  sqrt_mismatch_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(count,
                                                               tested);
  RETURN_LAST_ERROR;
}
