// B4: the density adjoint of the fused permeation chords (B3).
//
// Replaces the TPU kernel audio_raytracer_tpu/ops/pallas/fused.py::
// multi_chord_dens_bwd_kernel (wrapper run_multi_chord_dens_bwd). For each
// primitive p of each type: grad[p] = sum over rays r and sets s of
// gbar[r, s] x chord(r, s, p), the chord counted only where it is valid
// (hit, not behind the ray, p not owned by skips[s], p active), exactly
// the chord B3 sums. Each (ray, primitive) first sums its sets in order.
//
// Design: primitive-parallel. The TPU kernel walked primitives inside a
// ray block and carried its per-primitive sums from one sequential grid
// step to the next; blocks on the card run in no order, so here one
// thread owns one primitive (its row in registers), a block holds
// DENS_THREADS primitives of one type, and grid.y splits the rays into
// spans of RAYS_PER_BLOCK. A block stages RAY_TILE rays at a time (origin,
// directions, inverse directions and cotangents of every set) in shared
// memory, every thread reads the same ray (a broadcast), and the thread
// keeps its sum in a register. At the end each thread adds its sum into
// the output with one atomicAdd: one atomic per (primitive, ray span).
// The order of those atomics varies from run to run, so the result
// varies in the last bits of each sum; the plain version in
// ops/cuda/fused.py sums in yet another order.
//
// Bound on the H100: float32 operations outside the tensor cores, the
// same per (ray, primitive) as B3 (ops/cuda/fused.py::CHORD_OPS), against
// 67 TFLOP/s. Blocks are type-uniform, so the branch on the type never
// splits a warp.

#include "chord.cuh"

#define DENS_THREADS 128
#define RAY_TILE 64
#define RAYS_PER_BLOCK 8192

template <int S>
struct RayTile {
  float o[3][RAY_TILE];
  float d[S][3][RAY_TILE];
  float inv[S][3][RAY_TILE];
  float g[S][RAY_TILE];
};

// Stage rays [base, base + m) of every set in shared memory. Called by
// every thread of the block between two __syncthreads().
template <int S>
__device__ __forceinline__ void load_rays(RayTile<S>& tile,
                                          const float* __restrict__ o,
                                          const float* __restrict__ dirs,
                                          const float* __restrict__ gbar,
                                          int R, int base, int m) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const size_t r = (size_t)base + j;
#pragma unroll
    for (int a = 0; a < 3; ++a) tile.o[a][j] = o[3 * r + a];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = dirs[3 * ((size_t)s * R + r) + a];
        tile.d[s][a][j] = v;
        tile.inv[s][a][j] = safe_inv(v);
      }
      tile.g[s][j] = gbar[r * S + s];
    }
  }
}

// One thread's primitive p of type KIND (0 sphere, 1 AABB, 2 OBB):
// returns its sum over the rays of this block's span.
template <int S, int KIND>
__device__ float dens_sum(RayTile<S>& tile, const float* __restrict__ o,
                          const float* __restrict__ dirs,
                          const float* __restrict__ gbar, int R,
                          const Skips& skips, const float* __restrict__ tab,
                          int n, int p) {
  constexpr int W = KIND == 0 ? SPH_W : (KIND == 1 ? AABB_W : OBB_W);
  constexpr int TGT = KIND == 0 ? 4 : (KIND == 1 ? 7 : 16);
  constexpr int MISS = KIND == 1 ? 6 : (KIND == 2 ? 15 : 0);
  const bool live = p < n;
  float row[W];
#pragma unroll
  for (int k = 0; k < W; ++k) row[k] = live ? tab[(size_t)p * W + k] : 0.0f;
  const int tgt = as_id(row[TGT]);
  const bool ok = live && (KIND == 0 || row[MISS] == 0.0f);
  bool skip[S];
#pragma unroll
  for (int s = 0; s < S; ++s) skip[s] = tgt == skips.v[s];

  const int r_begin = blockIdx.y * RAYS_PER_BLOCK;
  const int r_end = min(R, r_begin + RAYS_PER_BLOCK);
  float acc = 0.0f;
  for (int base = r_begin; base < r_end; base += RAY_TILE) {
    const int m = min(RAY_TILE, r_end - base);
    __syncthreads();
    load_rays<S>(tile, o, dirs, gbar, R, base, m);
    __syncthreads();
    if (!ok) continue;
    for (int j = 0; j < m; ++j) {
      float gd = 0.0f;
      if (KIND == 0) {
        const float ocx = tile.o[0][j] - row[0];
        const float ocy = tile.o[1][j] - row[1];
        const float ocz = tile.o[2][j] - row[2];
        const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - row[3];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const SphereChord c = sphere_chord(ocx, ocy, ocz, cc,
                                             tile.d[s][0][j], tile.d[s][1][j],
                                             tile.d[s][2][j]);
          const bool valid = c.hit && (c.t_exit >= 0.0f) && !skip[s];
          gd = gd + (valid ? c.chord : 0.0f) * tile.g[s][j];
        }
      } else {
        // (bound - origin) terms, in the OBB's local frame for an OBB.
        float mn[3], mx[3];
        if (KIND == 1) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            mn[a] = row[a] - tile.o[a][j];
            mx[a] = row[3 + a] - tile.o[a][j];
          }
        } else {
          float lo[3];
          mat_rotate(row + 6, tile.o[0][j] - row[0], tile.o[1][j] - row[1],
                     tile.o[2][j] - row[2], lo[0], lo[1], lo[2]);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            mn[a] = -row[3 + a] - lo[a];
            mx[a] = row[3 + a] - lo[a];
          }
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float inv[3];
          if (KIND == 1) {
#pragma unroll
            for (int a = 0; a < 3; ++a) inv[a] = tile.inv[s][a][j];
          } else {
            float ld[3];
            mat_rotate(row + 6, tile.d[s][0][j], tile.d[s][1][j],
                       tile.d[s][2][j], ld[0], ld[1], ld[2]);
#pragma unroll
            for (int a = 0; a < 3; ++a) inv[a] = safe_inv(ld[a]);
          }
          const BoxChord c = box_chord(mn, mx, inv);
          const bool valid = c.meet && !skip[s];
          gd = gd + (valid ? c.chord : 0.0f) * tile.g[s][j];
        }
      }
      acc = acc + gd;
    }
  }
  return acc;
}

template <int S>
__global__ void __launch_bounds__(DENS_THREADS)
multi_chord_dens_bwd_kernel(const float* __restrict__ o,
                            const float* __restrict__ dirs,
                            const float* __restrict__ gbar, int R,
                            Skips skips, const float* __restrict__ sph,
                            int ns, const float* __restrict__ aabb, int na,
                            const float* __restrict__ obb, int no, int bs,
                            int ba, float* __restrict__ g_sph,
                            float* __restrict__ g_aabb,
                            float* __restrict__ g_obb) {
  __shared__ RayTile<S> tile;
  // Block-uniform type: bs sphere blocks, then ba AABB blocks, then OBBs.
  const int b = blockIdx.x;
  if (b < bs) {
    const int p = b * DENS_THREADS + threadIdx.x;
    const float acc = dens_sum<S, 0>(tile, o, dirs, gbar, R, skips, sph, ns,
                                     p);
    if (p < ns) atomicAdd(g_sph + p, acc);
  } else if (b < bs + ba) {
    const int p = (b - bs) * DENS_THREADS + threadIdx.x;
    const float acc = dens_sum<S, 1>(tile, o, dirs, gbar, R, skips, aabb, na,
                                     p);
    if (p < na) atomicAdd(g_aabb + p, acc);
  } else {
    const int p = (b - bs - ba) * DENS_THREADS + threadIdx.x;
    const float acc = dens_sum<S, 2>(tile, o, dirs, gbar, R, skips, obb, no,
                                     p);
    if (p < no) atomicAdd(g_obb + p, acc);
  }
}

#define LAUNCH_SETS(N)                                                     \
  case N:                                                                  \
    multi_chord_dens_bwd_kernel<N><<<grid, DENS_THREADS, 0,                \
                                     (cudaStream_t)stream>>>(              \
        o, dirs, gbar, R, sk, sph, ns, aabb, na, obb, no, bs, ba, g_sph,   \
        g_aabb, g_obb);                                                    \
    break;

// Adds the density gradients into g_sph [ns], g_aabb [na] and g_obb [no],
// which the caller zeroes first (a group of more than MAX_SETS sets takes
// one launch per group into the same outputs). dirs: [S, R, 3]; gbar:
// [R, S].
extern "C" int multi_chord_dens_bwd(const float* o, const float* dirs,
                                    const float* gbar, int R, int S,
                                    const int* skips, const float* sph,
                                    int ns, const float* aabb, int na,
                                    const float* obb, int no, float* g_sph,
                                    float* g_aabb, float* g_obb,
                                    void* stream) {
  if (S < 1 || S > MAX_SETS) return (int)cudaErrorInvalidValue;
  const int bs = (ns + DENS_THREADS - 1) / DENS_THREADS;
  const int ba = (na + DENS_THREADS - 1) / DENS_THREADS;
  const int bo = (no + DENS_THREADS - 1) / DENS_THREADS;
  if (R == 0 || bs + ba + bo == 0) RETURN_LAST_ERROR;
  Skips sk;
  for (int s = 0; s < MAX_SETS; ++s) sk.v[s] = s < S ? skips[s] : 0;
  const dim3 grid(bs + ba + bo, (R + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK);
  switch (S) {
    LAUNCH_SETS(1) LAUNCH_SETS(2) LAUNCH_SETS(3) LAUNCH_SETS(4)
    LAUNCH_SETS(5) LAUNCH_SETS(6) LAUNCH_SETS(7) LAUNCH_SETS(8)
    LAUNCH_SETS(9) LAUNCH_SETS(10) LAUNCH_SETS(11) LAUNCH_SETS(12)
    LAUNCH_SETS(13) LAUNCH_SETS(14) LAUNCH_SETS(15) LAUNCH_SETS(16)
  }
  RETURN_LAST_ERROR;
}
