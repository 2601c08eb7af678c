// B3: fused permeation chords of S target ray sets that share one origin.
//
// Replaces the TPU kernel audio_raytracer_tpu/ops/pallas/fused.py::
// multi_chord_kernel (wrapper run_multi_chord). Per ray and set s: the sum
// over primitives not owned by skips[s] of
// max(0, t_exit - max(t_enter, 0)) x density along the UNBOUNDED ray
// (Jobs/AudioPermeationJobBatched.cs:225-328). Spheres use the half-b
// quadratic (|d| = 1); inactive spheres carry r2 = -1e30 and never hit;
// inactive boxes are excluded by their miss term (miss != 0). Sums
// accumulate in float32, in scan order.
//
// Design: one thread per ray, S compile-time sets held in registers,
// primitive rows staged per block in shared memory; box tests share the
// per-primitive (bound - origin) terms across sets.
//
// Bound on the H100: float32 operations outside the tensor cores, per
// (ray, primitive): sphere 9 + 18 S, AABB 7 + 23 S, OBB 28 + 44 S
// (ops/cuda/fused.py::CHORD_OPS), against 67 TFLOP/s. On the forward
// frame it runs on one ray per accumulation batch: there a single thread
// walks every primitive, and latency, not work, sets its time.

#include "fields.cuh"

template <int S>
__global__ void __launch_bounds__(BLOCK)
multi_chord_kernel(const float* __restrict__ o, const float* __restrict__ dirs,
                   int R, Skips skips, const float* __restrict__ sph, int ns,
                   const float* __restrict__ aabb, int na,
                   const float* __restrict__ obb, int no,
                   float* __restrict__ out) {
  __shared__ __align__(16) float tile[TILE * OBB_W];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;

  float ox = 0.f, oy = 0.f, oz = 0.f;
  float dx[S], dy[S], dz[S], ix[S], iy[S], iz[S], acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    dx[s] = dy[s] = dz[s] = 0.f;
    acc[s] = 0.f;
  }
  if (live) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t k = 3 * ((size_t)s * R + r);
      dx[s] = dirs[k]; dy[s] = dirs[k + 1]; dz[s] = dirs[k + 2];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    ix[s] = safe_inv(dx[s]); iy[s] = safe_inv(dy[s]); iz[s] = safe_inv(dz[s]);
  }

  for (int base = 0; base < ns; base += TILE) {
    const int n = min(TILE, ns - base);
    __syncthreads();
    load_tile(tile, sph, base, n, SPH_W);
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float* p = tile + j * SPH_W;
        const int tgt = as_id(p[4]);
        const float dens = p[5];
        float ocx = ox - p[0], ocy = oy - p[1], ocz = oz - p[2];
        float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - p[3];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float b = ocx * dx[s] + ocy * dy[s] + ocz * dz[s];
          float disc = b * b - cc;
          bool hit = disc >= 0.0f;
          float sq = sqrtf(hit ? disc : 1.0f);
          float t_exit = -b + sq;
          float enter = fmaxf(-b - sq, 0.0f);
          float chord = fmaxf(0.0f, t_exit - enter);
          bool valid = hit && (t_exit >= 0.0f) && tgt != skips.v[s];
          acc[s] = acc[s] + (valid ? chord : 0.0f) * dens;
        }
      }
    }
  }
  for (int base = 0; base < na; base += TILE) {
    const int n = min(TILE, na - base);
    __syncthreads();
    load_tile(tile, aabb, base, n, AABB_W);
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float* p = tile + j * AABB_W;
        const int tgt = as_id(p[7]);
        const float dens = p[8];
        const bool ok = p[6] == 0.0f;
        float mnx = p[0] - ox, mny = p[1] - oy, mnz = p[2] - oz;
        float mxx = p[3] - ox, mxy = p[4] - oy, mxz = p[5] - oz;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float tn, tf;
          slab(mnx, mny, mnz, mxx, mxy, mxz, ix[s], iy[s], iz[s], tn, tf);
          float chord = fmaxf(0.0f, tf - fmaxf(tn, 0.0f));
          bool valid = (tn <= tf) && (tf >= 0.0f) && tgt != skips.v[s] && ok;
          acc[s] = acc[s] + (valid ? chord : 0.0f) * dens;
        }
      }
    }
  }
  for (int base = 0; base < no; base += TILE) {
    const int n = min(TILE, no - base);
    __syncthreads();
    load_tile(tile, obb, base, n, OBB_W);
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        const float* p = tile + j * OBB_W;
        const int tgt = as_id(p[16]);
        const float dens = p[17];
        const bool ok = p[15] == 0.0f;
        float lox, loy, loz;
        mat_rotate(p + 6, ox - p[0], oy - p[1], oz - p[2], lox, loy, loz);
        float mnx = -p[3] - lox, mny = -p[4] - loy, mnz = -p[5] - loz;
        float mxx = p[3] - lox, mxy = p[4] - loy, mxz = p[5] - loz;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float ldx, ldy, ldz;
          mat_rotate(p + 6, dx[s], dy[s], dz[s], ldx, ldy, ldz);
          float tn, tf;
          slab(mnx, mny, mnz, mxx, mxy, mxz, safe_inv(ldx), safe_inv(ldy),
               safe_inv(ldz), tn, tf);
          float chord = fmaxf(0.0f, tf - fmaxf(tn, 0.0f));
          bool valid = (tn <= tf) && (tf >= 0.0f) && tgt != skips.v[s] && ok;
          acc[s] = acc[s] + (valid ? chord : 0.0f) * dens;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) out[(size_t)r * S + s] = acc[s];
  }
}

#define LAUNCH_SETS(N)                                                   \
  case N:                                                                \
    multi_chord_kernel<N><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(     \
        o, dirs, R, sk, sph, ns, aabb, na, obb, no, out);                \
    break;

extern "C" int multi_chord(const float* o, const float* dirs, int R, int S,
                           const int* skips, const float* sph, int ns,
                           const float* aabb, int na, const float* obb,
                           int no, float* out, void* stream) {
  if (S < 1 || S > MAX_SETS) return (int)cudaErrorInvalidValue;
  if (R == 0) RETURN_LAST_ERROR;
  Skips sk;
  for (int s = 0; s < MAX_SETS; ++s) sk.v[s] = s < S ? skips[s] : 0;
  const int grid = (R + BLOCK - 1) / BLOCK;
  switch (S) {
    LAUNCH_SETS(1) LAUNCH_SETS(2) LAUNCH_SETS(3) LAUNCH_SETS(4)
    LAUNCH_SETS(5) LAUNCH_SETS(6) LAUNCH_SETS(7) LAUNCH_SETS(8)
    LAUNCH_SETS(9) LAUNCH_SETS(10) LAUNCH_SETS(11) LAUNCH_SETS(12)
    LAUNCH_SETS(13) LAUNCH_SETS(14) LAUNCH_SETS(15) LAUNCH_SETS(16)
  }
  RETURN_LAST_ERROR;
}
