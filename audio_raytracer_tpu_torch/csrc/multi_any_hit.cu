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
// Design: one thread per ray, S compile-time sets held in registers,
// primitive rows staged per block in shared memory. A lane whose sets are
// all pre-resolved writes its init bits and skips the loop; a block of
// such lanes skips the tiles. The loop does not stop early when every set
// is occluded: the work is the same for every live lane.
//
// Bound on the H100: float32 operations outside the tensor cores, per
// (live ray, primitive): sphere 10 + 15 S, AABB 6 + 21 S, OBB 27 + 42 S
// (ops/cuda/fused.py::OCC_OPS), against 67 TFLOP/s. S = 1 + T is 5 on
// the headline workload.

#include "fields.cuh"

template <int S>
__global__ void __launch_bounds__(BLOCK)
multi_any_hit_kernel(const float* __restrict__ o,
                     const float* __restrict__ dirs,
                     const float* __restrict__ limits,
                     const unsigned char* __restrict__ init, int R,
                     Skips skips, const float* __restrict__ sph, int ns,
                     const float* __restrict__ aabb, int na,
                     const float* __restrict__ obb, int no,
                     unsigned char* __restrict__ occ_out) {
  __shared__ __align__(16) float tile[TILE * OBB_W];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = r < R;

  float ox = 0.f, oy = 0.f, oz = 0.f;
  float dx[S], dy[S], dz[S], lim[S];
  bool acc[S];
  bool live = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    dx[s] = dy[s] = dz[s] = lim[s] = 0.f;
    acc[s] = true;
  }
  if (in_range) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t k = 3 * ((size_t)s * R + r);
      dx[s] = dirs[k]; dy[s] = dirs[k + 1]; dz[s] = dirs[k + 2];
      lim[s] = limits[(size_t)r * S + s];
      acc[s] = init[(size_t)r * S + s] != 0;
      live |= !acc[s];
    }
  }

  if (__syncthreads_or(live)) {
    float ix[S], iy[S], iz[S];
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
          float ocx = ox - p[0], ocy = oy - p[1], ocz = oz - p[2];
          float c = (ocx * ocx + ocy * ocy + ocz * ocz) - p[3];
          bool c_pos = c >= 0.0f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            float h = ocx * dx[s] + ocy * dy[s] + ocz * dz[s];
            float hl = h + lim[s];
            float q = lim[s] * (hl + h) + c;
            bool entering = c_pos && (h <= 0.0f) && ((hl > 0.0f) || (q < 0.0f));
            bool inside = !c_pos && (hl > 0.0f) && (q > 0.0f);
            bool occ = (h * h >= c) && (entering || inside) && tgt != skips.v[s];
            acc[s] = acc[s] || occ;
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
          float mnx = p[0] - ox, mny = p[1] - oy, mnz = p[2] - oz;
          float mxx = p[3] - ox, mxy = p[4] - oy, mxz = p[5] - oz;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            float tn, tf;
            slab(mnx, mny, mnz, mxx, mxy, mxz, ix[s], iy[s], iz[s], tn, tf);
            float t = slab_hit(tn, tf) + p[6];
            acc[s] = acc[s] || ((t < lim[s]) && tgt != skips.v[s]);
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
            float t = slab_hit(tn, tf) + p[15];
            acc[s] = acc[s] || ((t < lim[s]) && tgt != skips.v[s]);
          }
        }
      }
    }
  }
  if (in_range) {
#pragma unroll
    for (int s = 0; s < S; ++s) occ_out[(size_t)r * S + s] = acc[s] ? 1 : 0;
  }
}

#define LAUNCH_SETS(N)                                                      \
  case N:                                                                   \
    multi_any_hit_kernel<N><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(      \
        o, dirs, limits, init, R, sk, sph, ns, aabb, na, obb, no, occ_out); \
    break;

extern "C" int multi_any_hit(const float* o, const float* dirs,
                             const float* limits, const unsigned char* init,
                             int R, int S, const int* skips,
                             const float* sph, int ns, const float* aabb,
                             int na, const float* obb, int no,
                             unsigned char* occ_out, void* stream) {
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
