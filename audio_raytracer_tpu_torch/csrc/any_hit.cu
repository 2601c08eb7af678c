// B6: single-set occlusion, any primitive hit closer than the ray's limit.
//
// Replaces the TPU kernel audio_raytracer_tpu/ops/pallas/kernels.py::
// any_hit_kernel (wrapper run_any_hit), the kernel behind the backend
// protocol's occluded(). Per ray: occluded if any primitive not owned by
// the skip target has t < limit, with B1's per-primitive t (fields.cuh
// sphere_t / aabb_t / obb_t: the full quadratic with a = |d|^2, so the
// direction need not be unit length, and +inf on a miss). B2 at S = 1
// cannot stand in: its sign-domain sphere test needs |d| = 1. A miss is
// +inf, as in the JAX jnp tier, so a ray with limit = +inf is occluded
// only by a real hit; the Pallas kernel's miss value BIG = 3e38 is < inf
// and occludes every such ray.
//
// Design: one thread per ray, primitive rows staged per block in shared
// memory tiles, as B1. A lane stops testing once its ray is occluded: a
// warp whose lanes are all resolved skips the rest of each tile (a warp
// vote per primitive), and a block whose lanes are all resolved leaves
// the primitive stream (a block vote per tile).
//
// Bound on the H100: float32 operations outside the tensor cores, B1's
// per-(ray, primitive) counts (ops/cuda/kernels.py::OPS, the limit compare
// in place of B1's running-minimum compare) over the primitives each ray
// walks up to its first occluder in scan order; the bytes (rays once, the
// tables once) are small beside them.

#include "fields.cuh"

__global__ void __launch_bounds__(BLOCK)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ limit, int R, int skip,
               const float* __restrict__ sph, int ns,
               const float* __restrict__ aabb, int na,
               const float* __restrict__ obb, int no,
               unsigned char* __restrict__ occ_out) {
  __shared__ __align__(16) float tile[TILE * OBB_W];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = r < R;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float lim = 0.f;
  if (in_range) {
    ox = o[3 * r]; oy = o[3 * r + 1]; oz = o[3 * r + 2];
    dx = d[3 * r]; dy = d[3 * r + 1]; dz = d[3 * r + 2];
    lim = limit[r];
  }
  const float a = dx * dx + dy * dy + dz * dz;
  const float a2 = 2.0f * a, a4 = 4.0f * a;
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  bool occ = false;
  bool done = !in_range;  // occluded, or no ray

  // Each tile loop starts with a block vote, which is also the barrier
  // that keeps the previous tile alive until every thread has read it.
  for (int base = 0; base < ns; base += TILE) {
    if (__syncthreads_and(done)) break;
    const int n = min(TILE, ns - base);
    load_tile(tile, sph, base, n, SPH_W);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (__all_sync(0xffffffffu, done)) break;
      const float* p = tile + j * SPH_W;
      if (!done && as_id(p[4]) != skip) {
        sphere_t(p, ox, oy, oz, dx, dy, dz, a2, a4, [&](float t) {
          if (t < lim) occ = done = true;
        });
      }
    }
  }
  for (int base = 0; base < na; base += TILE) {
    if (__syncthreads_and(done)) break;
    const int n = min(TILE, na - base);
    load_tile(tile, aabb, base, n, AABB_W);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (__all_sync(0xffffffffu, done)) break;
      const float* p = tile + j * AABB_W;
      if (!done && as_id(p[7]) != skip &&
          aabb_t(p, ox, oy, oz, ix, iy, iz) < lim) {
        occ = done = true;
      }
    }
  }
  for (int base = 0; base < no; base += TILE) {
    if (__syncthreads_and(done)) break;
    const int n = min(TILE, no - base);
    load_tile(tile, obb, base, n, OBB_W);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (__all_sync(0xffffffffu, done)) break;
      const float* p = tile + j * OBB_W;
      if (!done && as_id(p[16]) != skip &&
          obb_t(p, ox, oy, oz, dx, dy, dz) < lim) {
        occ = done = true;
      }
    }
  }
  if (in_range) occ_out[r] = occ ? 1 : 0;
}

// limit: [R] float32; skip: the target id whose colliders the ray ignores.
extern "C" int any_hit(const float* o, const float* d, const float* limit,
                       int R, int skip, const float* sph, int ns,
                       const float* aabb, int na, const float* obb, int no,
                       unsigned char* occ_out, void* stream) {
  if (R > 0) {
    any_hit_kernel<<<(R + BLOCK - 1) / BLOCK, BLOCK, 0,
                     (cudaStream_t)stream>>>(o, d, limit, R, skip, sph, ns,
                                             aabb, na, obb, no, occ_out);
  }
  RETURN_LAST_ERROR;
}
