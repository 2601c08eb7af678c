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
// Bound on the H100: float32 operations outside the tensor cores, B1's
// per-(ray, primitive) counts (ops/cuda/kernels.py::OPS, the limit compare
// in place of B1's running-minimum compare) over the primitives each ray
// walks up to its first occluder in scan order; the bytes (rays once, the
// tables once) are small beside them.
//
// What the measurements of the previous design showed (PERF.md; NVIDIA
// H100 80GB HBM3, 700 W power limit): one thread per ray, with a warp
// leaving a tile only when all 32 lanes were resolved, so a warp paid for
// its slowest lane: 32 x the longest walk of a warp's lanes is 4.1 times
// the walks themselves, and the same kernel on the rays sorted by walk ran
// in a quarter of the time. Beside that, per row the skip-target compare,
// a warp vote, the inactive rows and three exact reciprocals per OBB. The
// design:
//
// - Occlusion is an OR over the primitives, so a ray's flag does not
//   depend on the order in which it meets them. The wrapper passes the
//   free rows of ops/cuda/kernels.py::occlusion_tables (active, owned by no
//   skip target, padded to whole tiles): no skip compare, no inactive row.
// - Lane refill over a cyclic tile stream (persistent threads with
//   dynamic ray fetch: Aila and Laine, "Understanding the Efficiency of
//   Ray Traversal on GPUs", HPG 2009). About as many blocks as can be
//   resident stream the free-row tiles round and round through the TMA
//   ring (fields.cuh ring_*). Every SUB rows a lane whose ray is
//   occluded, or has met every row once since it joined, writes its flag
//   and takes a new ray: its warp takes rays CHUNK at a time from one
//   counter per launch, so no block is left with a range of long walks.
// - Once no ray is left to take, at each tile boundary the block's rays
//   still walking move onto its first lanes, so the warps that walk for
//   a few long rays (unoccluded ones walk every row) are few.
// - OBB reciprocals through rcp_newton with one range test per (ray, OBB)
//   (obb_t_newton, as B1), obb_t on the rare ray outside it.
//
// What still holds it back (PERF.md, the same card): a ray that joins
// mid-stream walks a rotation of the scan order, about 1.2 times the
// scan-order walk the bound counts on the headline scene
// (tools/roofline.py::any_hit_rotation), and the last rays of a launch,
// some of which walk every row, run with few lanes beside them.

#include "fields.cuh"

// Rows between two refill points: a lane that resolves idles for the rest
// of its SUB rows.
#define SUB 64
#define FULL_MASK 0xffffffffu

// One lane's ray: the terms every row reads, its index (-1: none) and the
// rows it has still to walk before it has met every row once.
struct Ray {
  float ox, oy, oz, dx, dy, dz, a2, a4, ix, iy, iz, lim;
  int r, left;
  bool occ;
};

// Floats of a parked ray: ox .. lim.
#define PARK_F 12

__device__ __forceinline__ void load_ray(Ray& y, const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const float* __restrict__ limit,
                                         int r, int cycle_rows) {
  y.ox = o[3 * r]; y.oy = o[3 * r + 1]; y.oz = o[3 * r + 2];
  y.dx = d[3 * r]; y.dy = d[3 * r + 1]; y.dz = d[3 * r + 2];
  y.lim = limit[r];
  const float a = y.dx * y.dx + y.dy * y.dy + y.dz * y.dz;
  y.a2 = 2.0f * a;
  y.a4 = 4.0f * a;
  y.ix = safe_inv(y.dx); y.iy = safe_inv(y.dy); y.iz = safe_inv(y.dz);
  y.r = r;
  y.left = cycle_rows;
  y.occ = false;
}

// The rows [0, SUB) of `rows` (type KIND) against the lane's ray.
template <int KIND>
__device__ __forceinline__ void walk_rows(const float* rows, Ray& y) {
  constexpr int W = KIND == 0 ? SPH_W : (KIND == 1 ? AABB_W : OBB_W);
  const bool act = (y.r >= 0) & !y.occ;
  bool occ = false;
#pragma unroll 8
  for (int j = 0; j < SUB; ++j) {
    const float* p = rows + j * W;
    if constexpr (KIND == 0) {
      sphere_t(p, y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, y.a2, y.a4,
               [&](float t) { occ |= t < y.lim; }, act);
    } else if constexpr (KIND == 1) {
      occ |= aabb_t(p, y.ox, y.oy, y.oz, y.ix, y.iy, y.iz) < y.lim;
    } else {
      bool ok;
      float t = obb_t_newton(p, y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, ok);
      if (act & !ok) t = obb_t(p, y.ox, y.oy, y.oz, y.dx, y.dy, y.dz);
      occ |= t < y.lim;
    }
  }
  y.occ |= act & occ;
}

// A lane whose ray is resolved writes its flag and lets the ray go.
__device__ __forceinline__ void retire(Ray& y,
                                       unsigned char* __restrict__ occ_out) {
  if ((y.r >= 0) & (y.occ | (y.left == 0))) {
    occ_out[y.r] = y.occ ? 1 : 0;
    y.r = -1;
  }
}

// Rays a warp takes from the launch's counter at a time.
#define CHUNK 32

// The rays of a warp's last chunk that no lane has taken yet: [begin, end),
// the same in every lane of the warp.
struct Pool {
  int begin, end;
};

// Lanes without a ray take the next rays of their warp's pool; a warp
// whose pool runs short takes the next CHUNK rays of [0, R) from the
// launch's counter (one atomic per CHUNK rays). Called by whole warps.
__device__ __forceinline__ void refill(Ray& y, Pool& pool, int* next, int R,
                                       const float* __restrict__ o,
                                       const float* __restrict__ d,
                                       const float* __restrict__ limit,
                                       int cycle_rows) {
  const unsigned idle = __ballot_sync(FULL_MASK, y.r < 0);
  if (idle == 0) return;
  const int lane = threadIdx.x & 31;
  const int rank = __popc(idle & ((1u << lane) - 1u));
  const int want = __popc(idle);
  const int avail = pool.end - pool.begin;
  int r = rank < avail ? pool.begin + rank : -1;
  if (want > avail) {
    int base = R;
    if (lane == 0 && *(volatile int*)next < R) base = atomicAdd(next, CHUNK);
    base = __shfl_sync(FULL_MASK, base, 0);
    const int end = min(R, base + CHUNK);  // empty once base >= R
    if (rank >= avail && base + (rank - avail) < end) {
      r = base + (rank - avail);
    }
    pool.begin = min(end, base + (want - avail));
    pool.end = end;
  } else {
    pool.begin += want;
  }
  if ((y.r < 0) & (r >= 0)) load_ray(y, o, d, limit, r, cycle_rows);
}

// The block's rays still walking move onto its first lanes (every thread
// calls it; the ray count is the block's). Lanes keep their place in the
// stream: every ray is at the same tile boundary.
__device__ __forceinline__ void pack(Ray& y, int n_walking, int* parked,
                                     float (*park)[BLOCK],
                                     int (*park_i)[BLOCK]) {
  if (y.r >= 0) {
    const int k = atomicAdd(parked, 1);
    const float v[PARK_F] = {y.ox, y.oy, y.oz, y.dx, y.dy, y.dz,
                             y.a2, y.a4, y.ix, y.iy, y.iz, y.lim};
#pragma unroll
    for (int f = 0; f < PARK_F; ++f) park[f][k] = v[f];
    park_i[0][k] = y.r;
    park_i[1][k] = y.left;
  }
  __syncthreads();
  const int i = threadIdx.x;
  y.r = -1;
  y.occ = false;
  if (i < n_walking) {
    y.ox = park[0][i]; y.oy = park[1][i]; y.oz = park[2][i];
    y.dx = park[3][i]; y.dy = park[4][i]; y.dz = park[5][i];
    y.a2 = park[6][i]; y.a4 = park[7][i];
    y.ix = park[8][i]; y.iy = park[9][i]; y.iz = park[10][i];
    y.lim = park[11][i];
    y.r = park_i[0][i];
    y.left = park_i[1][i];
  }
  // The next pack comes after two more barriers.
  if (threadIdx.x == 0) *parked = 0;
}

// s: the free rows of the three type tables (spheres, AABBs, OBBs), each
// padded to whole tiles with rows that never hit; next: the launch's ray
// counter, zero at launch.
__global__ void __launch_bounds__(BLOCK)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ limit, int R, Stream s, int* next,
               unsigned char* __restrict__ occ_out) {
  __shared__ __align__(128) float ring[STAGES * RING_FLOATS];
  __shared__ __align__(8) unsigned long long full[STAGES];
  __shared__ float park[PARK_F][BLOCK];
  __shared__ int park_i[2][BLOCK];
  __shared__ int parked;
  const int T = s.total;
  if (T == 0) {  // no free row: nothing occludes
    for (int r = blockIdx.x * BLOCK + threadIdx.x; r < R;
         r += gridDim.x * BLOCK) {
      occ_out[r] = 0;
    }
    return;
  }
  if (threadIdx.x == 0) parked = 0;
  ring_start(s, ring, full, true);
  const int cycle_rows = T * RING_TILE;
  const int sph_end = s.tiles[0], aabb_end = s.tiles[0] + s.tiles[1];
  Ray y{};
  y.r = -1;
  Pool pool{0, 0};
  int t = 0;  // the tile of this step
  for (int step = 0;; ++step) {
    const float* tile = ring_wait(ring, full, step);
    for (int sub = 0; sub < RING_TILE; sub += SUB) {
      retire(y, occ_out);
      refill(y, pool, next, R, o, d, limit, cycle_rows);
      if (__any_sync(FULL_MASK, (y.r >= 0) & !y.occ)) {
        if (t < sph_end) {
          walk_rows<0>(tile + sub * SPH_W, y);
        } else if (t < aabb_end) {
          walk_rows<1>(tile + sub * AABB_W, y);
        } else {
          walk_rows<2>(tile + sub * OBB_W, y);
        }
      }
      if (y.r >= 0) y.left -= SUB;
    }
    retire(y, occ_out);
    const int walking = __syncthreads_count(y.r >= 0);
    // Once false, stays false: no ray is left to take.
    const bool pool_left = __syncthreads_or(
        (pool.begin < pool.end) | (*(volatile int*)next < R));
    if (walking == 0 && !pool_left) {
      // Let the copies in flight land before the block's memory goes.
      for (int k = step + 1; k < step + STAGES; ++k) ring_wait(ring, full, k);
      break;
    }
    if (!pool_left && walking <= BLOCK - 32) {
      pack(y, walking, &parked, park, park_i);
    }
    ring_refill(s, ring, full, step, (t + STAGES) % T);
    t = t + 1 == T ? 0 : t + 1;
  }
}

static int resident_blocks() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, any_hit_kernel,
                                                  BLOCK, 0);
    n = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n;
}

// limit: [R] float32. sph, aabb, obb: the tables of occlusion_tables for
// this skip target, ns / na / no their free rows (each padded to whole
// RING_TILE tiles in the table). next: one int32, zeroed by the caller.
extern "C" int any_hit(const float* o, const float* d, const float* limit,
                       int R, const float* sph, int ns, const float* aabb,
                       int na, const float* obb, int no, int* next,
                       unsigned char* occ_out, void* stream) {
  if (R > 0) {
    Stream s{};
    stream_add(s, sph, ns, SPH_W);
    stream_add(s, aabb, na, AABB_W);
    stream_add(s, obb, no, OBB_W);
    const int want = (R + BLOCK - 1) / BLOCK;
    const int blocks = want < resident_blocks() ? want : resident_blocks();
    any_hit_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        o, d, limit, R, s, next, occ_out);
  }
  RETURN_LAST_ERROR;
}

// Resident blocks per SM of the kernel (cudaOccupancy...).
extern "C" int any_hit_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, any_hit_kernel, BLOCK, 0);
}
