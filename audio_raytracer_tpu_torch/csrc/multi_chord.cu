// B3: fused permeation chords of S target ray sets that share one origin.
//
// Replaces the TPU kernel audio_raytracer_tpu/ops/pallas/fused.py::
// multi_chord_kernel (wrapper run_multi_chord). Per ray and set s: the sum
// over primitives not owned by skips[s] of
// max(0, t_exit - max(t_enter, 0)) x density along the UNBOUNDED ray
// (Jobs/AudioPermeationJobBatched.cs:225-328). Spheres use the half-b
// quadratic (|d| = 1); inactive spheres carry r2 = -1e30 and never hit;
// inactive boxes are excluded by their miss term (miss != 0). Sums
// accumulate in float32.
//
// Bound on the H100: float32 operations outside the tensor cores, per
// (ray, primitive): sphere 9 + 18 S, AABB 7 + 23 S, OBB 28 + 44 S
// (ops/cuda/fused.py::CHORD_OPS), against 67 TFLOP/s. Both launch shapes
// below do exactly this arithmetic per (ray, primitive, set), through the
// same row functions; they differ in who walks which rows and in the
// order of the sums.
//
// The host picks the shape (ops/cuda/fused.py::chord_splits) as (G, K):
// G rays per block of BLOCK threads, K blocks per group of G rays.
//
// Many rays, (G, K) = (BLOCK, 1): multi_chord_kernel. One thread per ray,
// S compile-time sets in registers, primitive rows staged per block in
// TILE-row tiles of shared memory; box tests share the per-primitive
// (bound - origin) terms across sets. Each ray sums in scan order. The
// training step's 1,048,576 rays take it below the tree path's rule.
//
// Many rays over many rows, float32: the tree path, multi_chord_kernel<S,
// COUNT>, where ops/cuda/fused.py::takes_chord_bvh holds (B1's tree rule,
// ops/cuda/kernels.py::takes_bvh, and at least CHORD_BVH_MIN_RAYS rays).
// An unbounded ray through a scene of thousands of rows crosses a few of
// them, so nearly all of the tiled kernel's (ray, primitive, set) terms
// are zeros added to a sum. Here one thread per (ray, set) walks B1's tree
// (closest_hit.cu; bvh.cuh), rebuilt on the card at every refill, and
// tests only the rows of the leaves it enters, by the row functions
// below, so each term has the tiled kernel's bits. No node is culled by t:
// a node is entered wherever the ray meets its widened box at t >= 0, and
// the margin that makes B1's boxes hold every hit it can compute
// (closest_hit.cu, "Conservative boxes") holds every chord B3 can compute:
// the boxes' slabs are B1's arithmetic, and the sphere's half-b quadratic
// at |d| = 1 rounds fewer times than B1's full one (the CPU tests check
// every crossing's chain of nodes, tests/test_torch_chord_bvh.py). The
// tiled kernel adds every row's term in scan order, and adding +0 or -0
// leaves a sum's bits as they are (a sum that starts at +0 never reaches
// -0), so the tree path adds the nonzero terms in ascending rank: a
// (ray, set) keeps its crossings in a short rank-sorted list in registers
// and walks again for the ranks above the list where it overflowed. Same
// bits as the tiled kernel at (BLOCK, 1), on every ray and set of finite
// densities (a non-finite density makes every tiled sum that scans its
// row non-finite, crossed or not). What bounds it is each step's
// dependent 48-byte node read and the divergence of a warp's walks, as
// for B1's tree: in the rays' own order a warp's 32 first-hit points lie
// all around the scene (consecutive Fibonacci rays), so the kernel takes
// the rays in the Morton order of their origins (one torch.sort a call),
// which cut its time 3.5x at the materials step's shape (PERF.md).
//
// Few rays: multi_chord_split_kernel. At one ray (the forward frame's
// permeation batch) the kernel above runs one thread on one SM and walks
// every primitive in turn, so the walk's latency sets its time. Here the
// scan-order rows (spheres, then AABBs, then OBBs) are cut into K
// contiguous chunks, one per block of a thread-block cluster; a block
// holds G rays x L = BLOCK / G lanes; the block stages its chunk's rows
// in TILE-row tiles of shared memory, as the kernel above does, and lane
// l of a ray takes rows l, l + L, ... of each tile. The sums run
// in a fixed order: a warp-shuffle tree over a ray's lanes, the ray's
// warps in order through shared memory, then block rank 0 adds the
// cluster's blocks in rank order through distributed shared memory. Two
// launches give the same bits; there are no atomics and no global
// scratch, so two streams may run it at once.
//
// The bfloat16 tier (the JAX wrapper's dtype=jnp.bfloat16) is both
// kernels at C = BF16 (multi_chord_bf16), in the same launch shapes: the
// rounding points of the JAX tier (fields.cuh, "Compute types"); a
// sphere's |oc|^2 - r2 is taken in bfloat16 and widened, as the JAX
// kernel takes it, the chords and their sums are float32.

#include <cooperative_groups.h>

#include "bvh.cuh"

namespace cg = cooperative_groups;

// Most blocks in one cluster (non-portable; 8 is portable).
#define MAX_CLUSTER 16
// Cards a process may launch B3's cluster split on.
#define MAX_DEVICES 64

// One ray's S sets in the compute type C (fields.cuh): the shared origin,
// each set's direction and inverse direction (rounded to C on entry) and
// skip target.
template <int S, class C>
struct RaySets {
  using T = typename C::T;
  T ox, oy, oz;
  T dx[S], dy[S], dz[S], ix[S], iy[S], iz[S];
  int skip[S];

  __device__ __forceinline__ RaySets(const float* __restrict__ o,
                                     const float* __restrict__ dirs, int R,
                                     int r, bool live, const Skips& skips) {
    float fo[3] = {0.f, 0.f, 0.f};
    if (live) {
      fo[0] = o[3 * r]; fo[1] = o[3 * r + 1]; fo[2] = o[3 * r + 2];
    }
    ox = C::ld(fo[0]); oy = C::ld(fo[1]); oz = C::ld(fo[2]);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float fd[3] = {0.f, 0.f, 0.f};
      skip[s] = skips.v[s];
      if (live) {
        const size_t k = 3 * ((size_t)s * R + r);
        fd[0] = dirs[k]; fd[1] = dirs[k + 1]; fd[2] = dirs[k + 2];
      }
      dx[s] = C::ld(fd[0]); dy[s] = C::ld(fd[1]); dz[s] = C::ld(fd[2]);
      ix[s] = inv_dir<C>(dx[s]); iy[s] = inv_dir<C>(dy[s]);
      iz[s] = inv_dir<C>(dz[s]);
    }
  }
};

// Add one sphere row p to acc. |oc|^2 - r2 is taken in C and widened, b
// is summed in C and widened; the quadratic and the chord are float32.
template <int S, class C>
__device__ __forceinline__ void sphere_row(const float* p,
                                           const RaySets<S, C>& q,
                                           float (&acc)[S]) {
  using T = typename C::T;
  const int tgt = as_id(p[4]);
  const float dens = p[5];
  const T ocx = C::sub(q.ox, C::ld(p[0])), ocy = C::sub(q.oy, C::ld(p[1])),
          ocz = C::sub(q.oz, C::ld(p[2]));
  const float cc =
      C::up(C::sub(dot3<C>(ocx, ocy, ocz, ocx, ocy, ocz), C::ld(p[3])));
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float b = C::up(dot3<C>(ocx, ocy, ocz, q.dx[s], q.dy[s], q.dz[s]));
    float disc = b * b - cc;
    bool hit = disc >= 0.0f;
    float sq = sqrtf(hit ? disc : 1.0f);
    float t_exit = -b + sq;
    float enter = fmaxf(-b - sq, 0.0f);
    float chord = fmaxf(0.0f, t_exit - enter);
    bool valid = hit && (t_exit >= 0.0f) && tgt != q.skip[s];
    acc[s] = acc[s] + (valid ? chord : 0.0f) * dens;
  }
}

// Add one AABB row p to acc.
template <int S, class C>
__device__ __forceinline__ void aabb_row(const float* p,
                                         const RaySets<S, C>& q,
                                         float (&acc)[S]) {
  using T = typename C::T;
  const int tgt = as_id(p[7]);
  const float dens = p[8];
  const bool ok = p[6] == 0.0f;
  const T mnx = field_minus<C>(p[0], q.ox), mny = field_minus<C>(p[1], q.oy),
          mnz = field_minus<C>(p[2], q.oz);
  const T mxx = field_minus<C>(p[3], q.ox), mxy = field_minus<C>(p[4], q.oy),
          mxz = field_minus<C>(p[5], q.oz);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float tn, tf;
    slab<C>(mnx, mny, mnz, mxx, mxy, mxz, q.ix[s], q.iy[s], q.iz[s], tn, tf);
    float chord = fmaxf(0.0f, tf - fmaxf(tn, 0.0f));
    bool valid = (tn <= tf) && (tf >= 0.0f) && tgt != q.skip[s] && ok;
    acc[s] = acc[s] + (valid ? chord : 0.0f) * dens;
  }
}

// Add one OBB row p to acc.
template <int S, class C>
__device__ __forceinline__ void obb_row(const float* p,
                                        const RaySets<S, C>& q,
                                        float (&acc)[S]) {
  using T = typename C::T;
  const int tgt = as_id(p[16]);
  const float dens = p[17];
  const bool ok = p[15] == 0.0f;
  T mn[3], mx[3];
  obb_terms<C>(p, q.ox, q.oy, q.oz, mn, mx);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T ldx, ldy, ldz;
    mat_rotate<C>(p + 6, q.dx[s], q.dy[s], q.dz[s], ldx, ldy, ldz);
    float tn, tf;
    slab<C>(mn[0], mn[1], mn[2], mx[0], mx[1], mx[2], inv_dir<C>(ldx),
            inv_dir<C>(ldy), inv_dir<C>(ldz), tn, tf);
    float chord = fmaxf(0.0f, tf - fmaxf(tn, 0.0f));
    bool valid = (tn <= tf) && (tf >= 0.0f) && tgt != q.skip[s] && ok;
    acc[s] = acc[s] + (valid ? chord : 0.0f) * dens;
  }
}

template <int S, class C>
__global__ void __launch_bounds__(BLOCK)
multi_chord_kernel(const float* __restrict__ o, const float* __restrict__ dirs,
                   int R, Skips skips, const float* __restrict__ sph, int ns,
                   const float* __restrict__ aabb, int na,
                   const float* __restrict__ obb, int no,
                   float* __restrict__ out) {
  __shared__ __align__(16) float tile[TILE * OBB_W];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;
  const RaySets<S, C> q(o, dirs, R, r, live, skips);
  float acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.f;

  for (int base = 0; base < ns; base += TILE) {
    const int n = min(TILE, ns - base);
    __syncthreads();
    load_tile(tile, sph, base, n, SPH_W);
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        sphere_row<S, C>(tile + j * SPH_W, q, acc);
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
        aabb_row<S, C>(tile + j * AABB_W, q, acc);
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
        obb_row<S, C>(tile + j * OBB_W, q, acc);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) out[(size_t)r * S + s] = acc[s];
  }
}

// ---------------------------------------------------------------------------
// The tree path: B1's bounding-volume hierarchy, unbounded rays
// ---------------------------------------------------------------------------

// Threads a block of the tree kernel.
#define CHORD_BVH_BLOCK 128
// Crossings a (ray, set) holds in rank order through one walk.
#define CHORD_LIST 16

// The W floats of a table row from device memory (16-byte aligned rows).
template <int W>
__device__ __forceinline__ void load_row(const float* src, float (&p)[W]) {
#pragma unroll
  for (int v = 0; v < W / 4; ++v) {
    const float4 x = ldg4(src + 4 * v);
    p[4 * v] = x.x; p[4 * v + 1] = x.y;
    p[4 * v + 2] = x.z; p[4 * v + 3] = x.w;
  }
}

// The term (chord x density) of scan rank `rank` for the one set of q, by
// the tiled kernel's row functions: +0 plus that kernel's term, the same
// bits once added to a sum that is not -0. A rank past the tables is 0.
__device__ __forceinline__ float rank_term(const Bvh& b, int rank,
                                           const RaySets<1, F32>& q) {
  float acc[1] = {0.0f};
  if (rank < b.ns) {
    float p[SPH_W];
    load_row(b.sph + (size_t)rank * SPH_W, p);
    sphere_row<1, F32>(p, q, acc);
  } else if (rank < b.na_end) {
    float p[AABB_W];
    load_row(b.aabb + (size_t)(rank - b.ns) * AABB_W, p);
    aabb_row<1, F32>(p, q, acc);
  } else if (rank < b.total) {
    float p[OBB_W];
    load_row(b.obb + (size_t)(rank - b.na_end) * OBB_W, p);
    obb_row<1, F32>(p, q, acc);
  }
  return acc[0];
}

// One walk of the tree for one (ray, set), with no upper t: every node
// whose widened box the ray meets at some t >= 0 is entered, the left
// child first. A pending right child is one bit of `pend`, at its depth,
// so the walk keeps no stack: the deepest pending bit names the next node,
// the right sibling of the current node's ancestor at that depth. Keeps in
// (rk, tm) the CHORD_LIST least ranks above lo whose term is not zero,
// ascending (INT_MAX and +0 past them); returns whether it dropped one
// more. COUNT adds the nodes entered (leaves included) to nodes and the
// rows tested to tests.
template <bool COUNT>
__device__ __forceinline__ bool walk_terms(const Bvh& b, const NodeRay& nr,
                                           const RaySets<1, F32>& q, int lo,
                                           int (&rk)[CHORD_LIST],
                                           float (&tm)[CHORD_LIST],
                                           int& nodes, int& tests) {
#pragma unroll
  for (int i = 0; i < CHORD_LIST; ++i) {
    rk[i] = 0x7fffffff;
    tm[i] = 0.0f;
  }
  bool dropped = false;
  const int inner = b.leaves - 1;
  unsigned pend = 0;
  int node = 0, depth = 0;
  while (true) {
    if (node < inner) {
      if (COUNT) ++nodes;
      float4 c0, c1, c2;
      record(b, node + 1, c0, c1, c2);
      float ta, tb;
      const bool ea =
          box_enter(nr, c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, INFINITY, ta);
      const bool eb =
          box_enter(nr, c1.z, c1.w, c2.x, c2.y, c2.z, c2.w, INFINITY, tb);
      if (ea | eb) {
        ++depth;
        pend |= (unsigned)(ea & eb) << depth;
        node = 2 * node + (ea ? 1 : 2);
        continue;
      }
    } else {
      if (COUNT) ++nodes;
      const int rank = __ldg(b.slot + node - inner);
      if (rank > lo) {
        if (COUNT) ++tests;
        const float t = rank_term(b, rank, q);
        if (t != 0.0f) {  // a NaN too
          // Insert by rank; the largest falls off the end.
          int cr = rank;
          float ct = t;
#pragma unroll
          for (int i = 0; i < CHORD_LIST; ++i) {
            const bool sw = cr < rk[i];
            const int r0 = rk[i];
            const float t0 = tm[i];
            rk[i] = sw ? cr : r0;
            tm[i] = sw ? ct : t0;
            cr = sw ? r0 : cr;
            ct = sw ? t0 : ct;
          }
          dropped |= cr != 0x7fffffff;
        }
      }
    }
    if (pend == 0) break;
    const int l = 31 - __clz(pend);
    pend ^= 1u << l;
    node = (node + 1) >> (depth - l);
    depth = l;
  }
  return dropped;
}

// B3 through the tree, one thread per (ray, set): warp w takes set w % S
// of rays order[32 (w / S)] .. order[32 (w / S) + 31], so a block's
// warps share their rays' origins, and in the Morton order of the origins
// (ops/cuda/fused.py::ray_order) a warp's walks toward one target share
// most of their nodes. A (ray, set) adds its crossings' terms in rank
// order, the tiled kernel's order; where a walk dropped a crossing it
// walks again for the ranks above the last it added. COUNT (the
// diagnostic) writes visits[4 (r S + s) ..] the nodes entered, the rows
// tested, the terms added and the walks after the first.
template <int S, bool COUNT>
__global__ void __launch_bounds__(CHORD_BVH_BLOCK)
multi_chord_kernel(const float* __restrict__ o, const float* __restrict__ dirs,
                   int R, Skips skips, Bvh bvh,
                   const long long* __restrict__ order,
                   float* __restrict__ out, int* __restrict__ visits) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int s = w % S;
  const int i = (w / S) * 32 + threadIdx.x % 32;
  if (i >= R) return;
  const int r = (int)order[i];
  Skips one;
  one.v[0] = skips.v[s];
  const RaySets<1, F32> q(o, dirs + (size_t)3 * s * R, R, r, true, one);
  float acc = 0.0f;
  int nodes = 0, tests = 0, terms = 0, walks = 0;
  NodeRay nr;
  if (node_ray(bvh, q.ox, q.oy, q.oz, q.ix[0], q.iy[0], q.iz[0], INFINITY,
               nr)) {
    int lo = -1;
    bool more = true;
    while (more) {
      int rk[CHORD_LIST];
      float tm[CHORD_LIST];
      more = walk_terms<COUNT>(bvh, nr, q, lo, rk, tm, nodes, tests);
#pragma unroll
      for (int i = 0; i < CHORD_LIST; ++i) {
        acc = acc + tm[i];
        if (COUNT) terms += rk[i] != 0x7fffffff;
      }
      lo = rk[CHORD_LIST - 1];
      ++walks;
    }
  }
  out[(size_t)r * S + s] = acc;
  if (COUNT) {
    int* v = visits + 4 * ((size_t)r * S + s);
    v[0] = nodes;
    v[1] = tests;
    v[2] = terms;
    v[3] = max(walks - 1, 0);
  }
}

// Rows [a, b) of one type's table of width W: staged TILE rows at a time
// in shared memory, lane l of a ray taking rows l, l + L, ... of each
// tile. Every thread of the block calls it (a and b are the block's).
template <int W, class Row>
__device__ __forceinline__ void walk_rows(float* tile, const float* tab,
                                          int a, int b, int lane, int L,
                                          bool live, Row&& row) {
  for (int base = a; base < b; base += TILE) {
    const int n = min(TILE, b - base);
    __syncthreads();
    load_tile(tile, tab, base, n, W);
    __syncthreads();
    if (live) {
      for (int j = lane; j < n; j += L) row(tile + j * W);
    }
  }
}

// Launched in clusters of K blocks along x: the blocks of cluster c hold
// rays c G .. c G + G - 1, block rank k the rows
// [k rows / K, (k + 1) rows / K) of the scan order (rows = ns + na + no;
// ops/cuda/fused.py::chord_chunks).
template <int S, class C>
__global__ void __launch_bounds__(BLOCK)
multi_chord_split_kernel(const float* __restrict__ o,
                         const float* __restrict__ dirs, int R, Skips skips,
                         const float* __restrict__ sph, int ns,
                         const float* __restrict__ aabb, int na,
                         const float* __restrict__ obb, int no, int G, int K,
                         float* __restrict__ out) {
  __shared__ __align__(16) float tile[TILE * OBB_W];
  __shared__ float warp_part[BLOCK / 32][S];
  __shared__ float ray_part[BLOCK][S];
  const int L = BLOCK / G;
  const int g = threadIdx.x / L, lane = threadIdx.x % L;
  const int rank = blockIdx.x % K;
  const int r = (blockIdx.x / K) * G + g;
  const bool live = r < R;
  const RaySets<S, C> q(o, dirs, R, r, live, skips);
  float acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.f;

  const int rows = ns + na + no;
  const int lo = (int)((long long)rank * rows / K);
  const int hi = (int)((long long)(rank + 1) * rows / K);
  walk_rows<SPH_W>(tile, sph, max(lo, 0), min(hi, ns), lane, L, live,
                   [&](const float* p) { sphere_row<S, C>(p, q, acc); });
  walk_rows<AABB_W>(tile, aabb, max(lo, ns) - ns, min(hi, ns + na) - ns,
                    lane, L, live,
                    [&](const float* p) { aabb_row<S, C>(p, q, acc); });
  walk_rows<OBB_W>(tile, obb, max(lo, ns + na) - ns - na, hi - ns - na,
                   lane, L, live,
                   [&](const float* p) { obb_row<S, C>(p, q, acc); });

  // A ray's lanes within a warp: a shuffle tree, the sum in the ray's
  // first lane (of each warp, where a ray spans several).
  const int width = min(L, 32);
  for (int off = width / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc[s] += __shfl_down_sync(0xffffffffu, acc[s], off, width);
    }
  }
  // A ray's warps, in order.
  if (L > 32) {
    const int warp = threadIdx.x / 32, per_ray = L / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) warp_part[warp][s] = acc[s];
    }
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        acc[s] = warp_part[g * per_ray][s];
        for (int w = 1; w < per_ray; ++w) {
          acc[s] += warp_part[g * per_ray + w][s];
        }
      }
    }
  }
  if (K == 1) {
    if (lane == 0 && live) {
#pragma unroll
      for (int s = 0; s < S; ++s) out[(size_t)r * S + s] = acc[s];
    }
    return;
  }
  // The cluster's blocks, in rank order, by block rank 0; the second sync
  // keeps every block's shared memory alive until rank 0 has read it.
  cg::cluster_group cluster = cg::this_cluster();
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) ray_part[g][s] = acc[s];
  }
  cluster.sync();
  if (rank == 0 && lane == 0 && live) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float t = ray_part[g][s];
      for (int k = 1; k < K; ++k) {
        t += cluster.map_shared_rank(&ray_part[g][s], k)[0];
      }
      out[(size_t)r * S + s] = t;
    }
  }
  cluster.sync();
}

template <int S, class C>
static cudaError_t launch(const float* o, const float* dirs, int R,
                          const Skips& sk, const float* sph, int ns,
                          const float* aabb, int na, const float* obb, int no,
                          int G, int K, float* out, cudaStream_t stream) {
  if (G == BLOCK && K == 1) {
    multi_chord_kernel<S, C><<<(R + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
        o, dirs, R, sk, sph, ns, aabb, na, obb, no, out);
    return cudaGetLastError();
  }
  const long long blocks = (long long)((R + G - 1) / G) * K;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = multi_chord_split_kernel<S, C>;
  if (K > 8) {
    // Set once per card and instantiation, at its first launch: a
    // captured frame (models/frame_graph.py) follows an eager warm-up,
    // so no attribute call falls inside a CUDA graph capture.
    static bool allowed[MAX_DEVICES] = {};
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!allowed[device]) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
      allowed[device] = true;
    }
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, o, dirs, R, sk, sph, ns, aabb, na,
                            obb, no, G, K, out);
}

#define LAUNCH_SETS(N)                                                   \
  case N:                                                                \
    err = launch<N, C>(o, dirs, R, sk, sph, ns, aabb, na, obb, no, G, K, \
                       out, (cudaStream_t)stream);                       \
    break;

template <class C>
static int launch_sets(const float* o, const float* dirs, int R, int S,
                       const int* skips, const float* sph, int ns,
                       const float* aabb, int na, const float* obb, int no,
                       int G, int K, float* out, void* stream) {
  if (S < 1 || S > MAX_SETS || G < 1 || G > BLOCK || BLOCK % G || K < 1 ||
      K > MAX_CLUSTER) {
    return (int)cudaErrorInvalidValue;
  }
  if (R == 0) RETURN_LAST_ERROR;
  Skips sk;
  for (int s = 0; s < MAX_SETS; ++s) sk.v[s] = s < S ? skips[s] : 0;
  cudaError_t err = cudaSuccess;
  switch (S) {
    LAUNCH_SETS(1) LAUNCH_SETS(2) LAUNCH_SETS(3) LAUNCH_SETS(4)
    LAUNCH_SETS(5) LAUNCH_SETS(6) LAUNCH_SETS(7) LAUNCH_SETS(8)
    LAUNCH_SETS(9) LAUNCH_SETS(10) LAUNCH_SETS(11) LAUNCH_SETS(12)
    LAUNCH_SETS(13) LAUNCH_SETS(14) LAUNCH_SETS(15) LAUNCH_SETS(16)
  }
  return (int)err;
}

// out [R, S]; dirs [S, R, 3]. (G, K): G rays per block, a power of two
// up to BLOCK, and K blocks per cluster, 1 to MAX_CLUSTER; (BLOCK, 1) is
// one thread per ray (multi_chord_kernel).
extern "C" int multi_chord(const float* o, const float* dirs, int R, int S,
                           const int* skips, const float* sph, int ns,
                           const float* aabb, int na, const float* obb,
                           int no, int G, int K, float* out, void* stream) {
  return launch_sets<F32>(o, dirs, R, S, skips, sph, ns, aabb, na, obb, no,
                          G, K, out, stream);
}

// The bfloat16 tier: the same arguments and launch shapes (float32 rays
// and tables, rounded in the kernel; the sums float32).
extern "C" int multi_chord_bf16(const float* o, const float* dirs, int R,
                                int S, const int* skips, const float* sph,
                                int ns, const float* aabb, int na,
                                const float* obb, int no, int G, int K,
                                float* out, void* stream) {
  return launch_sets<BF16>(o, dirs, R, S, skips, sph, ns, aabb, na, obb, no,
                           G, K, out, stream);
}

template <int S>
static cudaError_t launch_tree(const float* o, const float* dirs, int R,
                               const Skips& sk, const Bvh& bvh,
                               const long long* order, float* out,
                               int* visits, cudaStream_t stream) {
  const long long threads = (long long)((R + 31) / 32) * 32 * S;
  const long long blocks = (threads + CHORD_BVH_BLOCK - 1) / CHORD_BVH_BLOCK;
  if (threads > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (visits != nullptr) {
    multi_chord_kernel<S, true><<<(unsigned)blocks, CHORD_BVH_BLOCK, 0,
                                  stream>>>(o, dirs, R, sk, bvh, order, out,
                                            visits);
  } else {
    multi_chord_kernel<S, false><<<(unsigned)blocks, CHORD_BVH_BLOCK, 0,
                                   stream>>>(o, dirs, R, sk, bvh, order, out,
                                             nullptr);
  }
  return cudaGetLastError();
}

#define LAUNCH_TREE(N)                                                  \
  case N:                                                               \
    err = launch_tree<N>(o, dirs, R, sk, bvh, order, out, visits,       \
                         (cudaStream_t)stream);                         \
    break;

// The tree path (float32): out [R, S], dirs [S, R, 3], over the tree of
// ops/cuda/kernels.py::closest_bvh (records rec [leaves, BVH_REC], slots
// [leaves]) and the unpadded type tables it ranks; order [R] the rays in
// the order the threads take them; visits [R, S, 4] or null: non-null
// runs the diagnostic.
extern "C" int multi_chord_bvh(const float* o, const float* dirs, int R,
                               int S, const int* skips, const float* rec,
                               const int* slot, int leaves, const float* sph,
                               int ns, const float* aabb, int na,
                               const float* obb, int no,
                               const long long* order, float* out,
                               int* visits, void* stream) {
  if (S < 1 || S > MAX_SETS || leaves < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) RETURN_LAST_ERROR;
  Skips sk;
  for (int s = 0; s < MAX_SETS; ++s) sk.v[s] = s < S ? skips[s] : 0;
  const Bvh bvh{reinterpret_cast<const float4*>(rec), slot, leaves, sph,
                aabb, obb, ns, ns + na, ns + na + no};
  cudaError_t err = cudaSuccess;
  switch (S) {
    LAUNCH_TREE(1) LAUNCH_TREE(2) LAUNCH_TREE(3) LAUNCH_TREE(4)
    LAUNCH_TREE(5) LAUNCH_TREE(6) LAUNCH_TREE(7) LAUNCH_TREE(8)
    LAUNCH_TREE(9) LAUNCH_TREE(10) LAUNCH_TREE(11) LAUNCH_TREE(12)
    LAUNCH_TREE(13) LAUNCH_TREE(14) LAUNCH_TREE(15) LAUNCH_TREE(16)
  }
  return (int)err;
}
