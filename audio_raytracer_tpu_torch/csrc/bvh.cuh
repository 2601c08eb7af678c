// The bounding-volume hierarchy of ops/cuda/kernels.py::closest_bvh as the
// kernels that walk it read it: B1's tree kernel (closest_hit.cu, which
// also builds it and bounds its margin) and B3's (multi_chord.cu).

#pragma once

#include "fields.cuh"

// Floats per record (ops/cuda/kernels.py::BVH_REC).
#define BVH_REC 12

// The tree (ops/cuda/kernels.py::bvh_tree): rec [leaves] records, rec[0]
// the header (the root's lo xyz, hi xyz, the scale S, the margin w,
// zeros), rec[k + 1] the boxes of internal node k's children 2k + 1 and
// 2k + 2 (nodes leaves - 1 on are the leaves); slot [leaves] the scan rank
// of each leaf's primitive, INT_MAX past the last; the type tables the
// ranks index: rank < ns a sphere, < na_end an AABB, < total an OBB.
struct Bvh {
  const float4* rec;
  const int* slot;
  int leaves;
  const float* sph;
  const float* aabb;
  const float* obb;
  int ns, na_end, total;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A ray against the tree's boxes, each widened by the ray's slack s: the
// low bounds' planes against o + s, the high bounds' against o - s, as
// one fma each, bound x inv - (o +- s) x inv.
struct NodeRay {
  float lo_oi[3], hi_oi[3], inv[3];
  bool neg[3];
};

// Does the ray enter the box (lo, hi) at tn <= best, within [0, tf]? As
// max(tn, 0) <= min(tf, best), since best >= 0. The near plane per axis is
// the low bound where the inverse direction is >= 0, else the high one,
// so an empty box (lo = +inf, hi = -inf) enters at +inf and leaves at
// -inf: a miss.
__device__ __forceinline__ bool box_enter(const NodeRay& q, float lx,
                                          float ly, float lz, float hx,
                                          float hy, float hz, float best,
                                          float& tn) {
  const float l[3] = {lx, ly, lz}, h[3] = {hx, hy, hz};
  float tn_k[3], tf_k[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = __fmaf_rn(l[k], q.inv[k], -q.lo_oi[k]);
    const float b = __fmaf_rn(h[k], q.inv[k], -q.hi_oi[k]);
    tn_k[k] = q.neg[k] ? b : a;
    tf_k[k] = q.neg[k] ? a : b;
  }
  tn = fmaxf(fmaxf(tn_k[0], tn_k[1]), tn_k[2]);
  return fmaxf(tn, 0.0f) <=
         fminf(fminf(fminf(tf_k[0], tf_k[1]), tf_k[2]), best);
}

// Record i of the tree, through the read-only cache.
__device__ __forceinline__ void record(const Bvh& b, int i, float4& r0,
                                       float4& r1, float4& r2) {
  r0 = __ldg(b.rec + 3 * i);
  r1 = __ldg(b.rec + 3 * i + 1);
  r2 = __ldg(b.rec + 3 * i + 2);
}

// The node test of the ray from (ox, oy, oz) with inverse direction (ix,
// iy, iz) in q, its slack the header's w times the ray's distance scale
// max |o| + S; returns whether the ray enters the root at or before best.
__device__ __forceinline__ bool node_ray(const Bvh& b, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float best, NodeRay& q) {
  float4 h0, h1, h2;
  record(b, 0, h0, h1, h2);
  const float s =
      h1.w * (fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz)) + h1.z);
  const float oo[3] = {ox, oy, oz};
  q.inv[0] = ix; q.inv[1] = iy; q.inv[2] = iz;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q.lo_oi[k] = (oo[k] + s) * q.inv[k];
    q.hi_oi[k] = (oo[k] - s) * q.inv[k];
    q.neg[k] = q.inv[k] < 0.0f;
  }
  float tn;
  return box_enter(q, h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, best, tn);
}
