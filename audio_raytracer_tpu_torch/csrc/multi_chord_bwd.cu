// B5: the ray adjoint of the fused permeation chords (B3).
//
// Replaces the ray part of the TPU kernel audio_raytracer_tpu/ops/pallas/
// fused.py::multi_chord_bwd_kernel (wrapper run_multi_chord_bwd): given
// gbar [R, S], the cotangent of B3's output, it returns
//   d_o [R, 3]        = sum over sets and primitives of d(chord x dens)/d o
//   d_dirs [S, R, 3]  = the same with respect to each set's direction,
// through the hand-closed adjoints of the sphere chord (fused.py:676-710),
// the box chord (_box_chord_adjoint, :603-639, with _inv_dir_grad,
// :642-644) and, for OBBs, the pullback through the world->local matrix
// (M^T, :779-784). Every (ray, primitive, set) term is computed as the
// plain version in ops/cuda/fused.py computes it (csrc/chord.cuh); the
// sums over primitives run in scan order here.
//
// The TPU kernel also gave each primitive's density gradient. That is
// the quantity B4 computes (gv x chord), so the B5 wrapper launches B4's
// primitive-parallel kernel (csrc/multi_chord_dens_bwd.cu) beside this
// one instead of reducing across rays here; both launches count as B5's.
//
// Design: one thread per ray, as B3: the S sets' directions, inverse
// directions and cotangents and the 3 + 3S accumulators live in
// registers, primitive rows are staged per block in shared memory.
//
// Bound on the H100: float32 operations outside the tensor cores, per
// (ray, primitive) as (shared, per set) in ops/cuda/fused.py::
// CHORD_BWD_OPS, against 67 TFLOP/s.

#include "chord.cuh"

template <int S>
__global__ void __launch_bounds__(BLOCK)
multi_chord_bwd_kernel(const float* __restrict__ o,
                       const float* __restrict__ dirs,
                       const float* __restrict__ gbar, int R, Skips skips,
                       const float* __restrict__ sph, int ns,
                       const float* __restrict__ aabb, int na,
                       const float* __restrict__ obb, int no,
                       float* __restrict__ d_o, float* __restrict__ d_dirs) {
  __shared__ __align__(16) float tile[TILE * OBB_W];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;

  float ov[3] = {0.f, 0.f, 0.f};
  float d[S][3], inv[S][3], g[S], gd[S][3];
  float go[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < S; ++s) {
    g[s] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) d[s][a] = gd[s][a] = 0.f;
  }
  if (live) {
#pragma unroll
    for (int a = 0; a < 3; ++a) ov[a] = o[3 * (size_t)r + a];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int a = 0; a < 3; ++a) d[s][a] = dirs[3 * ((size_t)s * R + r) + a];
      g[s] = gbar[(size_t)r * S + s];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int a = 0; a < 3; ++a) inv[s][a] = safe_inv(d[s][a]);
  }

  for (int base = 0; base < ns; base += TILE) {
    const int n = min(TILE, ns - base);
    __syncthreads();
    load_tile(tile, sph, base, n, SPH_W);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* p = tile + j * SPH_W;
      const int tgt = as_id(p[4]);
      const float dens = p[5];
      const float oc[3] = {ov[0] - p[0], ov[1] - p[1], ov[2] - p[2]};
      const float cc = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]) - p[3];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const SphereChord c = sphere_chord(oc[0], oc[1], oc[2], cc, d[s][0],
                                           d[s][1], d[s][2]);
        const bool valid = c.hit && (c.t_exit >= 0.0f) && tgt != skips.v[s];
        const float gv = valid ? g[s] : 0.0f;
        const float g_chord = gv * dens * mask(c.chord_raw > 0.0f);
        const float g_enter = -g_chord * mask(c.enter_raw > 0.0f);
        float g_b = -g_chord - g_enter;
        const float g_sq = g_chord - g_enter;
        // Zero on an exactly tangent lane (disc == 0, so sq == 0), where
        // g_sq is 0 too: the limit, not 0 * 0.5 / 0 = NaN.
        const float g_disc =
            (c.hit && c.sq > 0.0f) ? g_sq * 0.5f / c.sq : 0.0f;
        g_b = g_b + 2.0f * c.b * g_disc;
        const float g_cc = -g_disc;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          go[a] = go[a] + g_b * d[s][a] + 2.0f * oc[a] * g_cc;
          gd[s][a] = gd[s][a] + g_b * oc[a];
        }
      }
    }
  }
  for (int base = 0; base < na; base += TILE) {
    const int n = min(TILE, na - base);
    __syncthreads();
    load_tile(tile, aabb, base, n, AABB_W);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* p = tile + j * AABB_W;
      const int tgt = as_id(p[7]);
      const float dens = p[8];
      const bool ok = p[6] == 0.0f;
      const float mn[3] = {p[0] - ov[0], p[1] - ov[1], p[2] - ov[2]};
      const float mx[3] = {p[3] - ov[0], p[4] - ov[1], p[5] - ov[2]};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const BoxChord c = box_chord(mn, mx, inv[s]);
        const bool valid = c.meet && tgt != skips.v[s] && ok;
        const float gv = valid ? g[s] : 0.0f;
        float g_mn[3], g_mx[3], g_inv[3];
        box_chord_adjoint(gv, dens, valid, c, mn, mx, inv[s], g_mn, g_mx,
                          g_inv);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          go[a] = go[a] - (g_mn[a] + g_mx[a]);
          gd[s][a] = gd[s][a] + inv_dir_grad(g_inv[a], d[s][a], inv[s][a]);
        }
      }
    }
  }
  for (int base = 0; base < no; base += TILE) {
    const int n = min(TILE, no - base);
    __syncthreads();
    load_tile(tile, obb, base, n, OBB_W);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* p = tile + j * OBB_W;
      const float* m = p + 6;
      const int tgt = as_id(p[16]);
      const float dens = p[17];
      const bool ok = p[15] == 0.0f;
      float lo[3];
      mat_rotate(m, ov[0] - p[0], ov[1] - p[1], ov[2] - p[2], lo[0], lo[1],
                 lo[2]);
      float mn[3], mx[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        mn[a] = -p[3 + a] - lo[a];
        mx[a] = p[3 + a] - lo[a];
      }
      float g_lo[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float ld[3];
        mat_rotate(m, d[s][0], d[s][1], d[s][2], ld[0], ld[1], ld[2]);
        const float li[3] = {safe_inv(ld[0]), safe_inv(ld[1]),
                             safe_inv(ld[2])};
        const BoxChord c = box_chord(mn, mx, li);
        const bool valid = c.meet && tgt != skips.v[s] && ok;
        const float gv = valid ? g[s] : 0.0f;
        float g_mn[3], g_mx[3], g_inv[3], g_ld[3];
        box_chord_adjoint(gv, dens, valid, c, mn, mx, li, g_mn, g_mx, g_inv);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          g_lo[a] = g_lo[a] - (g_mn[a] + g_mx[a]);
          g_ld[a] = inv_dir_grad(g_inv[a], ld[a], li[a]);
        }
        // d_local = M d, so g_d = M^T g_ld.
        float w[3];
        mat_rotate_t(m, g_ld[0], g_ld[1], g_ld[2], w[0], w[1], w[2]);
#pragma unroll
        for (int a = 0; a < 3; ++a) gd[s][a] = gd[s][a] + w[a];
      }
      // o_local = M (o - c), so g_o = M^T g_lo.
      float w[3];
      mat_rotate_t(m, g_lo[0], g_lo[1], g_lo[2], w[0], w[1], w[2]);
#pragma unroll
      for (int a = 0; a < 3; ++a) go[a] = go[a] + w[a];
    }
  }
  if (live) {
#pragma unroll
    for (int a = 0; a < 3; ++a) d_o[3 * (size_t)r + a] = go[a];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        d_dirs[3 * ((size_t)s * R + r) + a] = gd[s][a];
    }
  }
}

#define LAUNCH_SETS(N)                                                   \
  case N:                                                                \
    multi_chord_bwd_kernel<N><<<grid, BLOCK, 0, (cudaStream_t)stream>>>( \
        o, dirs, gbar, R, sk, sph, ns, aabb, na, obb, no, d_o, d_dirs);  \
    break;

// dirs: [S, R, 3]; gbar: [R, S]; writes d_o [R, 3] and d_dirs [S, R, 3].
extern "C" int multi_chord_bwd(const float* o, const float* dirs,
                               const float* gbar, int R, int S,
                               const int* skips, const float* sph, int ns,
                               const float* aabb, int na, const float* obb,
                               int no, float* d_o, float* d_dirs,
                               void* stream) {
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
