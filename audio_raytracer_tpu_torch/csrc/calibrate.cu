// B9: the op-rate calibration kernel of the roofline tool.
//
// Replaces the TPU kernel tools/roofline.py::calibrate.kernel. Every lane
// runs a counted chain of float32 operations once per "primitive", with
// the primitive's six fields read from shared memory as broadcasts, as the
// production kernels read their primitive rows:
//   FMA4: four independent chains v = v * s + c, 2 operations per step,
//         OPS / 8 rounds of the four;
//   OCCL: the occlusion mix, 11 operations per round with 4-wide ILP
//         (2 mul, 4 add, 1 min, 1 max, 2 compares, 2 selects), OPS / 11
//         rounds;
// and writes v1 + v2 + v3 + v4. OPS is 88 or 176 per primitive; the
// roofline tool's ceiling is the marginal rate between the two, which
// cancels the per-primitive loop overhead (shared-memory loads, counter,
// branch).
//
// Built with the same flags as every kernel (--fmad=false, no fast math),
// so no counted pair fuses into an FFMA and the chain runs the float32
// instruction stream the production kernels see. Two details keep the
// machine code at exactly OPS float32 instructions per primitive (the
// roofline tool reads them back with cuobjdump): the occl mix's t x 1e-3
// takes its multiplier from a per-round kernel parameter (all equal to
// 1e-3), so rounds that share t do not share one product; and its
// conditional increment is v2 + (k2 ? 1e-9 : 0), a select and an add,
// which the compiler cannot turn into one predicated add. Both give the
// values of the JAX chain bit for bit.
//
// Design: one thread per lane, blocks of BLOCK lanes, the [prims, 8]
// field table (six fields, two pad) staged TILE rows at a time.

#include "fields.cuh"

#define CAL_W 8
#define CAL_MAX_ROUNDS 16
#define FMA4 0
#define OCCL 1

struct CalConsts {
  float k[CAL_MAX_ROUNDS];
};

template <int MIX, int OPS>
__global__ void __launch_bounds__(BLOCK)
calibrate_kernel(const float* __restrict__ x, int n,
                 const float* __restrict__ fields, int prims, CalConsts kc,
                 float* __restrict__ out) {
  __shared__ __align__(16) float tile[TILE * CAL_W];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float v0 = i < n ? x[i] : 0.0f;
  float v1 = v0, v2 = v0 * 1.1f, v3 = v0 * 0.9f, v4 = v0 * 1.2f;
  for (int base = 0; base < prims; base += TILE) {
    const int m = min(TILE, prims - base);
    __syncthreads();
    load_tile(tile, fields, base, m, CAL_W);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < m; ++j) {
      const float* p = tile + j * CAL_W;
      const float f[6] = {p[0], p[1], p[2], p[3], p[4], p[5]};
      if (MIX == FMA4) {
#pragma unroll
        for (int q = 0; q < OPS / 8; ++q) {
          const float s = f[q % 6];
          v1 = v1 * s + 1e-7f;
          v2 = v2 * s + 2e-7f;
          v3 = v3 * s + 3e-7f;
          v4 = v4 * s + 4e-7f;
        }
      } else {
#pragma unroll
        for (int q = 0; q < OPS / 11; ++q) {
          const float s = f[q % 3], t = f[3 + q % 3];
          v1 = v1 * s + 1e-7f;
          v2 = v2 + t * kc.k[q];
          v3 = fminf(v3, v1);
          v4 = fmaxf(v4, v2);
          const bool k1 = v3 > v4;
          v1 = k1 ? v1 : v2;
          const bool k2 = v2 < v3;
          v2 = v2 + (k2 ? 1e-9f : 0.0f);
        }
      }
    }
  }
  if (i < n) out[i] = v1 + v2 + v3 + v4;
}

#define LAUNCH(M, N)                                                   \
  if (mix == M && ops == N)                                            \
    calibrate_kernel<M, N><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,        \
                             (cudaStream_t)stream>>>(x, n, fields,     \
                                                     prims, kc, out);

// x, out: [n] float32; fields: [prims, 8] float32 (columns 0-5 used);
// mix: FMA4 or OCCL; ops: 88 or 176.
extern "C" int calibrate(const float* x, int n, const float* fields,
                         int prims, int mix, int ops, float* out,
                         void* stream) {
  if ((mix != FMA4 && mix != OCCL) || (ops != 88 && ops != 176))
    return (int)cudaErrorInvalidValue;
  if (n == 0) RETURN_LAST_ERROR;
  CalConsts kc;
  for (int q = 0; q < CAL_MAX_ROUNDS; ++q) kc.k[q] = 1e-3f;
  LAUNCH(FMA4, 88) LAUNCH(FMA4, 176) LAUNCH(OCCL, 88) LAUNCH(OCCL, 176)
  RETURN_LAST_ERROR;
}
