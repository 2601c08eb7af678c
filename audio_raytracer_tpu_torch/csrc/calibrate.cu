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

// ---------------------------------------------------------------------------
// The packed bfloat16 rates
// ---------------------------------------------------------------------------
//
// Beside the float32 ceiling, the rates of Hopper's packed bfloat16
// instructions, which the bound of B1-bf16 and B2-bf16 divides their
// bfloat16 operations by (chip_smoke.py phase 2b). Each lane holds one
// bf16x2 word (two values, as a pair of rays does) and runs OPS packed
// instructions per "primitive", whose six fields are bf16x2 words read
// from shared memory as broadcasts:
//   ADDMUL: four chains v = v * s + c, a mul.rn.bf16x2 and an
//           add.rn.bf16x2 a step (never fused), OPS / 8 rounds;
//   MINMAX: four chains v1 = min(v1, s), v2 = max(v2, s), v3 = min(v3, t),
//           v4 = max(v4, t), OPS / 4 rounds;
//   ADD, MUL: eight independent chains v = v + s (add.rn.bf16x2 alone) or
//           v = v * s (mul.rn.bf16x2 alone), OPS / 8 rounds: the rate of
//           each instruction without the other, beside ADDMUL's mix;
// then writes v1 + v2 + v3 + v4 (ADD and MUL: + v5 + v6 + v7 + v8). The
// marginal rate between OPS = 88 and 176 cancels the loop's overhead, as
// for the float32 ceiling.

#define ADDMUL 0
#define MINMAX 1
#define ADD 2
#define MUL 3

template <int MIX, int OPS>
__global__ void __launch_bounds__(BLOCK)
calibrate_bf16x2_kernel(const unsigned* __restrict__ x, int n,
                        const float* __restrict__ fields, int prims,
                        unsigned* __restrict__ out) {
  using C = BF16X2;
  constexpr bool EIGHT = MIX == ADD || MIX == MUL;
  __shared__ __align__(16) float tile[TILE * CAL_W];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bf16x2_t v0{i < n ? x[i] : 0u};
  bf16x2_t v1 = v0, v2 = C::mul(v0, C::pack(1.1f, 1.1f)),
           v3 = C::mul(v0, C::pack(0.9f, 0.9f)),
           v4 = C::mul(v0, C::pack(1.2f, 1.2f));
  bf16x2_t v5 = C::mul(v0, C::pack(1.3f, 1.3f)),
           v6 = C::mul(v0, C::pack(0.8f, 0.8f)),
           v7 = C::mul(v0, C::pack(1.05f, 1.05f)),
           v8 = C::mul(v0, C::pack(0.95f, 0.95f));
  const bf16x2_t c1 = C::pack(1e-3f, 1e-3f), c2 = C::pack(2e-3f, 2e-3f),
                 c3 = C::pack(3e-3f, 3e-3f), c4 = C::pack(4e-3f, 4e-3f);
  for (int base = 0; base < prims; base += TILE) {
    const int m = min(TILE, prims - base);
    __syncthreads();
    load_tile(tile, fields, base, m, CAL_W);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < m; ++j) {
      const float* p = tile + j * CAL_W;
      const bf16x2_t f[6] = {C::ld(p[0]), C::ld(p[1]), C::ld(p[2]),
                             C::ld(p[3]), C::ld(p[4]), C::ld(p[5])};
      if (MIX == ADDMUL) {
#pragma unroll
        for (int q = 0; q < OPS / 8; ++q) {
          const bf16x2_t s = f[q % 6];
          v1 = C::add(C::mul(v1, s), c1);
          v2 = C::add(C::mul(v2, s), c2);
          v3 = C::add(C::mul(v3, s), c3);
          v4 = C::add(C::mul(v4, s), c4);
        }
      } else if (MIX == MINMAX) {
#pragma unroll
        for (int q = 0; q < OPS / 4; ++q) {
          const bf16x2_t s = f[q % 3], t = f[3 + q % 3];
          v1 = C::min(v1, s);
          v2 = C::max(v2, s);
          v3 = C::min(v3, t);
          v4 = C::max(v4, t);
        }
      } else {
#pragma unroll
        for (int q = 0; q < OPS / 8; ++q) {
          const bf16x2_t s = f[q % 6];
          if (MIX == ADD) {
            v1 = C::add(v1, s); v2 = C::add(v2, s); v3 = C::add(v3, s);
            v4 = C::add(v4, s); v5 = C::add(v5, s); v6 = C::add(v6, s);
            v7 = C::add(v7, s); v8 = C::add(v8, s);
          } else {
            v1 = C::mul(v1, s); v2 = C::mul(v2, s); v3 = C::mul(v3, s);
            v4 = C::mul(v4, s); v5 = C::mul(v5, s); v6 = C::mul(v6, s);
            v7 = C::mul(v7, s); v8 = C::mul(v8, s);
          }
        }
      }
    }
  }
  bf16x2_t sum = C::add(C::add(C::add(v1, v2), v3), v4);
  if (EIGHT) sum = C::add(C::add(C::add(C::add(sum, v5), v6), v7), v8);
  if (i < n) out[i] = sum.x;
}

#define LAUNCH_BF16X2(M, N)                                              \
  if (mix == M && ops == N)                                              \
    calibrate_bf16x2_kernel<M, N><<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,   \
                                    (cudaStream_t)stream>>>(             \
        x, n, fields, prims, out);

// x, out: [n] bf16x2 words; fields: [prims, 8] (columns 0-5 bf16x2
// words); mix: ADDMUL, MINMAX, ADD or MUL; ops: 88 or 176 packed
// instructions.
extern "C" int calibrate_bf16x2(const unsigned* x, int n,
                                const float* fields, int prims, int mix,
                                int ops, unsigned* out, void* stream) {
  if (mix < ADDMUL || mix > MUL || (ops != 88 && ops != 176))
    return (int)cudaErrorInvalidValue;
  if (n == 0) RETURN_LAST_ERROR;
  LAUNCH_BF16X2(ADDMUL, 88) LAUNCH_BF16X2(ADDMUL, 176)
  LAUNCH_BF16X2(MINMAX, 88) LAUNCH_BF16X2(MINMAX, 176)
  LAUNCH_BF16X2(ADD, 88) LAUNCH_BF16X2(ADD, 176)
  LAUNCH_BF16X2(MUL, 88) LAUNCH_BF16X2(MUL, 176)
  RETURN_LAST_ERROR;
}
