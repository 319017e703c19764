// K5 gauss_ext_term: the closed-form Gaussian external of a latent block,
//   mu[b, a, c] = values[tbl[idx[b, a], c]],
//   out[b, a]   = coef * (sum_c szz[s_b, c] - 2 sum_c mu * sz[s_b, c]
//                         + sum_c mu^2 * n[s_b, c]) + pre0[s_b],
// with s_b the swept slot of row b and coef = -1 / (2 std^2).
//
// Replaces the body of BlockTracer._ext_gauss_term in pclean_tpu/engine/
// propose.py:856-872: the gather of the indexed Mean values through the key
// table (values[tbl[env_idx]], an [axes..., C] tensor per row) and the
// three C-length reductions that XLA fused, which torch would spread over
// about eight launches. idx[b, a] is the row-major position of row b's
// option a in the key table's env axes (the enumerated state and the
// row's own county key in the rents model), computed by the wrapper's
// caller; C is the referrer group axis (room types).
//
// Bound on the H100 (3.35 TB/s): bytes, far below the launch floor at the
// rents County block's [256 rows, 51 states, C = 5]: idx and out (52 KB
// each), the table rows and values the batch touches (at most 256 * 51
// rows of 20 bytes and as many values) and the B slots' statistics.
//
// Design: one thread per (b, a), the C-length loop in registers, every
// gather clamped into range as the JAX package's gathers clamp. The three
// sums run in order c = 0..C-1 from 0; the plain version's reductions may
// run in another order, and the result subtracts sums of order n * z^2,
// so the two agree to 2^-20 of |coef| * (|sum szz| + 2 |sum mu sz| +
// |sum mu^2 n|) plus 1e-5, not bit for bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x >= hi ? hi - 1 : x);
}

__global__ void __launch_bounds__(kThreads)
gauss_ext_term_kernel(const float* __restrict__ values, int64_t I,
                      const int32_t* __restrict__ tbl, int64_t E, int C,
                      const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ slot,
                      const float* __restrict__ n,
                      const float* __restrict__ sz,
                      const float* __restrict__ szz,
                      const float* __restrict__ pre0, int64_t cap,
                      float coef, float* __restrict__ out, int64_t B,
                      int64_t A) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * A) return;
  const int64_t b = i / A;
  const int64_t s = clamp64(slot[b], cap);
  const int32_t* trow = tbl + clamp64(idx[i], E) * C;
  const float* nr = n + s * C;
  const float* szr = sz + s * C;
  const float* szzr = szz + s * C;
  float a_szz = 0.0f, a_sz = 0.0f, a_n = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float mu = __ldg(values + clamp64(__ldg(trow + c), I));
    a_szz += __ldg(szzr + c);
    a_sz += mu * __ldg(szr + c);
    a_n += mu * mu * __ldg(nr + c);
  }
  out[i] = coef * (a_szz - 2.0f * a_sz + a_n) + __ldg(pre0 + s);
}

}  // namespace

// values [I] f32, tbl [E, C] int32, idx [B, A] int32, slot [B] int32,
// n, sz, szz [cap, C] f32, pre0 [cap] f32, out [B, A] f32, on the device
// and contiguous. The plan (ops.gauss_ext_term_plan) is launched as given:
// `threads` threads (256) a block, `grid` blocks covering B * A. Returns
// cudaErrorInvalidValue for a plan that does not, else cudaGetLastError()
// after the launch.
extern "C" int pclean_gauss_ext_term(const float* values, int64_t I,
                                     const int32_t* tbl, int64_t E, int C,
                                     const int32_t* idx, const int32_t* slot,
                                     const float* n, const float* sz,
                                     const float* szz, const float* pre0,
                                     int64_t cap, float coef, float* out,
                                     int64_t B, int64_t A, int threads,
                                     int64_t grid, void* stream) {
  if (I < 1 || E < 1 || C < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || A <= 0) return (int)cudaGetLastError();
  if (threads != kThreads || grid * kThreads < B * A)
    return (int)cudaErrorInvalidValue;
  gauss_ext_term_kernel<<<(unsigned)grid, kThreads, 0,
                          (cudaStream_t)stream>>>(
      values, I, tbl, E, C, idx, slot, n, sz, szz, pre0, cap, coef, out, B,
      A);
  return (int)cudaGetLastError();
}
