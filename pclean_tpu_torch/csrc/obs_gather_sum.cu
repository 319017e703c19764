// K3 obs_gather_sum: the observed-column score of an fk candidate axis,
//   out[b, k] = sum_c M_c[obs[b, c], word[c, k]].
//
// Replaces the AddTypos observed-column terms of pclean_tpu/engine/
// propose.py: BlockTracer.score_choice's eager gather (propose.py:463-465,
// _AddTyposK.obs_logdensity at kernels.py:298-300) and its one-hot
// contraction _matmul_obs_term + _mm_flush (propose.py:296-375), which
// summed a sibling group of columns as concat(onehot(obs)) @ concat(T).
// The gather never builds the one-hot or the [V_c, K] score tables.
//
// Bound on the H100 (3.35 TB/s): bytes. The output [B, K] f32 is written
// once, word [C, K] and obs [B, C] int32 read once, and of each M_c only
// the rows the batch observes are needed: (B*K*4 + C*K*4 + B*C*4 +
// sum_c distinct(obs[:, c]) * V_c * 4) / 3.35e12 s.
//
// Design: a block owns 256 consecutive candidates k and kRows rows b. The
// matrices' pointers and sizes come by value in one kernel argument, so the
// kernel reads them from the parameter space and keeps no table of its own
// on the device. Each thread loads its candidate's C word codes once into
// registers (the column loops unroll to kMaxCols with a guard on C, so no
// per-column array is indexed at run time) and reuses them for the block's
// rows; the reads M_c[obs[b, c], .] of one row b hit one M_c row (<= ~22 KB
// at the scaled vocabularies), which stays in L1/L2. Columns are summed in
// order c = 0..C-1 from 0, the order of the plain version, so the two agree
// bit for bit. Codes are clamped into [0, V_c), as the JAX package's
// gathers clamp.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr int kMaxCols = 8;

struct Mats {
  const float* M[kMaxCols];
  int32_t V[kMaxCols];
};

__global__ void __launch_bounds__(kThreads)
obs_gather_sum_kernel(const Mats mats, const int32_t* __restrict__ obs,
                      const int32_t* __restrict__ word,
                      float* __restrict__ out, int64_t B, int64_t K, int C) {
  const int64_t k = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  int32_t w[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < C) {
      const int32_t V = mats.V[c];
      const int32_t wc = word[(int64_t)c * K + k];
      w[c] = wc < 0 ? 0 : (wc >= V ? V - 1 : wc);
    }
  }
  const int64_t b0 = (int64_t)blockIdx.y * kRows;
  for (int r = 0; r < kRows; ++r) {
    const int64_t b = b0 + r;
    if (b >= B) break;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < C) {
        const int32_t V = mats.V[c];
        int32_t o = obs[b * C + c];
        o = o < 0 ? 0 : (o >= V ? V - 1 : o);
        acc += __ldg(mats.M[c] + (int64_t)o * V + w[c]);
      }
    }
    out[b * K + k] = acc;
  }
}

}  // namespace

// mats [C] host array of device pointers to f32 [V_c, V_c] matrices, vsize
// [C] host int32 array; obs [B, C] int32, word [C, K] int32, out [B, K] f32
// on the device, contiguous; 1 <= C <= 8. Returns cudaGetLastError() after
// the launch.
extern "C" int pclean_obs_gather_sum(const int64_t* mats,
                                     const int32_t* vsize,
                                     const int32_t* obs, const int32_t* word,
                                     float* out, int64_t B, int64_t K, int C,
                                     void* stream) {
  if (C < 1 || C > kMaxCols) return (int)cudaErrorInvalidValue;
  Mats m = {};
  for (int c = 0; c < C; ++c) {
    m.M[c] = reinterpret_cast<const float*>(mats[c]);
    m.V[c] = vsize[c];
  }
  if (B > 0 && K > 0) {
    dim3 grid((unsigned)((K + kThreads - 1) / kThreads),
              (unsigned)((B + kRows - 1) / kRows));
    obs_gather_sum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        m, obs, word, out, B, K, C);
  }
  return (int)cudaGetLastError();
}
