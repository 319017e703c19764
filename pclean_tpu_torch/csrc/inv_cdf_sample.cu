// K2 inv_cdf_sample: one categorical draw per row by inverse CDF.
//
// Replaces pclean_tpu/engine/propose.py _inv_cdf_from_u (propose.py:
// 1153-1172), the draw behind BlockTracer.sample_fk and sample_choice:
// m = max(logits), p = exp(logits - m), c = cumsum(p),
// idx = #{i : c[i] < (1 - u) * c[-1]}.
// The threshold lies in (0, total], never [0, total): at 0 every test
// c < t is false and index 0 would be drawn even with zero mass (a dead fk
// candidate slot); the (0, total] form also keeps trailing zero-mass
// entries unselectable (their prefix equals total).
//
// Bound on the H100 (3.35 TB/s): bytes. R rows of K logits and R uniforms
// are read once and R int32 indices written: (R*K*4 + R*4 + R*4) / 3.35e12 s.
//
// Design: one block per row, each thread owning one contiguous chunk of the
// row. Pass 1: block max. Pass 2: each thread sums exp over its chunk;
// thread 0 turns the chunk sums into exclusive prefixes sequentially, so
// the last prefix IS the total. Pass 3: each thread walks its chunk again
// with prefix + running sum (the same additions as pass 2, so a chunk's
// last prefix equals the next chunk's start bit for bit) and counts the
// entries below the threshold; a block sum gives the index. The prefix
// sequence is therefore monotone and ends exactly at the total, which keeps
// the (0, total] guarantees above. Summation order differs from
// torch.cumsum, so a uniform within float rounding of a boundary may pick
// the neighbouring index; chip_smoke.py states the mismatch it allows.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
inv_cdf_sample_kernel(const float* __restrict__ logits,
                      const float* __restrict__ u,
                      int32_t* __restrict__ idx, int64_t K) {
  __shared__ float sh[33];
  __shared__ int shi[33];
  __shared__ float prefix[kThreads + 1];
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* x = logits + row * K;

  float m = -INFINITY;
  for (int64_t k = tid; k < K; k += kThreads) m = fmaxf(m, x[k]);
  m = pclean_block_max(m, sh);

  const int64_t chunk = (K + kThreads - 1) / kThreads;
  const int64_t lo = (int64_t)tid * chunk;
  const int64_t hi = lo + chunk < K ? lo + chunk : K;
  float s = 0.0f;
  for (int64_t k = lo; k < hi; ++k) s += expf(x[k] - m);
  prefix[tid] = s;
  __syncthreads();
  if (tid == 0) {
    float acc = 0.0f;
    for (int t = 0; t < kThreads; ++t) {
      const float v = prefix[t];
      prefix[t] = acc;
      acc = acc + v;
    }
    prefix[kThreads] = acc;
  }
  __syncthreads();

  const float total = prefix[kThreads];
  const float ub = (1.0f - u[row]) * total;
  const float base = prefix[tid];
  float r = 0.0f;
  int cnt = 0;
  for (int64_t k = lo; k < hi; ++k) {
    r += expf(x[k] - m);
    if (base + r < ub) ++cnt;
  }
  cnt = pclean_block_sum_int(cnt, shi);
  if (tid == 0) idx[row] = cnt;
}

}  // namespace

// logits [R, K] f32, u [R] f32, idx [R] int32; contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int pclean_inv_cdf_sample(const float* logits, const float* u,
                                     int32_t* idx, int64_t R, int64_t K,
                                     void* stream) {
  if (R > 0) {
    inv_cdf_sample_kernel<<<(unsigned)R, kThreads, 0,
                            (cudaStream_t)stream>>>(logits, u, idx, K);
  }
  return (int)cudaGetLastError();
}
