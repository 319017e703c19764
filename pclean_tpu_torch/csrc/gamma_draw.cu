// K22 gamma_draw: every Proportions and Prob draw of one parameter
// resample, in one launch.
//
// Replaces the draws of pclean_tpu/dists/params.py resample_proportions
// (jax.random.dirichlet(conc + counts)), resample_prob
// (jax.random.beta(a + heads, b + tails)) and their init_* forms, which
// jax.random runs as on-device rejection loops inside the scan body
// (pclean_tpu/engine/gibbs_params.py:54-121 calls them for every learned
// parameter). The port drew them with a host-checked rejection loop, one
// host sync a round. A descriptor (ops.gamma_desc) is `rows` rows of
// `width` gammas, alpha[i, j] = base[j] (or base[0]) + counts[i, j] (one
// float add, as torch adds the float32 counts to the prior), each drawn
// by gamma.cuh's Marsaglia-Tsang loop on the Philox stream at element
// (the descriptor's first element + i width + j), then, by mode:
//   gamma          out[i, j] = g[i, j];
//   dirichlet_log  out[i, j] = log(g[i, j] / S_i)        (Dirichlet rows,
//                  the log that resample_proportions stores);
//   beta           out[i] = g[i, 0] / S_i, width 2       (x / (x + y)),
// S_i the row's sum in a fixed tree order: the row padded with zeros to P
// = the next power of two, then s[j] += s[j + h] for h = P / 2, ..., 1.
// ops.gamma_draw_plain draws the same stream and sums in the same order
// with torch ops, so the two are bit-equal on the card.
//
// Bound on the H100: neither bytes (a few hundred) nor floating point at
// the paths' sizes; the launch, and each element's rejection rounds (about
// 1.1 on average, 10 Philox rounds, a log, a cos and a sqrt each) in one
// thread. Design: one block of 256 threads a row, each thread drawing
// elements width-strided into a scratch buffer the call owns, then the
// tree sum over the block with a barrier a level and the row's outputs.
// The descriptors (pointers, strides, offsets) are passed by value, up to
// K22_MAX_DESC a launch, so a launch reads no table from device memory
// and can be captured.

#include "gamma.cuh"

#define K22_HEAD 8
#define K22_DESC 16
#define K22_MAX_DESC 64
#define K22_WORDS (K22_HEAD + K22_DESC * K22_MAX_DESC)
#define K22_THREADS 256

namespace {

struct K22Plan {
  int64_t w[K22_WORDS];
};

// Header words (ops.gamma_draw).
enum { hN = 0, hSeed, hScratch, hRows };
// Descriptor words.
enum {
  dMode = 0, dRows, dWidth, dPow2, dBase, dBaseS, dCnt, dCntDt, dCntRS,
  dCntCS, dOut, dOutRS, dElem, dG, dTree, dFirst
};

__device__ __forceinline__ float count_f(int64_t p, int64_t dt, int64_t i) {
  if (dt == 5) return (float)reinterpret_cast<const int64_t*>(p)[i];
  return (float)reinterpret_cast<const int32_t*>(p)[i];
}

__global__ void __launch_bounds__(K22_THREADS)
    gamma_draw_kernel(const __grid_constant__ K22Plan plan) {
  const int64_t* h = plan.w;
  const int64_t b = blockIdx.x;
  int k = 0;
  while (k + 1 < h[hN] && h[K22_HEAD + K22_DESC * (k + 1) + dFirst] <= b) ++k;
  const int64_t* d = h + K22_HEAD + K22_DESC * k;
  const int64_t i = b - d[dFirst], W = d[dWidth], P = d[dPow2];
  const uint64_t seed = (uint64_t)reinterpret_cast<const int64_t*>(h[hSeed])[0];
  float* scratch = reinterpret_cast<float*>(h[hScratch]);
  float* g = scratch + d[dG] + i * W;
  float* t = scratch + d[dTree] + i * (P / 2);
  const float* base = reinterpret_cast<const float*>(d[dBase]);
  float* out = reinterpret_cast<float*>(d[dOut]) + i * d[dOutRS];
  for (int64_t j = threadIdx.x; j < W; j += K22_THREADS) {
    float alpha = base[j * d[dBaseS]];
    if (d[dCnt] != 0)
      alpha = __fadd_rn(
          alpha, count_f(d[dCnt], d[dCntDt], i * d[dCntRS] + j * d[dCntCS]));
    const float x = pclean_gamma::draw_gamma(
        alpha, seed, (uint64_t)(d[dElem] + i * W + j), 0);
    g[j] = x;
    if (d[dMode] == 0) out[j] = x;
  }
  if (d[dMode] == 0) return;   // block-uniform
  __syncthreads();
  // the row's sum: level 1 from g (zeros past the row), then in place
  __shared__ float sum;
  if (P == 1) {
    if (threadIdx.x == 0) sum = g[0];
  } else {
    for (int64_t j = threadIdx.x; j < P / 2; j += K22_THREADS)
      t[j] = j + P / 2 < W ? __fadd_rn(g[j], g[j + P / 2]) : g[j];
    for (int64_t half = P / 4; half >= 1; half >>= 1) {
      __syncthreads();
      for (int64_t j = threadIdx.x; j < half; j += K22_THREADS)
        t[j] = __fadd_rn(t[j], t[j + half]);
    }
    __syncthreads();
    if (threadIdx.x == 0) sum = t[0];
  }
  __syncthreads();
  if (d[dMode] == 1) {
    for (int64_t j = threadIdx.x; j < W; j += K22_THREADS)
      out[j] = logf(__fdiv_rn(g[j], sum));
  } else if (threadIdx.x == 0) {
    out[0] = __fdiv_rn(g[0], sum);
  }
}

}  // namespace

// words: the plan (ops.gamma_draw's words): [descriptors, seed (int64 [1]
// on the card), scratch (float32), rows (the grid), 0 x 4], then each
// descriptor [mode (0 gamma, 1 dirichlet_log, 2 beta), rows, width, P,
// base (float32), its stride (0: one value), counts (int32 or int64) or
// 0, its dtype, its row stride, its column stride, out (float32), its
// row stride, the first element's counter, g's offset in the scratch,
// the tree's offset, the descriptor's first block]. 256 threads a block,
// a block a row. Returns cudaErrorInvalidValue for a plan it does not
// take, else cudaGetLastError() after the launch.
extern "C" int pclean_gamma_draw(const int64_t* words, int n_words,
                                 void* stream) {
  if (n_words < K22_HEAD || n_words > K22_WORDS || words[hN] < 1 ||
      words[hN] > K22_MAX_DESC ||
      n_words < K22_HEAD + K22_DESC * words[hN] || words[hSeed] == 0 ||
      words[hScratch] == 0 || words[hRows] < 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < words[hN]; ++k) {
    const int64_t* d = words + K22_HEAD + K22_DESC * k;
    if (d[dMode] < 0 || d[dMode] > 2 || d[dRows] < 0 || d[dWidth] < 1 ||
        d[dPow2] < d[dWidth] || (d[dMode] == 2 && d[dWidth] != 2) ||
        d[dBase] == 0 || d[dOut] == 0)
      return (int)cudaErrorInvalidValue;
  }
  K22Plan plan;
  for (int i = 0; i < K22_WORDS; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  if (words[hRows] > 0)
    gamma_draw_kernel<<<(unsigned)words[hRows], K22_THREADS, 0,
                        (cudaStream_t)stream>>>(plan);
  return (int)cudaGetLastError();
}
