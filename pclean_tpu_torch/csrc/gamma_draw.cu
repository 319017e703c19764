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
// by gamma.cuh's Marsaglia-Tsang rounds on the Philox stream at element
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
// Bound on the H100: latency. The bytes are a few hundred and the
// operations a few thousand at the paths' sizes (rents' one row of 51,
// scaled's of 50, hospital's rows of 23, 14 and 8, flights' 39 Beta
// pairs); what a launch waits on is its floor, one round of loads and one
// element's chain: Philox, a log, a cos and a square root, the acceptance
// logs, then the sum's levels and a log.
//
// Design (ops.gamma_draw_plan). An element a thread, each drawn by
// gamma.cuh's draw_gamma (K23's code): a block of T threads a row (the
// launch's widest P, 32 to K22_THREADS), thread t holding element t, or
// past T elements t + T e, its own levels on a stack in bit-reversed
// order of e (the tree's pairing) with the draws staged in the row's
// output for the logs; the levels h < T in shared memory down to 32, the
// last five by shuffles; the outputs written from registers, no scratch.
// A group of P lanes a row, up to 32 / P rows a warp, was built and
// measured no faster than a block a row at the census shapes (flights'
// Beta pairs, hospital's rows of 23, 14 and 8; PERF.md section 6), so
// rows of every width take this one form. The plan's row table says
// which block takes which descriptor and row, so no thread searches for
// it. Every load of a thread (the seed, its base entry, its count) is
// issued before its draw. Drawing a round ahead (rounds 0 and 1 as two
// chains, the first that accepts kept) measured slower on the card
// (PERF.md section 6): most warps accept in round 0. The plan (pointers,
// strides, offsets, the row table) is passed by value, so a launch reads
// no table from device memory and can be captured.

#include "gamma.cuh"

#define K22_HEAD 8
#define K22_DESC 16
#define K22_MAX_DESC 64
#define K22_MAX_ROWS 2048
#define K22_ROWS_AT (K22_HEAD + K22_DESC * K22_MAX_DESC)
#define K22_WORDS (K22_ROWS_AT + K22_MAX_ROWS / 2)
#define K22_THREADS 256
#define K22_STACK 40

namespace {

struct K22Plan {
  int64_t w[K22_WORDS];
};

// Header words (ops.gamma_draw_words).
enum { hN = 0, hSeed, hRows, hThreads };
// Descriptor words.
enum {
  dMode = 0, dRows, dWidth, dPow2, dPer, dBase, dBaseS, dCnt, dCntDt,
  dCntRS, dCntCS, dOut, dOutRS, dElem
};

__device__ __forceinline__ float count_f(int64_t p, int64_t dt, int64_t i) {
  if (dt == 5) return (float)reinterpret_cast<const int64_t*>(p)[i];
  return (float)reinterpret_cast<const int32_t*>(p)[i];
}

// Row r of descriptor d over the block's T threads, E = P / T (at least
// 1) elements a thread (t + T e).
__device__ __forceinline__ void draw_row(const int64_t* h, const int64_t* d,
                                         int64_t r) {
  __shared__ float sh[K22_THREADS];
  __shared__ float sum;
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t W = d[dWidth], P = d[dPow2], E = d[dPer];
  const float* base = reinterpret_cast<const float*>(d[dBase]);
  const int64_t bs = d[dBaseS], cnt = d[dCnt];
  const uint64_t seed =
      (uint64_t)reinterpret_cast<const int64_t*>(h[hSeed])[0];
  const uint64_t elem0 = (uint64_t)(d[dElem] + r * W);
  const int mode = (int)d[dMode];
  float* out = reinterpret_cast<float*>(d[dOut]) + r * d[dOutRS];
  float acc;
  if (E == 1) {   // a thread an element: its loads in one round
    float alpha = t < W ? base[t * bs] : 1.0f;
    const float c = t < W && cnt != 0
        ? count_f(cnt, d[dCntDt], r * d[dCntRS] + t * d[dCntCS]) : 0.0f;
    if (cnt != 0) alpha = __fadd_rn(alpha, c);
    acc = t < W ? pclean_gamma::draw_gamma(alpha, seed, elem0 + t, 0) : 0.0f;
    if (mode == 0) {
      if (t < W) out[t] = acc;
      return;
    }
  } else {
    // the thread's elements in bit-reversed order of e, pairwise on a
    // stack: the tree's levels h >= T; the draws staged in the output
    const int lg = __ffsll((long long)E) - 1;
    float st[K22_STACK];
    int sp = 0;
    for (int64_t i = 0; i < E; ++i) {
      const int64_t e = (int64_t)(__brevll((unsigned long long)i) >> (64 - lg));
      const int64_t j = t + (int64_t)T * e;
      float x = 0.0f;
      if (j < W) {
        float alpha = base[j * bs];
        if (cnt != 0)
          alpha = __fadd_rn(
              alpha, count_f(cnt, d[dCntDt], r * d[dCntRS] + j * d[dCntCS]));
        x = pclean_gamma::draw_gamma(alpha, seed, elem0 + j, 0);
        out[j] = x;
      }
      st[sp++] = x;
      for (int64_t c = i + 1; (c & 1) == 0; c >>= 1, --sp)
        st[sp - 2] = __fadd_rn(st[sp - 2], st[sp - 1]);
    }
    if (mode == 0) return;   // block-uniform
    acc = st[0];
  }
  // the levels h < T: in shared memory down to 32, then by shuffles
  const int n = P < T ? (int)P : T;
  sh[t] = acc;
  for (int h2 = n / 2; h2 >= 32; h2 >>= 1) {
    __syncthreads();
    if (t < h2) sh[t] = __fadd_rn(sh[t], sh[t + h2]);
  }
  __syncthreads();
  if (t < 32) {
    const int m = n < 32 ? n : 32;
    float v = t < m ? sh[t] : 0.0f;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      if (o < m) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    if (t == 0) sum = v;
  }
  __syncthreads();
  const float S = sum;
  if (E == 1) {
    if (mode == 2) {   // a Beta pair: thread 0 holds g[0]
      if (t == 0) out[0] = __fdiv_rn(acc, S);
    } else if (t < W) {
      out[t] = logf(__fdiv_rn(acc, S));
    }
    return;
  }
  for (int64_t e = 0; e < E; ++e) {
    const int64_t j = t + (int64_t)T * e;
    if (j < W) out[j] = logf(__fdiv_rn(out[j], S));
  }
}

__global__ void __launch_bounds__(K22_THREADS)
    gamma_draw_kernel(const __grid_constant__ K22Plan plan) {
  const int64_t* h = plan.w;
  const int32_t e =
      reinterpret_cast<const int32_t*>(h + K22_ROWS_AT)[blockIdx.x];
  draw_row(h, h + K22_HEAD + K22_DESC * (e & 63), e >> 6);
}

int64_t pow2_of(int64_t w) {
  int64_t p = 1;
  while (p < w) p <<= 1;
  return p;
}

}  // namespace

// words: the plan (ops.gamma_draw_words): a header [descriptors, seed
// (int64 [1] on the card), rows (a block each), threads a block, 0, 0, 0,
// 0]; K22_MAX_DESC descriptors [mode (0 gamma, 1 dirichlet_log, 2 beta),
// rows, width, P, elements a thread, base (float32), its stride (0: one
// value), counts (int32 or int64) or 0, its dtype, its row stride, its
// column stride, out (float32), its row stride, the first element's
// counter, 0, 0], the unused ones 0; then the row table, int32 entries
// descriptor + 64 row, block b taking entry b. Returns
// cudaErrorInvalidValue for a plan it does not take, else
// cudaGetLastError() after the launch.
extern "C" int pclean_gamma_draw(const int64_t* words, int n_words,
                                 void* stream) {
  if (n_words < K22_ROWS_AT || n_words > K22_WORDS || words[hN] < 1 ||
      words[hN] > K22_MAX_DESC || words[hSeed] == 0 || words[hRows] < 0 ||
      words[hThreads] < 32 || words[hThreads] > K22_THREADS ||
      (words[hThreads] & (words[hThreads] - 1)) != 0 ||
      words[hRows] > 2 * (n_words - K22_ROWS_AT))
    return (int)cudaErrorInvalidValue;
  const int64_t T = words[hThreads];
  for (int k = 0; k < words[hN]; ++k) {
    const int64_t* d = words + K22_HEAD + K22_DESC * k;
    if (d[dMode] < 0 || d[dMode] > 2 || d[dRows] < 0 || d[dWidth] < 1 ||
        d[dWidth] > (1ll << 40) || d[dPow2] != pow2_of(d[dWidth]) ||
        (d[dMode] == 2 && d[dWidth] != 2) || d[dBase] == 0 ||
        d[dOut] == 0 || d[dPer] != (d[dPow2] > T ? d[dPow2] / T : 1))
      return (int)cudaErrorInvalidValue;
  }
  const int32_t* rows = reinterpret_cast<const int32_t*>(words + K22_ROWS_AT);
  for (int64_t u = 0; u < words[hRows]; ++u) {
    const int32_t e = rows[u];
    if (e < 0 || (e & 63) >= words[hN] ||
        (e >> 6) >= words[K22_HEAD + K22_DESC * (e & 63) + dRows])
      return (int)cudaErrorInvalidValue;
  }
  K22Plan plan;
  for (int i = 0; i < K22_WORDS; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  if (words[hRows] > 0)
    gamma_draw_kernel<<<(unsigned)words[hRows], (unsigned)T, 0,
                        (cudaStream_t)stream>>>(plan);
  return (int)cudaGetLastError();
}
