// K23 py_resample: the Pitman-Yor hyperparameter MH of every latent class
// of one parameter resample, in one launch, a block a class.
//
// Replaces pclean_tpu/engine/gibbs_params.py resample_py (:174-197) with
// its three pitman_yor_score evaluations (:152-171), which XLA fuses into
// the scan body as cumsums, lgammas and sums. For one class, from its
// reference counts and alive bits [cap] (a slot counts where alive and
// refcount > 0) and (s0, d0):
//   n_before[i] = the counts of the counted slots before i, j[i] = the
//   counted slots up to i (1-based), both integer scans, so exact;
//   score(s, d) = sum over counted i of
//       log(max(j d + s, 1e-30)) - log(n_before + s)
//     + [size > 1] ((lgamma(max(size - d, 1e-30)) - lgamma(1 - d))
//                   - (lgamma(n_before + size + s) - lgamma(n_before + 1 + s)))
//   summed in a fixed tree order (the slots padded with zeros to P, the
//   next power of two, then t[i] += t[i + h] for h = P / 2, ..., 1);
//   s_prop ~ Gamma(1, 1) by gamma.cuh (stream 1, the class's element);
//   u0, u1, u2 uniforms in [0, 1) from one Philox block (stream 2);
//   old = score(s0, d0), new = score(s_prop, d0) in one pass;
//   accept s_prop where log u0 < ((new + (-s0)) - old) - (-s_prop);
//   new2 = score(s1, d_prop = u1); accept d_prop where log u2 < new2 - cur;
//   (s1, d1) written to the output leaves (the parameter leaves
//   themselves where the caller resamples in place).
// ops.py_resample_plain repeats every step with torch ops (one rounding a
// step, the same tree), so the two are bit-equal on the card.
//
// Bound on the H100: bytes, 5 bytes a slot read once (and the scratch
// written and read back); at the hospital model's capacities (64-512
// slots) a launch floor. Design: one block of 512 threads a class; each
// thread scans a contiguous chunk of slots, a block scan of the chunk sums
// (warp shuffles) gives each chunk's start, each slot's terms go to a
// scratch buffer the call owns, and the sums are trees over the block
// with a barrier a level; thread 0 makes both accepts. The classes'
// descriptors are passed by value, up to K23_MAX_CLASSES a launch.

#include "gamma.cuh"

#define K23_HEAD 4
#define K23_CLASS 12
#define K23_MAX_CLASSES 64
#define K23_WORDS (K23_HEAD + K23_CLASS * K23_MAX_CLASSES)
#define K23_THREADS 512

namespace {

struct K23Plan {
  int64_t w[K23_WORDS];
};

enum { hN = 0, hSeed, hScratch };
enum {
  cRc = 0, cAlive, cCap, cPow2, cS0, cD0, cS1, cD1, cElem, cScratch
};

// Exclusive block scan of v (every thread gets its exclusive prefix).
// sh: >= 32 long longs.
__device__ __forceinline__ long long block_scan(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < (K23_THREADS >> 5) ? sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s;   // inclusive prefix of the warps' sums
  }
  __syncthreads();
  const long long before = warp > 0 ? sh[warp - 1] : 0;
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ float clamp30(float x) {
  return x < 1e-30f ? 1e-30f : x;
}

// One slot's term of score(s, d) (0 where the slot is not counted).
__device__ __forceinline__ float term(float nb, float jf, float sz, float s,
                                      float d) {
  if (!(sz > 0.0f)) return 0.0f;
  const float tn =
      __fsub_rn(logf(clamp30(__fadd_rn(__fmul_rn(jf, d), s))),
                logf(__fadd_rn(nb, s)));
  float inner = 0.0f;
  if (sz > 1.0f)
    inner = __fsub_rn(
        __fsub_rn(lgammaf(clamp30(__fsub_rn(sz, d))),
                  lgammaf(__fsub_rn(1.0f, d))),
        __fsub_rn(lgammaf(__fadd_rn(__fadd_rn(nb, sz), s)),
                  lgammaf(__fadd_rn(__fadd_rn(nb, 1.0f), s))));
  return __fadd_rn(tn, inner);
}

// The tree sum of t[0, P) in place (t[0] holds it after the last barrier).
__device__ __forceinline__ void tree(float* t, int64_t P) {
  for (int64_t h = P / 2; h >= 1; h >>= 1) {
    __syncthreads();
    for (int64_t i = threadIdx.x; i < h; i += K23_THREADS)
      t[i] = __fadd_rn(t[i], t[i + h]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(K23_THREADS)
    py_resample_kernel(const __grid_constant__ K23Plan plan) {
  __shared__ long long sh[32];
  __shared__ float bc[4];
  const int64_t* h = plan.w;
  const int64_t* c = h + K23_HEAD + K23_CLASS * blockIdx.x;
  const int32_t* rc = reinterpret_cast<const int32_t*>(c[cRc]);
  const uint8_t* alive = reinterpret_cast<const uint8_t*>(c[cAlive]);
  const int64_t cap = c[cCap], P = c[cPow2];
  float* nbf = reinterpret_cast<float*>(h[hScratch]) + c[cScratch];
  float* jf = nbf + cap;
  float* szf = jf + cap;
  float* ta = szf + cap;
  float* tb = ta + P;
  const uint64_t seed = (uint64_t)reinterpret_cast<const int64_t*>(h[hSeed])[0];
  const float s0 = *reinterpret_cast<const float*>(c[cS0]);
  const float d0 = *reinterpret_cast<const float*>(c[cD0]);

  // the scans: each thread a contiguous chunk
  const int64_t per = (cap + K23_THREADS - 1) / K23_THREADS;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < cap ? lo + per : cap;
  long long n = 0, k = 0;
  for (int64_t i = lo; i < hi; ++i)
    if (alive[i] && rc[i] > 0) {
      n += rc[i];
      ++k;
    }
  n = block_scan(n, sh);
  k = block_scan(k, sh);
  for (int64_t i = lo; i < hi; ++i) {
    const bool on = alive[i] && rc[i] > 0;
    const long long sz = on ? rc[i] : 0;
    k += on;
    nbf[i] = (float)n;
    jf[i] = (float)k;
    szf[i] = (float)sz;
    n += sz;
  }
  __syncthreads();

  const pclean_gamma::Block u = pclean_gamma::draw(seed, c[cElem], 0, 2);
  const float sp = pclean_gamma::draw_gamma(1.0f, seed, c[cElem], 1);
  for (int64_t i = threadIdx.x; i < P; i += K23_THREADS) {
    ta[i] = i < cap ? term(nbf[i], jf[i], szf[i], s0, d0) : 0.0f;
    tb[i] = i < cap ? term(nbf[i], jf[i], szf[i], sp, d0) : 0.0f;
  }
  tree(ta, P);
  tree(tb, P);
  if (threadIdx.x == 0) {
    const float old = ta[0], nw = tb[0];
    const float alpha = __fsub_rn(__fsub_rn(__fadd_rn(nw, -s0), old), -sp);
    const bool acc = logf(pclean_gamma::unit(u.x)) < alpha;
    bc[0] = acc ? sp : s0;
    bc[1] = acc ? nw : old;
  }
  __syncthreads();
  const float s1 = bc[0], cur = bc[1], dp = pclean_gamma::unit(u.y);
  for (int64_t i = threadIdx.x; i < P; i += K23_THREADS)
    ta[i] = i < cap ? term(nbf[i], jf[i], szf[i], s1, dp) : 0.0f;
  tree(ta, P);
  if (threadIdx.x == 0) {
    const bool acc2 =
        logf(pclean_gamma::unit(u.z)) < __fsub_rn(ta[0], cur);
    *reinterpret_cast<float*>(c[cS1]) = s1;
    *reinterpret_cast<float*>(c[cD1]) = acc2 ? dp : d0;
  }
}

}  // namespace

// words: the plan (ops.py_resample's words): [classes, seed (int64 [1] on
// the card), scratch (float32), 0], then each class [refcount (int32
// [cap]), alive (bool [cap]), cap, P, strength in, discount in, strength
// out, discount out (float32 scalars; out may be in), the class's element
// of the stream, its scratch offset (3 cap + 2 P floats), 0, 0]. 512
// threads a block, a block a class. Returns cudaErrorInvalidValue for a
// plan it does not take, else cudaGetLastError() after the launch.
extern "C" int pclean_py_resample(const int64_t* words, int n_words,
                                  void* stream) {
  if (n_words < K23_HEAD || n_words > K23_WORDS || words[hN] < 0 ||
      words[hN] > K23_MAX_CLASSES ||
      n_words < K23_HEAD + K23_CLASS * words[hN] || words[hSeed] == 0 ||
      words[hScratch] == 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < words[hN]; ++k) {
    const int64_t* c = words + K23_HEAD + K23_CLASS * k;
    if (c[cRc] == 0 || c[cAlive] == 0 || c[cCap] < 1 || c[cPow2] < c[cCap] ||
        c[cS0] == 0 || c[cD0] == 0 || c[cS1] == 0 || c[cD1] == 0)
      return (int)cudaErrorInvalidValue;
  }
  K23Plan plan;
  for (int i = 0; i < K23_WORDS; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  if (words[hN] > 0)
    py_resample_kernel<<<(unsigned)words[hN], K23_THREADS, 0,
                         (cudaStream_t)stream>>>(plan);
  return (int)cudaGetLastError();
}
