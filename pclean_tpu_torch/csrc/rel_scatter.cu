// K14 rel_scatter: one relational scatter of the batched relational state,
// with JAX's mode="drop" rule inside the kernel.
//
// Replaces the scatters that XLA fuses into pclean_tpu/engine/refresh.py's
// refresh (refresh.py:418-483), batch_obs_delta (313-371),
// batch_latent_delta (374-415) and _cascade (282-311): each
// `.at[t].add(w, mode="drop")` of a reference count or a propagated
// observation's count, with its `.at[t].max(code, mode="drop")` where the
// spec has a code. Two modes (ops.rel_scatter, ops.rel_cascade):
//   * scatter: for each of n sources i, its source slot s = i, or
//     slots[i] clamped into the source class as take() clamps it; then for
//     each side (one, or an old and a new one of a delta):
//       w = [alive[s]] [& state[s] == 1] [& s != exclude] [* weight[s]],
//       t = the side's fk columns followed from s (each index clamped, as
//           take() clamps it),
//       cnt[t] += sign w, and where the spec has a code, code[t] =
//       max(code[t], w > 0 ? src_code[s] : 0);
//   * cascade (one latent class): rc = refcount + d, alive_out = rc > 0,
//     flip = alive_out - alive, sums of d and flip into acc[0] and acc[1],
//     and each fk column's flips into the next class's pending delta.
// Every scatter index t follows mode="drop": t in [-C, -1] wraps to t + C,
// the rest outside [0, C) drop, so no count of kept entries is read back
// to the host (the port's boolean compaction did that, and waited for the
// card).
//
// Integer atomics are exact in any order, so the kernel is bit-equal to its
// plain version (ops.rel_scatter_plain, ops.rel_cascade_plain). A max with
// v never changes a code already >= v, and codes only grow during a
// launch, so a thread skips the atomic where a plain read shows code[t] >=
// v: an exact shortcut that keeps most masked rows off the atomics.
//
// Bound on the H100: bytes. A refresh spec over 1,000,000 sources reads an
// fk, an alive byte, a state byte and a code a source (about 10 MB, 3 us at
// 3.35 TB/s) and writes C counts and codes; crowded targets (many sources
// of one entity) serialise their atomics in L2.
//
// Design: a thread a source (a thread a slot in cascade mode), 256 a
// block, the plan passed by value: pointers, dtypes, lengths and the
// chain of up to K14_MAX_HOPS columns, so no table lives on the card and
// nothing is copied before the launch. Cascade mode reduces d and flip in
// the block and adds them with one atomic a block. A delta whose code
// needs `code = where(cnt > 0, code, 0)` between its subtract and its add
// is two launches (ops.rel_scatter's caller runs the where between them).

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K14_MAX_HOPS 4
#define K14_MAX_SIDES 2
#define K14_MAX_FKS 8
#define K14_HEAD 16
#define K14_SIDE (16 + 3 * K14_MAX_HOPS)
#define K14_WORDS (K14_HEAD + K14_MAX_SIDES * K14_SIDE)
#define K14_THREADS 256

namespace {

struct K14Plan {
  int64_t w[K14_WORDS];
};

// where mode="drop" puts t in a target of c entries, or -1 where it drops
__device__ __forceinline__ int64_t drop_index(int64_t t, int64_t c) {
  if (t < 0) t += c;
  return (t < 0 || t >= c) ? -1 : t;
}

__device__ __forceinline__ void code_max(int64_t p, int64_t dt, int64_t t,
                                         int64_t vi, float vf) {
  if (dt == PCLEAN_DT_F32) {
    float* a = reinterpret_cast<float*>(p) + t;
    float cur = *a;
    while (cur < vf) {
      const int old = atomicCAS(reinterpret_cast<int*>(a), __float_as_int(cur),
                                __float_as_int(vf));
      if (old == __float_as_int(cur)) break;
      cur = __int_as_float(old);
    }
  } else if (dt == PCLEAN_DT_I64) {
    long long* a = reinterpret_cast<long long*>(p) + t;
    if (*a < vi) atomicMax(a, (long long)vi);
  } else {
    int* a = reinterpret_cast<int*>(p) + t;
    if (*a < (int)vi) atomicMax(a, (int)vi);
  }
}

__global__ void __launch_bounds__(K14_THREADS)
    scatter_kernel(const __grid_constant__ K14Plan plan) {
  const int64_t* h = plan.w;
  const int64_t n = h[1];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t c_src = h[4], c = h[8];
  const int64_t s = h[2] ? pclean_clamp(pclean_ld_i(h[2], h[3], i), c_src) : i;
  int64_t excl = -1;
  bool has_excl = false;
  if (h[9]) {
    excl = reinterpret_cast<const int64_t*>(h[9])[0];
    has_excl = true;
  } else if (h[11]) {
    excl = h[10];
    has_excl = true;
  }
  int* cnt = reinterpret_cast<int*>(h[5]);
  for (int k = 0; k < (int)h[12]; ++k) {
    const int64_t* sd = h + K14_HEAD + K14_SIDE * k;
    int64_t w = 1;
    if (sd[2] && !reinterpret_cast<const uint8_t*>(sd[2])[s]) w = 0;
    if (sd[3] && pclean_ld_i(sd[3], sd[4], s) != 1) w = 0;
    if (sd[9] && has_excl && s == excl) w = 0;
    if (w && sd[5]) w *= pclean_ld_i(sd[5], sd[6], s);
    const bool code = h[6] != 0 && sd[7] != 0;
    if (w == 0 && !code) continue;
    int64_t t = s;
    for (int j = 0; j < (int)sd[1]; ++j) {
      const int64_t* hp = sd + 16 + 3 * j;
      t = pclean_ld_i(hp[0], hp[1], pclean_clamp(t, hp[2]));
    }
    t = drop_index(t, c);
    if (t < 0) continue;
    if (w != 0) atomicAdd(cnt + t, (int)(sd[0] * w));
    if (code) {
      const bool fsrc = pclean_dt_float(sd[8]);
      const int64_t vi = w > 0 && !fsrc ? pclean_ld_i(sd[7], sd[8], s) : 0;
      const float vf = w > 0 ? (float)pclean_ld_f(sd[7], sd[8], s) : 0.0f;
      code_max(h[6], h[7], t, fsrc ? (int64_t)vf : vi, fsrc ? vf : (float)vi);
    }
  }
}

__device__ __forceinline__ long long block_sum(long long v, long long* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  long long r = 0;
  if (threadIdx.x == 0)
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) r += sh[k];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(K14_THREADS)
    cascade_kernel(const __grid_constant__ K14Plan plan) {
  __shared__ long long sh[K14_THREADS / 32];
  const int64_t* h = plan.w;
  const int64_t c = h[1];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  long long d = 0, flip = 0;
  if (i < c) {
    d = reinterpret_cast<const int*>(h[2])[i];
    const int rc = reinterpret_cast<const int*>(h[3])[i] + (int)d;
    const int was = reinterpret_cast<const uint8_t*>(h[4])[i] != 0;
    const int now = rc > 0;
    if (h[5] != 0) {   // a later group's launch writes only its flips
      reinterpret_cast<int*>(h[5])[i] = rc;
      reinterpret_cast<uint8_t*>(h[6])[i] = (uint8_t)now;
    }
    flip = now - was;
    if (flip != 0)
      for (int f = 0; f < (int)h[8]; ++f) {
        const int64_t* fk = h + K14_HEAD + 4 * f;
        const int64_t t = drop_index(pclean_ld_i(fk[0], fk[1], i), fk[3]);
        if (t >= 0) atomicAdd(reinterpret_cast<int*>(fk[2]) + t, (int)flip);
      }
  }
  if (h[7] == 0) return;   // block-uniform: no barrier is skipped by half
  const long long sd = block_sum(d, sh), sf = block_sum(flip, sh);
  if (threadIdx.x == 0) {
    unsigned long long* acc = reinterpret_cast<unsigned long long*>(h[7]);
    if (sd) atomicAdd(acc, (unsigned long long)sd);
    if (sf) atomicAdd(acc + 1, (unsigned long long)sf);
  }
}

}  // namespace

// words: the plan (ops.rel_scatter's or ops.rel_cascade's words), n_words
// <= K14_WORDS. Scatter mode (words[0] = 0): [0, n, slots or 0, slots
// dtype, source length, cnt (int32), code or 0, code dtype, C, exclude
// pointer (int64 [1]) or 0, exclude value, 1 where the value holds,
// sides, 0, 0, 0], then each side: [sign, hops, alive (bool) or 0, state
// or 0, its dtype, weight or 0, its dtype, code source or 0, its dtype,
// 1 where the exclusion applies, 0 x 6, then each hop (column, dtype,
// length)]. Cascade mode (words[0] = 1): [1, C, d (int32), refcount
// (int32), alive (bool), refcount out, alive out, acc (int64 [2]), fks,
// 0 x 7], then each fk (column, dtype, pending delta (int32), its
// length); refcount out, alive out and acc all 0: only the flips are
// scattered (the later launches of a class with more than K14_MAX_FKS fk
// columns, ops.cascade_groups). 256 threads a block. Returns cudaErrorInvalidValue for a plan
// it does not take, else cudaGetLastError() after the launch.
extern "C" int pclean_rel_scatter(const int64_t* words, int n_words,
                                  void* stream) {
  if (n_words < K14_HEAD || n_words > K14_WORDS)
    return (int)cudaErrorInvalidValue;
  K14Plan plan;
  for (int i = 0; i < K14_WORDS; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  const int64_t mode = words[0], n = words[1];
  if (n <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + K14_THREADS - 1) / K14_THREADS);
  if (mode == 0) {
    const int64_t sides = words[12];
    if (sides < 1 || sides > K14_MAX_SIDES ||
        n_words < K14_HEAD + K14_SIDE * sides || words[5] == 0 ||
        words[8] <= 0 || words[4] <= 0)
      return (int)cudaErrorInvalidValue;
    for (int k = 0; k < sides; ++k) {
      const int64_t hops = words[K14_HEAD + K14_SIDE * k + 1];
      if (hops < 0 || hops > K14_MAX_HOPS) return (int)cudaErrorInvalidValue;
    }
    scatter_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(plan);
  } else if (mode == 1) {
    if (words[8] < 0 || words[8] > K14_MAX_FKS ||
        n_words < K14_HEAD + 4 * words[8])
      return (int)cudaErrorInvalidValue;
    cascade_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(plan);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
