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
// fk and an alive byte a source (about 5 MB, 1.5 us at 3.35 TB/s) and
// writes C counts; crowded targets (many sources of one entity) queue
// their atomics in L2: scaled's refcount puts about 800,000 adds on 11,264
// addresses, some 70 on each, one L2 line a lane.
//
// Design. The plan is passed by value: pointers, dtypes, lengths and the
// chain of up to K14_MAX_HOPS columns, so no table lives on the card and
// nothing is copied before the launch. ops.rel_scatter_plan picks one of
// two routes of scatter mode:
//   * thread: a thread a source, 256 a block; a side's loads (alive,
//     state, weight, code source, the first hop) all issued before
//     anything tests them, the later hops a chain (a delta's second side
//     after its first side's atomic: issuing both sides' loads together
//     measured slower on a delta into 128 crowded targets);
//   * local (a histogram in shared memory), for a refcount-shaped spec
//     with many sources a target (hist_kernel): a block of 1,024 threads
//     on each multiprocessor, all C counts in its shared memory, the
//     sources read through a grid-stride loop in 16-byte vectors, one
//     shared-memory atomic a source and one global atomic a nonzero bin a
//     block, a warp's 32 bins on one L2 line.
// Thread-block clusters sharing one histogram through distributed shared
// memory, and the generic spec (state, weight, codes, slots) on a
// histogram, were built and measured slower on the H100 (PERF.md section
// 6): bulk reads of another block's shared memory cost more than the
// global atomics they save.
// Cascade mode (a thread a slot) reads d, refcount and alive in one
// round and an fk column only where the slot's alive bit flips (reading
// every fk column in the same round measured 0.0002-0.0003 ms slower at
// every cascade census shape), reduces d and flip in the block and adds
// them with one atomic a block. A delta whose code needs `code =
// where(cnt > 0, code, 0)` between its subtract and its add is two
// launches (ops.rel_scatter's caller runs the where between them).

#include <cuda_runtime.h>
#include <limits.h>

#include "row_words.cuh"

#define K14_MAX_HOPS 4
#define K14_MAX_SIDES 2
#define K14_MAX_FKS 8
#define K14_HEAD 16
#define K14_SIDE (16 + 3 * K14_MAX_HOPS)
#define K14_WORDS (K14_HEAD + K14_MAX_SIDES * K14_SIDE)
#define K14_THREADS 256
#define K14_HIST_THREADS 1024
#define K14_UNIT 4
// dynamic shared memory a histogram block may take (an H100 block's 227 KB
// less room for the runtime's own)
#define K14_SMEM_MAX (232448 - 1024)

namespace {

enum { kThread = 0, kLocal = 1 };

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

// One side's loads at one source, issued before any is used.
struct Src {
  int64_t st, wt, cv, t;
  float cf;
  int a;
};

__device__ __forceinline__ bool side_code(const int64_t* h, const int64_t* sd) {
  return h[6] != 0 && sd[7] != 0;
}

__device__ __forceinline__ Src load_src(const int64_t* sd, int64_t s,
                                        bool code) {
  Src r;
  r.a = sd[2] ? reinterpret_cast<const uint8_t*>(sd[2])[s] : 1;
  r.st = sd[3] ? pclean_ld_i(sd[3], sd[4], s) : 1;
  r.wt = sd[5] ? pclean_ld_i(sd[5], sd[6], s) : 1;
  r.cv = 0;
  r.cf = 0.0f;
  if (code) {
    if (pclean_dt_float(sd[8]))
      r.cf = (float)pclean_ld_f(sd[7], sd[8], s);
    else
      r.cv = pclean_ld_i(sd[7], sd[8], s);
  }
  r.t = sd[1] > 0 ? pclean_ld_i(sd[16], sd[17], pclean_clamp(s, sd[18])) : s;
  return r;
}

// The weight of a loaded side at source s (0: the source adds nothing).
__device__ __forceinline__ int64_t side_weight(const int64_t* sd,
                                               const Src& r, int64_t s,
                                               bool has_excl, int64_t excl) {
  int64_t w = 1;
  if (!r.a) w = 0;
  if (sd[3] && r.st != 1) w = 0;
  if (sd[9] && has_excl && s == excl) w = 0;
  if (w && sd[5]) w *= r.wt;
  return w;
}

// The side's target from its first hop's value: the later hops (a chain of
// dependent loads, each index clamped as take() clamps it), then the drop
// rule; -1 where it drops.
__device__ __forceinline__ int64_t side_target(const int64_t* sd, int64_t t,
                                               int64_t c) {
  for (int j = 1; j < (int)sd[1]; ++j) {
    const int64_t* hp = sd + 16 + 3 * j;
    t = pclean_ld_i(hp[0], hp[1], pclean_clamp(t, hp[2]));
  }
  return drop_index(t, c);
}

// The code value a source with weight w puts at its target, as the code's
// dtype reads it (vi for an integer code, vf for a float one).
__device__ __forceinline__ void code_value(const int64_t* sd, const Src& r,
                                           int64_t w, int64_t* vi, float* vf) {
  const bool fsrc = pclean_dt_float(sd[8]);
  *vi = w > 0 ? (fsrc ? (int64_t)r.cf : r.cv) : 0;
  *vf = w > 0 ? (fsrc ? r.cf : (float)r.cv) : 0.0f;
}

// The excluded source slot: a value in the plan or an int64 on the card.
__device__ __forceinline__ int64_t exclusion(const int64_t* h, bool* has) {
  *has = h[9] != 0 || h[11] != 0;
  return h[9] ? reinterpret_cast<const int64_t*>(h[9])[0] : h[10];
}

__global__ void __launch_bounds__(K14_THREADS)
    scatter_kernel(const __grid_constant__ K14Plan plan) {
  const int64_t* h = plan.w;
  const int64_t n = h[1];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool has_excl;
  const int64_t excl = exclusion(h, &has_excl);
  const int64_t s = h[2] ? pclean_clamp(pclean_ld_i(h[2], h[3], i), h[4]) : i;
  const int sides = (int)h[12];
  int* cnt = reinterpret_cast<int*>(h[5]);
  // a side at a time: its loads in one round, then its adds, so that a
  // delta's first side's atomics drain while its second side's loads fly
  for (int k = 0; k < sides; ++k) {
    const int64_t* sd = h + K14_HEAD + K14_SIDE * k;
    const bool code = side_code(h, sd);
    const Src r = load_src(sd, s, code);
    const int64_t w = side_weight(sd, r, s, has_excl, excl);
    if (w == 0 && !code) continue;
    const int64_t t = side_target(sd, r.t, h[8]);
    if (t < 0) continue;
    if (w != 0) atomicAdd(cnt + t, (int)(sd[0] * w));
    if (code) {
      int64_t vi;
      float vf;
      code_value(sd, r, w, &vi, &vf);
      code_max(h[6], h[7], t, vi, vf);
    }
  }
}

// The histogram route (ops.rel_scatter_plan's "local"): a refcount-shaped
// spec (one side: alive, the exclusion, one int32 or int64 fk column, no
// state, weight, code or slots). Each block keeps all C counts in shared
// memory; a grid-stride loop over units of K14_UNIT (a multiple of 4)
// consecutive sources (the alive bytes in 4-byte loads, the fk column in
// 16-byte loads, every load of a unit issued before any is used) adds
// each counted source into its block's bins; then the block adds each
// nonzero bin to cnt with one atomic, consecutive threads on consecutive
// bins.
__global__ void __launch_bounds__(K14_HIST_THREADS)
    hist_kernel(const __grid_constant__ K14Plan plan) {
  extern __shared__ __align__(16) int k14_bins[];
  const int64_t* h = plan.w;
  const int64_t* sd = h + K14_HEAD;
  const int64_t n = h[1];
  const int C = (int)h[8], add = (int)sd[0];
  const uint8_t* alive = reinterpret_cast<const uint8_t*>(sd[2]);
  const int64_t col = sd[16], dt = sd[17], len = sd[18];
  for (int j = threadIdx.x; j < C; j += blockDim.x) k14_bins[j] = 0;
  bool has_excl;
  const int64_t excl = exclusion(h, &has_excl);
  const bool ex = has_excl && sd[9] != 0;
  __syncthreads();
  // vectors where the columns are aligned (uniform: a unit starts at a
  // multiple of K14_UNIT) and the unit is whole
  const bool aligned = !(col & 15) && !((int64_t)alive & 3);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * K14_UNIT;
  for (int64_t u = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) *
                   K14_UNIT;
       u < n; u += stride) {
    int a[K14_UNIT];
    int64_t t[K14_UNIT];
    if (aligned && u + K14_UNIT <= n && u + K14_UNIT <= len) {
      // every load of the unit, straight-line, before any is used
      if (dt == PCLEAN_DT_I32) {
#pragma unroll
        for (int g = 0; g < K14_UNIT; g += 4) {
          const int4 x = *reinterpret_cast<const int4*>(col + 4 * (u + g));
          t[g] = x.x; t[g + 1] = x.y; t[g + 2] = x.z; t[g + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < K14_UNIT; g += 2) {
          const longlong2 x =
              *reinterpret_cast<const longlong2*>(col + 8 * (u + g));
          t[g] = x.x; t[g + 1] = x.y;
        }
      }
#pragma unroll
      for (int g = 0; g < K14_UNIT; g += 4) {
        const uchar4 x =
            alive ? *reinterpret_cast<const uchar4*>(alive + u + g)
                  : make_uchar4(1, 1, 1, 1);
        a[g] = x.x; a[g + 1] = x.y; a[g + 2] = x.z; a[g + 3] = x.w;
      }
    } else {   // the tail, or unaligned columns: one by one
#pragma unroll
      for (int j = 0; j < K14_UNIT; ++j) {
        const int64_t s = u + j < n ? u + j : n - 1;
        t[j] = pclean_ld_i(col, dt, pclean_clamp(s, len));
        a[j] = !alive || (u + j < n && alive[s]);
      }
    }
#pragma unroll
    for (int j = 0; j < K14_UNIT; ++j) {
      const int64_t tt = drop_index(t[j], C);
      if (u + j < n && a[j] && !(ex && u + j == excl) && tt >= 0)
        atomicAdd(k14_bins + tt, add);
    }
  }
  __syncthreads();
  int* cnt = reinterpret_cast<int*>(h[5]);
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const int v = k14_bins[j];
    if (v != 0) atomicAdd(cnt + j, v);
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

// The specs the histogram route takes (hist_kernel's note).
bool hist_spec(const int64_t* words) {
  const int64_t* sd = words + K14_HEAD;
  return words[12] == 1 && words[2] == 0 && sd[1] == 1 && sd[3] == 0 &&
         sd[5] == 0 && (words[6] == 0 || sd[7] == 0) &&
         (sd[17] == PCLEAN_DT_I32 || sd[17] == PCLEAN_DT_I64);
}

cudaError_t launch_hist(const K14Plan& plan, int64_t blocks, int64_t smem,
                        cudaStream_t st) {
  static int64_t smem_set = 48 * 1024;   // shared memory past 48 KB, once
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  hist_kernel<<<(unsigned)blocks, K14_HIST_THREADS, (size_t)smem, st>>>(plan);
  return cudaGetLastError();
}

}  // namespace

// words: the plan (ops.rel_scatter's or ops.rel_cascade's words), n_words
// <= K14_WORDS. Scatter mode (words[0] = 0): [0, n, slots or 0, slots
// dtype, source length, cnt (int32), code or 0, code dtype, C, exclude
// pointer (int64 [1]) or 0, exclude value, 1 where the value holds,
// sides, route (0 thread, 1 local: ops.rel_scatter_plan), 0, blocks (the
// local route's)], then each side: [sign, hops, alive (bool) or 0, state
// or 0, its dtype, weight or 0, its dtype, code source or 0, its dtype, 1
// where the exclusion applies, 0 x 6, then each hop (column, dtype,
// length)]. Cascade mode (words[0] = 1): [1, C, d (int32), refcount
// (int32), alive (bool), refcount out, alive out, acc (int64 [2]), fks,
// 0 x 7], then each fk (column, dtype, pending delta (int32), its
// length); refcount out, alive out and acc all 0: only the flips are
// scattered (the later launches of a class with more than K14_MAX_FKS fk
// columns, ops.cascade_groups). Returns cudaErrorInvalidValue for a plan
// it does not take, else the launch's error or cudaGetLastError() after
// it.
extern "C" int pclean_rel_scatter(const int64_t* words, int n_words,
                                  void* stream) {
  if (n_words < K14_HEAD || n_words > K14_WORDS)
    return (int)cudaErrorInvalidValue;
  K14Plan plan;
  for (int i = 0; i < K14_WORDS; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  const int64_t mode = words[0], n = words[1];
  if (n <= 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + K14_THREADS - 1) / K14_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    const int64_t sides = words[12], route = words[13];
    if (sides < 1 || sides > K14_MAX_SIDES ||
        n_words < K14_HEAD + K14_SIDE * sides || words[5] == 0 ||
        words[8] <= 0 || words[4] <= 0 || route < kThread || route > kLocal)
      return (int)cudaErrorInvalidValue;
    for (int k = 0; k < sides; ++k) {
      const int64_t* sd = words + K14_HEAD + K14_SIDE * k;
      if (sd[1] < 0 || sd[1] > K14_MAX_HOPS) return (int)cudaErrorInvalidValue;
    }
    if (route == kThread) {
      scatter_kernel<<<blocks, K14_THREADS, 0, st>>>(plan);
      return (int)cudaGetLastError();
    }
    const int64_t hb = words[15], smem = words[8] * 4;
    if (!hist_spec(words) || hb < 1 || hb > INT_MAX || smem > K14_SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    return (int)launch_hist(plan, hb, smem, st);
  } else if (mode == 1) {
    if (words[8] < 0 || words[8] > K14_MAX_FKS ||
        n_words < K14_HEAD + 4 * words[8])
      return (int)cudaErrorInvalidValue;
    cascade_kernel<<<blocks, K14_THREADS, 0, st>>>(plan);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
