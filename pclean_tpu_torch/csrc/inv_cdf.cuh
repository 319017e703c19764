// The inverse-CDF draw of one row by one block, shared by K2
// inv_cdf_sample, K16 fk_sample and K17 choice_sample, so a draw inside
// K16 or K17 gives the same index as K2 on the same row and uniform.
//
// Replaces pclean_tpu/engine/propose.py _inv_cdf_from_u (propose.py:
// 1153-1172): m = max(logits), p = exp(logits - m), c = cumsum(p),
// idx = #{i : c[i] < (1 - u) * c[-1]}.
// The threshold lies in (0, total], never [0, total): at 0 every test
// c < t is false and index 0 would be drawn even with zero mass (a dead fk
// candidate slot); the (0, total] form also keeps trailing zero-mass
// entries unselectable (their prefix equals total).
//
// Exact prefix sums. Each p in [0, 1] is rounded once to a 64-bit fixed-
// point integer q = rn(p * 2^32), and every sum below is an integer sum, so
// it is exact and the same in any order. That lets the block scan its chunk
// sums in log steps and still keep the draw safe: the prefix sequence is
// monotone, it ends exactly at the total, a zero-mass entry adds exactly 0
// (so its prefix equals its predecessor's and it can never be the first to
// reach the threshold), and the threshold (1 - u) * total, taken in double
// (every prefix is < 2^53, exact in double), lies in (0, total]. Dead slots
// (NEG_INF logits) have p = 0 exactly and are never drawn. The rounding
// moves a prefix by at most K * 2^-33 of a total >= 1 (the max entry has
// p = 1), about 1e-6 at K ~ 11k, so a draw differs from torch.cumsum's
// only where the uniform sits that close to a boundary; chip_smoke.py
// states the mismatch it allows. K is limited to 2^21 entries (the total
// stays below 2^53).
//
// Design (one block of kThreads = 512 threads per row):
// 1. The row is read once, by 16-byte loads (a scalar head and tail around
//    the 16-byte-aligned body) into dynamic shared memory, placed at the
//    same alignment phase so the float4 stores are aligned; the max is taken
//    on the way and finished with warp shuffles.
// 2. Each thread owns one contiguous chunk of the row; the chunk length is
//    odd, so the 32 lanes of a warp read 32 different banks. It writes
//    p = exp(x - m) back into shared memory once and sums its q's.
// 3. A block exclusive scan of the chunk sums by warp shuffles (log steps)
//    gives each chunk's start; the one thread whose chunk brackets the
//    threshold, start < t <= start + sum, walks that chunk alone with the
//    same additions and writes the index.
// Rows too long for shared memory (the plan gives a tile shorter than K)
// stream through it in tiles instead: a pass over device memory for the
// max, one for the exact total (order does not matter), then tile by tile
// steps 1-3 with the scan carried across tiles, stopping at the tile that
// holds the threshold. Both give the same index for the same row, and the
// index does not depend on the row's address.
#pragma once

#include "common.cuh"

namespace pclean_draw {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kScale = 4294967296.0f;  // 2^32

typedef unsigned long long u64;

__device__ __forceinline__ u64 quant(float p) {
  return __float2ull_rn(p * kScale);
}

// Odd chunk length covering n entries with kThreads chunks.
__device__ __forceinline__ int64_t chunk_len(int64_t n) {
  return ((n + kThreads - 1) / kThreads) | 1;
}

// Block exclusive scan of one value per thread (warp shuffles, then the
// warp totals scanned by warp 0). `sh` holds >= kWarps + 1 values.
__device__ __forceinline__ u64 block_scan_excl(u64 v, u64* sh, u64* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    u64 t = lane < kWarps ? sh[lane] : 0ull;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) sh[lane] = t;
    if (lane == kWarps - 1) sh[kWarps] = t;
  }
  __syncthreads();
  const u64 excl = x - v + (warp > 0 ? sh[warp - 1] : 0ull);
  *total = sh[kWarps];
  __syncthreads();
  return excl;
}

// Copy x[0, n) into sp[0, n) (x and sp at the same 16-byte phase), returns
// this thread's max over what it copied.
__device__ __forceinline__ float load_row(const float* __restrict__ x,
                                          int64_t n, float* sp, int head) {
  const int tid = threadIdx.x;
  float m = -INFINITY;
  const int64_t h = head < n ? head : n;
  if (tid < h) {
    const float v = x[tid];
    sp[tid] = v;
    m = v;
  }
  const int64_t nvec = (n - h) / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x + h);
  float4* s4 = reinterpret_cast<float4*>(sp + h);
  for (int64_t i = tid; i < nvec; i += kThreads) {
    const float4 v = __ldg(x4 + i);
    s4[i] = v;
    m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
  for (int64_t i = h + 4 * nvec + tid; i < n; i += kThreads) {
    const float v = x[i];
    sp[i] = v;
    m = fmaxf(m, v);
  }
  return m;
}

// Step 2 on sp[0, n): p written back in place over this thread's chunk
// [lo, hi), returns the chunk's sum of q.
__device__ __forceinline__ u64 chunk_mass(float* sp, int64_t n, float m,
                                          int64_t* lo, int64_t* hi) {
  const int64_t c = chunk_len(n);
  *lo = (int64_t)threadIdx.x * c;
  *hi = *lo + c < n ? *lo + c : n;
  u64 s = 0;
  for (int64_t i = *lo; i < *hi; ++i) {
    const float p = expf(sp[i] - m);
    sp[i] = p;
    s += quant(p);
  }
  return s;
}

// Step 3: the first entry of [lo, hi) whose prefix reaches ub.
__device__ __forceinline__ int64_t walk(const float* sp, int64_t lo,
                                        int64_t hi, u64 start, double ub) {
  u64 r = start;
  int64_t i = lo;
  for (; i < hi - 1; ++i) {
    r += quant(sp[i]);
    if ((double)r >= ub) break;
  }
  return i;
}

// The draw of the row x[0, K) at the uniform u, by every thread of a block
// of kThreads: one thread writes the index to *out (thread 0 where the
// total is 0), then every thread returns; *out is read after a
// __syncthreads. buf4: the dynamic shared memory, (min(tile, K) + 4)
// floats; tile >= K reads the row once, a shorter tile (a multiple of 4)
// streams it. shf: >= 33 floats, shs: >= kWarps + 1 values of shared
// memory.
__device__ __forceinline__ void draw_row(const float* __restrict__ x,
                                         int64_t K, int64_t tile, float u,
                                         float4* buf4, float* shf, u64* shs,
                                         int32_t* out) {
  const int tid = threadIdx.x;
  // x's phase in floats; sp[i] and x + i are 16-byte aligned together
  const int phase = (int)((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const int head = (4 - phase) & 3;
  float* sp = reinterpret_cast<float*>(buf4) + phase;
  const float one_minus_u = 1.0f - u;

  if (K <= tile) {
    const float m = pclean_block_max(load_row(x, K, sp, head), shf);
    int64_t lo, hi;
    const u64 s = chunk_mass(sp, K, m, &lo, &hi);
    u64 total;
    const u64 start = block_scan_excl(s, shs, &total);
    const double ub = (double)one_minus_u * (double)total;
    if (!(ub > 0.0)) {
      if (tid == 0) *out = 0;
      return;
    }
    if ((double)start < ub && ub <= (double)(start + s))
      *out = (int32_t)walk(sp, lo, hi, start, ub);
    return;
  }

  // streamed: max, exact total, then tile by tile
  float m = -INFINITY;
  for (int64_t i = tid; i < K; i += kThreads) m = fmaxf(m, x[i]);
  m = pclean_block_max(m, shf);
  u64 q = 0;
  for (int64_t i = tid; i < K; i += kThreads) q += quant(expf(x[i] - m));
  u64 total;
  block_scan_excl(q, shs, &total);
  const double ub = (double)one_minus_u * (double)total;
  if (!(ub > 0.0)) {
    if (tid == 0) *out = 0;
    return;
  }
  u64 carry = 0;
  for (int64_t t0 = 0; t0 < K; t0 += tile) {
    const int64_t n = K - t0 < tile ? K - t0 : tile;
    load_row(x + t0, n, sp, head);  // tile is a multiple of 4: same phase
    __syncthreads();
    int64_t lo, hi;
    const u64 s = chunk_mass(sp, n, m, &lo, &hi);
    u64 tile_total;
    const u64 start = carry + block_scan_excl(s, shs, &tile_total);
    const bool hit = (double)start < ub && ub <= (double)(start + s);
    if (hit) *out = (int32_t)(t0 + walk(sp, lo, hi, start, ub));
    if (__syncthreads_or(hit)) return;
    carry += tile_total;
  }
}

// The plan checks of a draw's launch (ops.inv_cdf_plan): true when the
// kernel takes (K, tile, smem).
inline bool plan_ok(int64_t K, int64_t tile, int smem) {
  const int64_t held = tile < K ? tile : K;
  return K >= 1 && K <= (1ll << 21) && tile >= 4 &&
         (tile >= K || tile % 4 == 0) && (int64_t)smem == (held + 4) * 4;
}

// Raises `kernel`'s dynamic shared memory limit to smem where it is above
// the limit already set (`*limit`, a property of the function). Returns
// the error of the attribute call, else cudaSuccess.
template <class Kernel>
inline cudaError_t smem_attr(Kernel kernel, int smem, int* limit) {
  if (smem <= *limit) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *limit = smem;
  return e;
}

}  // namespace pclean_draw
