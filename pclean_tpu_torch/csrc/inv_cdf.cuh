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
//
// K16 and K17 draw in the geometry ops.draw_plan picks for the row (K2
// keeps draw_row): "block" and "stream" are draw_row above; "warp"
// (draw_warp) is one warp a row with no block barrier, each lane a run of
// the row's 16-byte words, the max and the exclusive scan of the lanes'
// fixed-point sums by shuffles, then the warp walks the bracketing lane's
// run 32 entries a step; "cluster" (draw_cluster) splits one row over a
// thread-block cluster, the blocks' maxima and fixed-point totals meeting
// in distributed shared memory, and the block whose slice brackets the
// threshold walks it. All four take the same max, the same q = rn(p 2^32)
// of the same expf, integer sums and the same double threshold, so each
// returns the first entry whose exact prefix reaches it: K2's index.
#pragma once

#include <cooperative_groups.h>

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

// ---------------------------------------------------------------- geometries

namespace cg = cooperative_groups;

// ops.DRAW_GEOMETRIES, in order
enum { kGeomWarp = 0, kGeomBlock = 1, kGeomCluster = 2, kGeomStream = 3 };
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float entry(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ u64 warp_scan_incl(u64 x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Rows of a warp-a-row launch a block takes: up to 16, fewer where B
// rows would leave SMs without two blocks each (ops.draw_plan's rows).
__host__ __device__ __forceinline__ int64_t warp_rows(int64_t B) {
  const int64_t r = (B + 263) / 264;
  return r < 1 ? 1 : r > kWarps ? kWarps : r;
}

constexpr int kWarpHold = 4;  // 16-byte words a lane loads at once

// The max of m and the entries of word v (entries e .. e + 3) in [0, K).
__device__ __forceinline__ float word_max(const float4& v, int64_t e,
                                          int64_t K, float m) {
  if (e >= 0 && e + 4 <= K)
    return fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e + j >= 0 && e + j < K) m = fmaxf(m, entry(v, j));
  return m;
}

// The sum of q over the entries of word v in [0, K).
__device__ __forceinline__ u64 word_mass(const float4& v, int64_t e,
                                         int64_t K, float m) {
  u64 s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e + j >= 0 && e + j < K) s += quant(expf(entry(v, j) - m));
  return s;
}

// The draw of x[0, K) at u by the 32 lanes of one warp (every lane calls
// it and gets the index), no block barrier. The row is read as the 16-byte
// words of its aligned grid (word w holds entries 4w - phase .. 4w - phase
// + 3; an aligned word never leaves the allocation's 16-byte granules, and
// entries outside [0, K) are left out); lane l owns the run of words [l cw,
// (l + 1) cw), loaded kWarpHold at a time so that their loads overlap (a
// run of at most kWarpHold words stays in registers for both passes).
// Pass 1 takes the max, pass 2 each lane's sum of q (an L1 read again
// where the run is longer), a shuffle scan places the runs, and the warp
// walks the one run that brackets the threshold 32 entries a step, each
// step a shuffle scan of the step's q's from the run's start.
__device__ __forceinline__ int64_t draw_warp(const float* __restrict__ x,
                                             int64_t K, float u) {
  const int lane = threadIdx.x & 31;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const int phase = (int)((addr >> 2) & 3);
  const float4* a4 = reinterpret_cast<const float4*>(addr - 4 * phase);
  const int64_t W = (K + phase + 3) >> 2;
  const int64_t cw = (W + 31) >> 5;
  const int64_t w0 = (int64_t)lane * cw < W ? (int64_t)lane * cw : W;
  const int64_t w1 = w0 + cw < W ? w0 + cw : W;
  const float one_minus_u = 1.0f - u;
  float4 v[kWarpHold];
  float m = -INFINITY;
  for (int64_t w = w0; w < w1; w += kWarpHold) {
#pragma unroll
    for (int k = 0; k < kWarpHold; ++k)
      if (w + k < w1) v[k] = __ldg(a4 + w + k);
#pragma unroll
    for (int k = 0; k < kWarpHold; ++k)
      if (w + k < w1) m = word_max(v[k], 4 * (w + k) - phase, K, m);
  }
  m = pclean_warp_max(m);
  u64 s = 0;
  if (cw <= kWarpHold) {   // the run is still in v
#pragma unroll
    for (int k = 0; k < kWarpHold; ++k)
      if (w0 + k < w1) s += word_mass(v[k], 4 * (w0 + k) - phase, K, m);
  } else {
    for (int64_t w = w0; w < w1; w += kWarpHold) {
#pragma unroll
      for (int k = 0; k < kWarpHold; ++k)
        if (w + k < w1) v[k] = __ldg(a4 + w + k);
#pragma unroll
      for (int k = 0; k < kWarpHold; ++k)
        if (w + k < w1) s += word_mass(v[k], 4 * (w + k) - phase, K, m);
    }
  }
  const u64 incl = warp_scan_incl(s);
  const u64 total = __shfl_sync(kFull, incl, 31);
  const u64 start = incl - s;
  const double ub = (double)one_minus_u * (double)total;
  if (!(ub > 0.0)) return 0;
  const unsigned hit = __ballot_sync(
      kFull, (double)start < ub && ub <= (double)(start + s));
  const int src = hit ? __ffs(hit) - 1 : 31;
  u64 r = __shfl_sync(kFull, start, src);
  const int64_t sw0 = (int64_t)src * cw < W ? (int64_t)src * cw : W;
  const int64_t sw1 = sw0 + cw < W ? sw0 + cw : W;
  const int64_t lo = 4 * sw0 - phase > 0 ? 4 * sw0 - phase : 0;
  const int64_t hi = 4 * sw1 - phase < K ? 4 * sw1 - phase : K;
  for (int64_t e0 = lo; e0 < hi; e0 += 32) {
    const int64_t e = e0 + lane;
    const u64 q = e < hi ? quant(expf(x[e] - m)) : 0ull;
    const u64 c = warp_scan_incl(q);
    const unsigned h = __ballot_sync(kFull, e < hi && (double)(r + c) >= ub);
    if (h) return e0 + __ffs(h) - 1;
    r += __shfl_sync(kFull, c, 31);
  }
  return hi - 1;
}

// The entries of one row a block of a cluster holds: a multiple of 4, so
// every slice keeps the row's 16-byte phase (ops.draw_plan's slice).
__host__ __device__ __forceinline__ int64_t cluster_slice(int64_t K, int C) {
  return (((K + C - 1) / C) + 3) & ~(int64_t)3;
}

// barrier.cluster's phases: arrive (relaxed) early, wait before the first
// write into another block's shared memory, so that every block of the
// cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Each block's `v` into slot `rank` of `arr` in every block of the cluster
// (thread 0 writes), then a cluster barrier (release, acquire): after it
// every block reads all C values from its own shared memory.
template <class T>
__device__ __forceinline__ void cluster_share(cg::cluster_group& cl, T v,
                                              T* arr) {
  const unsigned C = cl.num_blocks(), rank = cl.block_rank();
  if (threadIdx.x == 0)
    for (unsigned j = 0; j < C; ++j) *cl.map_shared_rank(&arr[rank], j) = v;
  cl.sync();
}

// Cluster-shared scratch of draw_cluster and the cluster reductions.
struct ClusterSh {
  float m[kMaxCluster];
  u64 t[kMaxCluster];
  int64_t i[kMaxCluster];
  int64_t j[kMaxCluster];
  int32_t drawn;
};

// The draw of x[0, K) at u by a cluster of C blocks of kThreads (every
// thread of every block calls it, after cluster_arrive_relaxed): block r
// loads its slice [r L, r L + L) of L = cluster_slice(K, C) entries into
// buf4 (draw_row's steps 1-2 over the slice), the blocks' maxima meet in
// distributed shared memory, then their fixed-point totals; the one thread
// whose chunk brackets the threshold (thread 0 of rank 0 where the total
// is 0) writes the index to *out, or, with kShare, into every block's
// cs->drawn, read by every thread after the closing cluster barrier.
template <bool kShare>
__device__ __forceinline__ void draw_cluster(const float* __restrict__ x,
                                             int64_t K, float u, float4* buf4,
                                             float* shf, u64* shs,
                                             ClusterSh* cs, int32_t* out) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int64_t L = cluster_slice(K, C);
  const int64_t lo = (int64_t)rank * L < K ? (int64_t)rank * L : K;
  const int64_t n = (lo + L < K ? lo + L : K) - lo;
  const float* xs = x + lo;
  const int phase = (int)((reinterpret_cast<uintptr_t>(xs) >> 2) & 3);
  float* sp = reinterpret_cast<float*>(buf4) + phase;
  const float one_minus_u = 1.0f - u;
  const float bm = pclean_block_max(load_row(xs, n, sp, (4 - phase) & 3), shf);
  cluster_wait();
  cluster_share(cl, bm, cs->m);
  float m = -INFINITY;
  for (int j = 0; j < C; ++j) m = fmaxf(m, cs->m[j]);
  int64_t clo, chi;
  const u64 s = chunk_mass(sp, n, m, &clo, &chi);
  u64 bt;
  const u64 start = block_scan_excl(s, shs, &bt);
  cluster_share(cl, bt, cs->t);
  u64 before = 0, total = 0;
  for (int j = 0; j < C; ++j) {
    if (j < rank) before += cs->t[j];
    total += cs->t[j];
  }
  const double ub = (double)one_minus_u * (double)total;
  int64_t idx = -1;
  if (!(ub > 0.0)) {
    if (rank == 0 && threadIdx.x == 0) idx = 0;
  } else {
    const u64 st = before + start;
    if ((double)st < ub && ub <= (double)(st + s))
      idx = lo + walk(sp, clo, chi, st, ub);
  }
  if (kShare) {
    if (idx >= 0)
      for (int j = 0; j < C; ++j)
        *cl.map_shared_rank(&cs->drawn, j) = (int32_t)idx;
    cl.sync();
  } else if (idx >= 0) {
    *out = (int32_t)idx;
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
