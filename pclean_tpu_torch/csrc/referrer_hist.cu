// K7 referrer_hist: referrer-observation histograms of a latent class's
// AddTypos externals,
//   out[g_r, v_r] += 1      over the referrers r with w_r set,
// dropping any r whose g or v lies out of range. Two forms:
//   * hoisted: out [cap, V], g_r the swept slot that referrer r's fk chain
//     leads to (the kernel chases the hop columns itself: g = col0[r], then
//     g = col_h[clamp(g)] for each later hop, clamped like the JAX gathers),
//     val and w [N] over every source row. Replaces the `.at[t, val].add(...,
//     mode="drop")` of referrer_histograms in
//     pclean_tpu/engine/propose.py:1378-1400, once per sweep segment;
//   * per row: out [B, V], g_r = b, a batch row, over row b's R referrers
//     (w [B, R], val [1 or B, R]: the dense source axis or the row's
//     compacted list). Replaces the in-step `hist` scatter of
//     _ext_hist_term (propose.py:762-763, :807-808) where no hoisted
//     histogram exists (cap * V above the hoisting gate).
//
// Bound on the H100 (3.35 TB/s): bytes, and which bytes depends on the
// shape. Hoisted, the referrers (w 1 B, val and each hop column 4 B, about
// 1 MB at 100,000 Records) and the dense [cap, V] output: at the scaled
// path's [11,264, 1,832] the output's 82.5 MB, 0.025 ms, is nearly all of
// it; at the hospital path's [512, 111] the whole is about 1 MB, below the
// launch floor. Per row, at the scaled path's Hospital sweep: the [4,096,
// 100,000] mask, 410 MB, and the [4,096, 5,125] output, 84 MB: 0.15 ms.
//
// Design: the counts are integers below 2^24, exact in f32 whatever the
// order of addition, so any order of atomics is bit-equal to the plain
// version. The plan (ops.referrer_hist_plan) picks one of two routes by the
// counts that can land in each cell a privatising block would touch:
//   * sparse (below 2 a cell: scaled's and rents' hoisted histograms, a
//     row of a wide V, hospital's widest): no shared-memory tile; each set
//     referrer is read and chased once, by one thread, and added into the
//     output (zeroed by the wrapper, the only dense work) with one global
//     atomic. w is read in 16-byte words (pclean_walk in common.cuh, which
//     K8 shares): a warp skips a 512-referrer span with no set byte by one
//     ballot (the per-row masks are almost all empty), stages the span in
//     shared memory and gives lane l the
//     referrers 32 j + l (consecutive lanes on consecutive val and hop
//     entries); each lane issues the loads of its 16 referrers together,
//     hop by hop.
//   * private (2 or more a cell): each block counts one tile of up to
//     12,288 cells (48 KB of dynamic shared memory, sized to the tile)
//     over its chunk of referrers, a thread a referrer, then adds its
//     nonzero counters into the zeroed output with global atomics. The
//     hospital path's histograms crowd all 100,000 Records into the few
//     cells of its live slots (55 hospitals of 512, 18 counties of 128)
//     in random order; global atomics on those few addresses queue, and
//     measured on the H100 they lost to privatising from 2 counts a cell
//     of the whole output (seeded, evenly spread counts favour the sparse
//     route up to 32). Larger tiles were slower: one 222 KB tile a block
//     lost to five of 12,288 cells (one block an SM, long zeroing and
//     flushing).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHops = 8;
constexpr int kTileMax = 12288;  // cells of one private tile: 48 KB

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Hops {
  const int32_t* col[kMaxHops];
  int64_t len[kMaxHops];
  int n;
};

// The slot referrer r's fk chain leads to, clamped like the JAX gathers
// between hops; out of [0, cap) means dropped.
__device__ __forceinline__ int64_t chase(const Hops& hops, int64_t g) {
  for (int h = 1; h < hops.n; ++h) {
    const int64_t hi = hops.len[h] - 1;
    g = hops.col[h][g < 0 ? 0 : (g > hi ? hi : g)];
  }
  return g;
}

// Sparse route, hoisted form. Grid (chunks): block x reads referrers
// [x per, (x + 1) per).
__global__ void __launch_bounds__(kThreads)
referrer_hist_chase_sparse(Hops hops, const int32_t* __restrict__ val,
                           const uint8_t* __restrict__ w, int64_t N,
                           int64_t per, int64_t cap, int64_t V,
                           float* __restrict__ out) {
  __shared__ uint4 stage[kWarps][32];
  const int64_t r0 = (int64_t)blockIdx.x * per;
  pclean_walk<kWarps>(w, r0, min64(N, r0 + per), stage[threadIdx.x >> 5],
                      [&](int64_t rb, uint32_t set) {
         int64_t g[16];
         int32_t v[16];
#pragma unroll
         for (int j = 0; j < 16; ++j) {
           const bool on = (set >> j) & 1u;
           v[j] = on ? __ldg(val + rb + 32 * j) : -1;
           g[j] = on ? (int64_t)__ldg(hops.col[0] + rb + 32 * j) : -1;
         }
         for (int h = 1; h < hops.n; ++h) {
           const int64_t hi = hops.len[h] - 1;
#pragma unroll
           for (int j = 0; j < 16; ++j)
             if ((set >> j) & 1u)
               g[j] = __ldg(hops.col[h] +
                            (g[j] < 0 ? 0 : (g[j] > hi ? hi : g[j])));
         }
#pragma unroll
         for (int j = 0; j < 16; ++j)
           if (((set >> j) & 1u) && v[j] >= 0 && v[j] < V && g[j] >= 0 &&
               g[j] < cap)
             atomicAdd(out + g[j] * V + v[j], 1.0f);
       });
}

// Sparse route, per-row form. Grid (B, chunks): block (b, y) reads row b's
// referrers [y per, (y + 1) per).
__global__ void __launch_bounds__(kThreads)
referrer_hist_rows_sparse(const uint8_t* __restrict__ w,
                          const int32_t* __restrict__ val, int64_t val_rows,
                          int64_t R, int64_t per, int64_t V,
                          float* __restrict__ out) {
  __shared__ uint4 stage[kWarps][32];
  const int64_t b = blockIdx.x;
  const int32_t* vrow = val + (val_rows == 1 ? 0 : b * R);
  float* orow = out + b * V;
  const int64_t r0 = (int64_t)blockIdx.y * per;
  pclean_walk<kWarps>(w + b * R, r0, min64(R, r0 + per),
                      stage[threadIdx.x >> 5], [&](int64_t rb, uint32_t set) {
         int32_t v[16];
#pragma unroll
         for (int j = 0; j < 16; ++j)
           v[j] = ((set >> j) & 1u) ? __ldg(vrow + rb + 32 * j) : -1;
#pragma unroll
         for (int j = 0; j < 16; ++j)
           if (((set >> j) & 1u) && v[j] >= 0 && v[j] < V)
             atomicAdd(orow + v[j], 1.0f);
       });
}

__device__ __forceinline__ void zero_tile(int* sh, int64_t n) {
  for (int64_t i = threadIdx.x; i < n; i += kThreads) sh[i] = 0;
  __syncthreads();
}

// After the counting: adds the tile's nonzero counters into the zeroed
// output with global atomics.
__device__ __forceinline__ void flush_tile(const int* sh, int64_t n,
                                           float* __restrict__ out) {
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const int c = sh[i];
    if (c != 0) atomicAdd(out + i, (float)c);
  }
}

// Private route, hoisted form. Grid (chunks, tiles): block (x, y) counts
// tile y's cells over referrers [x per, (x + 1) per), a thread a referrer.
__global__ void __launch_bounds__(kThreads)
referrer_hist_chase_private(Hops hops, const int32_t* __restrict__ val,
                            const bool* __restrict__ w, int64_t N,
                            int64_t per, int64_t cap, int64_t V,
                            int64_t tile, float* __restrict__ out) {
  extern __shared__ int sh[];
  const int64_t lo = (int64_t)blockIdx.y * tile;
  const int64_t n = min64(tile, cap * V - lo);
  zero_tile(sh, n);
  const int64_t r0 = (int64_t)blockIdx.x * per;
  const int64_t r1 = min64(N, r0 + per);
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kThreads) {
    if (!w[r]) continue;
    const int64_t v = val[r];
    if (v < 0 || v >= V) continue;
    const int64_t g = chase(hops, hops.col[0][r]);
    if (g < 0 || g >= cap) continue;
    const int64_t cell = g * V + v - lo;
    if (cell >= 0 && cell < n) atomicAdd(sh + cell, 1);
  }
  flush_tile(sh, n, out + lo);
}

// Private route, per-row form. Grid (B, chunks, tiles): block (b, y, z)
// counts row b's cells of tile z over its referrers [y per, (y + 1) per).
__global__ void __launch_bounds__(kThreads)
referrer_hist_rows_private(const bool* __restrict__ w,
                           const int32_t* __restrict__ val, int64_t val_rows,
                           int64_t R, int64_t per, int64_t V, int64_t tile,
                           float* __restrict__ out) {
  extern __shared__ int sh[];
  const int64_t b = blockIdx.x;
  const int64_t lo = (int64_t)blockIdx.z * tile;
  const int64_t n = min64(tile, V - lo);
  zero_tile(sh, n);
  const bool* wrow = w + b * R;
  const int32_t* vrow = val + (val_rows == 1 ? 0 : b * R);
  const int64_t r0 = (int64_t)blockIdx.y * per;
  const int64_t r1 = min64(R, r0 + per);
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kThreads) {
    if (!wrow[r]) continue;
    const int64_t cell = (int64_t)vrow[r] - lo;
    if (cell >= 0 && cell < n) atomicAdd(sh + cell, 1);
  }
  flush_tile(sh, n, out + b * V + lo);
}

}  // namespace

// Hoisted form (per_row 0): hop_ptrs/hop_lens [n_hops] the fk columns of
// the chain in the order they are chased (the first indexed by the
// referrer, N = hop_lens[0] long), val [N] int32, w [N] bool, out [G = cap,
// V]. Per-row form (per_row 1, no hops): w [G = B, R] bool, val [val_rows,
// R] int32 (val_rows 1 or B), out [G, V]. All on the device and contiguous.
// The plan (ops.referrer_hist_plan) is launched as given: 256 threads a
// block; route 0 sparse (tile 0, tiles 1, out zeroed by the caller) or 1
// private (`tile` cells of dynamic shared memory, 4 B each and at most
// 48 KB, a block); out zeroed by the caller on both; referrer chunks of
// `per`; grid (chunks, tiles) or (G, chunks, tiles). Returns
// cudaErrorInvalidValue for a plan or shape that does not fit, else
// cudaGetLastError() after the launch.
extern "C" int pclean_referrer_hist(int per_row, const int64_t* hop_ptrs,
                                    const int64_t* hop_lens, int n_hops,
                                    const int32_t* val, int64_t val_rows,
                                    const bool* w, float* out, int64_t G,
                                    int64_t V, int64_t R, int route,
                                    int64_t tile, int64_t chunks,
                                    int64_t per, int64_t tiles, int threads,
                                    void* stream) {
  const bool priv = route == 1;
  if (threads != kThreads || G < 0 || V < 1 || R < 0 || chunks < 1 ||
      tiles < 1 || tiles > 65535 || per < 0 || per * chunks < R ||
      (route != 0 && route != 1) ||
      (priv ? (tile < 1 || tile > kTileMax) : (tile != 0 || tiles != 1)))
    return (int)cudaErrorInvalidValue;
  if (G == 0 || R == 0) return (int)cudaGetLastError();
  const size_t smem = priv ? (size_t)tile * sizeof(int) : 0;
  const uint8_t* w8 = reinterpret_cast<const uint8_t*>(w);
  cudaStream_t st = (cudaStream_t)stream;
  if (per_row) {
    if (n_hops != 0 || (val_rows != 1 && val_rows != G) ||
        chunks > 65535 || (priv && tile * tiles < V))
      return (int)cudaErrorInvalidValue;
    if (priv)
      referrer_hist_rows_private<<<dim3((unsigned)G, (unsigned)chunks,
                                        (unsigned)tiles),
                                   kThreads, smem, st>>>(
          w, val, val_rows, R, per, V, tile, out);
    else
      referrer_hist_rows_sparse<<<dim3((unsigned)G, (unsigned)chunks),
                                  kThreads, 0, st>>>(w8, val, val_rows, R,
                                                     per, V, out);
    return (int)cudaGetLastError();
  }
  if (n_hops < 1 || n_hops > kMaxHops || hop_lens[0] != R ||
      chunks > 2147483647LL || (priv && tile * tiles < G * V))
    return (int)cudaErrorInvalidValue;
  Hops hops;
  for (int h = 0; h < kMaxHops; ++h) {
    hops.col[h] = h < n_hops ? (const int32_t*)hop_ptrs[h] : nullptr;
    hops.len[h] = h < n_hops ? hop_lens[h] : 0;
    if (h < n_hops && hops.len[h] < 1) return (int)cudaErrorInvalidValue;
  }
  hops.n = n_hops;
  if (priv)
    referrer_hist_chase_private<<<dim3((unsigned)chunks, (unsigned)tiles),
                                  kThreads, smem, st>>>(hops, val, w, R, per,
                                                        G, V, tile, out);
  else
    referrer_hist_chase_sparse<<<(unsigned)chunks, kThreads, 0, st>>>(
        hops, val, w8, R, per, G, V, out);
  return (int)cudaGetLastError();
}
