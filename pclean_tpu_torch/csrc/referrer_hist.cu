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
// Bound on the H100 (3.35 TB/s): bytes. Hoisted, at the hospital path's
// 100,000 Records: w (1 B), val and up to three hop columns (4 B each) of
// every referrer read once, about 1.7 MB, and [cap, V] written once (512 x
// 110 floats at most, 0.2 MB): about 0.6 us, below the launch floor. Per
// row, at the scaled path's Hospital sweep: the [4,096, 100,000] mask, 410
// MB, about 0.12 ms.
//
// Design: the counts are integers below 2^24, exact in f32 whatever the
// order of addition, so the kernel privatises them: each block owns a tile
// of up to 12,288 output cells in shared memory (int counters, shared-
// memory atomics), walks its chunk of referrers (consecutive threads on
// consecutive referrers, so w and val are read coalesced) and keeps those
// that land in its tile, then adds its nonzero counters into the output
// (zeroed by the wrapper) with one global atomic each. Grid: hoisted
// (referrer chunks, cell tiles); per row (B, referrer chunks, V tiles).
// Where the output is larger than one tile, each tile's blocks read their
// referrers again (from L2): at the hospital path's largest histogram, five
// tiles.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHops = 8;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Hops {
  const int32_t* col[kMaxHops];
  int64_t len[kMaxHops];
  int n;
};

__device__ __forceinline__ void zero_tile(int* sh, int64_t n) {
  for (int64_t i = threadIdx.x; i < n; i += kThreads) sh[i] = 0;
  __syncthreads();
}

__device__ __forceinline__ void flush_tile(const int* sh, int64_t n,
                                           float* __restrict__ out) {
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const int c = sh[i];
    if (c != 0) atomicAdd(out + i, (float)c);
  }
}

__global__ void __launch_bounds__(kThreads)
referrer_hist_chase_kernel(Hops hops, const int32_t* __restrict__ val,
                           const bool* __restrict__ w, int64_t N,
                           int64_t per, int64_t cap, int64_t V, int64_t tile,
                           float* __restrict__ out) {
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
    int64_t g = hops.col[0][r];
    for (int h = 1; h < hops.n; ++h) {
      const int64_t hi = hops.len[h] - 1;
      g = hops.col[h][g < 0 ? 0 : (g > hi ? hi : g)];
    }
    if (g < 0 || g >= cap) continue;
    const int64_t cell = g * V + v - lo;
    if (cell >= 0 && cell < n) atomicAdd(sh + cell, 1);
  }
  flush_tile(sh, n, out + lo);
}

__global__ void __launch_bounds__(kThreads)
referrer_hist_rows_kernel(const bool* __restrict__ w,
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
// R] int32 (val_rows 1 or B), out [G, V]. All on the device and contiguous;
// out zeroed by the caller. The plan (ops.referrer_hist_plan) is launched as
// given: 256 threads a block, `tile` cells of shared memory (4 B each) a
// block, referrer chunks of `per`, grid (chunks, tiles) or (G, chunks,
// tiles). Returns cudaErrorInvalidValue for a plan or shape that does not
// fit, else cudaGetLastError() after the launch.
extern "C" int pclean_referrer_hist(int per_row, const int64_t* hop_ptrs,
                                    const int64_t* hop_lens, int n_hops,
                                    const int32_t* val, int64_t val_rows,
                                    const bool* w, float* out, int64_t G,
                                    int64_t V, int64_t R, int64_t tile,
                                    int64_t chunks, int64_t per, int64_t tiles,
                                    int threads, void* stream) {
  if (threads != kThreads || G < 0 || V < 1 || R < 0 || tile < 1 ||
      tile * 4 > 48 * 1024 || chunks < 1 || chunks > 65535 || tiles < 1 ||
      tiles > 65535 || per < 0 || per * chunks < R)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || R == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)tile * sizeof(int);
  if (per_row) {
    if (n_hops != 0 || (val_rows != 1 && val_rows != G) || tile * tiles < V)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)G, (unsigned)chunks, (unsigned)tiles);
    referrer_hist_rows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        w, val, val_rows, R, per, V, tile, out);
  } else {
    if (n_hops < 1 || n_hops > kMaxHops || hop_lens[0] != R ||
        tile * tiles < G * V)
      return (int)cudaErrorInvalidValue;
    Hops hops;
    for (int h = 0; h < kMaxHops; ++h) {
      hops.col[h] = h < n_hops ? (const int32_t*)hop_ptrs[h] : nullptr;
      hops.len[h] = h < n_hops ? hop_lens[h] : 0;
      if (h < n_hops && hops.len[h] < 1) return (int)cudaErrorInvalidValue;
    }
    hops.n = n_hops;
    const dim3 grid((unsigned)chunks, (unsigned)tiles);
    referrer_hist_chase_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        hops, val, w, R, per, G, V, tile, out);
  }
  return (int)cudaGetLastError();
}
