// K8 sa_ext_term: the composed AddTypos external of a latent block,
//   out[b, e] = sum over row b's referrers r with w[b, r] of
//               SA[e, rv_r, val_r]
// where SA[e, c, o] = M[o, table[e, c]] is the typo score of observing o
// when the word is the table's value at the row's enumerated option e and
// the referrer's own value c (the hospital model's stateavg = f(state,
// code), seen from County, e = state and c = the Record's measure code, and
// from Measure, the roles swapped). Referrers whose (rv, val) fall outside
// [0, Vc) x [0, V) are dropped, as the JAX scatter's mode="drop" drops them.
// rv and val are [1 or B, R] (shared over the dense source axis, or per
// row over each row's compacted list), w [B, R].
//
// Replaces the composed branch of _ext_hist_term in
// pclean_tpu/engine/propose.py:795-812, which scatters the (rv, val) pairs
// into a [Vc, V] histogram H and contracts SA . H. This kernel sums SA
// straight over the referrers: no [B, Vc * V] histogram, no GEMM.
//
// Bound on the H100 (3.35 TB/s): bytes. w [B, R] read once dominates: at
// the hospital path's County sweep (4,096 rows of the batch against
// 100,000 Records) 410 MB, about 0.12 ms; rv and val once (0.8 MB), the SA
// entries the kept referrers touch (at most E * Vc * V floats, under 1 MB,
// L2-resident) and out [B, E].
//
// Design: one block of 256 threads a row (grid.y splits the options when
// E exceeds a block's). The block walks the row's referrers in chunks of
// 1,024 (four consecutive entries a thread), keeps them by a block prefix
// scan (so their order stays the referrer order) and stages each kept
// referrer's offset rv * V + val in shared memory. Each option is owned by
// `tpo` threads (tpo a power of two up to 32, as many as the block has to
// spare: 16 at the County sweep's E of about 14, 2 at the Measure sweep's
// 78); sub-lane j adds the kept referrers j, j + tpo, ... of every chunk in
// that order into a double, and the tpo partials merge in a fixed shuffle
// tree at the end. A County holds thousands to tens of thousands of
// Records at 100,000 rows: the double partials keep the sum within 1e-5 of
// its sum of |terms|, where a float accumulator over ~1,000 terms already
// drifted past it in K6 (PERF.md). The result is deterministic; it differs
// from the plain version's f32 GEMM by that GEMM's rounding only.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                    // referrers a thread reads
constexpr int kChunk = kThreads * kPerThread;    // referrers a chunk
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
sa_ext_term_kernel(const float* __restrict__ SA, int64_t E, int64_t Vc,
                   int64_t V, const int32_t* __restrict__ rv,
                   const int32_t* __restrict__ val, int64_t pair_rows,
                   const bool* __restrict__ w, int64_t R, int tpo,
                   float* __restrict__ out) {
  __shared__ int64_t sh_off[kChunk];
  __shared__ int sh_warp[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int opts = kThreads / tpo;
  const int64_t e = (int64_t)blockIdx.y * opts + tid / tpo;
  const int j = tid % tpo;
  const bool* wrow = w + b * R;
  const int32_t* crow = rv + (pair_rows == 1 ? 0 : b * R);
  const int32_t* vrow = val + (pair_rows == 1 ? 0 : b * R);
  const float* sa = SA + (e < E ? e : 0) * Vc * V;
  double acc = 0.0;

  for (int64_t base = 0; base < R; base += kChunk) {
    const int64_t r0 = base + (int64_t)tid * kPerThread;
    int64_t off[kPerThread];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t r = r0 + k;
      off[k] = -1;
      if (r < R && wrow[r]) {
        const int64_t c = crow[r], o = vrow[r];
        if (c >= 0 && c < Vc && o >= 0 && o < V) off[k] = c * V + o;
      }
      mine += off[k] >= 0;
    }
    // block exclusive scan of the per-thread counts
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sh_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = lane < kWarps ? sh_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += v;
      }
      if (lane < kWarps) sh_warp[lane] = s;
    }
    __syncthreads();
    int pos = (warp > 0 ? sh_warp[warp - 1] : 0) + incl - mine;
    const int total = sh_warp[kWarps - 1];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (off[k] >= 0) sh_off[pos++] = off[k];
    __syncthreads();
    if (e < E)
      for (int i = j; i < total; i += tpo)
        acc += (double)__ldg(sa + sh_off[i]);
    __syncthreads();  // the next chunk overwrites the staged offsets
  }
  // merge the tpo partials of each option (lanes j = 0..tpo-1 of one warp)
  for (int o = tpo >> 1; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o, tpo);
  if (j == 0 && e < E) out[b * E + e] = (float)acc;
}

}  // namespace

// SA [E, Vc, V] f32, rv and val [pair_rows, R] int32 (pair_rows 1 or B),
// w [B, R] bool, out [B, E] f32, on the device and contiguous. The plan
// (ops.sa_ext_term_plan) is launched as given: 256 threads a block, `tpo`
// threads an option (a power of two, at most 32), grid (B, option groups of
// 256 / tpo). Returns cudaErrorInvalidValue for a plan or shape that does
// not fit, else cudaGetLastError() after the launch.
extern "C" int pclean_sa_ext_term(const float* SA, int64_t E, int64_t Vc,
                                  int64_t V, const int32_t* rv,
                                  const int32_t* val, int64_t pair_rows,
                                  const bool* w, int64_t R, float* out,
                                  int64_t B, int threads, int tpo,
                                  int64_t grid_x, int64_t grid_y,
                                  void* stream) {
  if (E < 1 || Vc < 1 || V < 1 || R < 0 || (pair_rows != 1 && pair_rows != B))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  if (threads != kThreads || tpo < 1 || tpo > 32 || (tpo & (tpo - 1)) != 0 ||
      grid_x != B || grid_y < 1 || grid_y > 65535 ||
      grid_y * (kThreads / tpo) < E)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  sa_ext_term_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      SA, E, Vc, V, rv, val, pair_rows, w, R, tpo, out);
  return (int)cudaGetLastError();
}
