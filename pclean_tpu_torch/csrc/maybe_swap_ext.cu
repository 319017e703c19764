// K6 maybe_swap_ext: a MaybeSwap external of a latent block, summed over
// each row's referrers for every option a of the row's enumerated value,
//   out[b, a] = sum over referrers r of row b of
//     st_r = 1: (obs_r == a) ? log1p(-p_r) : log p_r - log lens[lc_b]
//     st_r = 2: member[lc_b, a] ? 0 : -1000
//     else    : 0
// Row b's referrers come in one of two forms, as the tracer holds them:
//   * dense: the whole source axis of N rows, r kept where alive_r and
//     t_r == slot_b (obs, st [N] shared by every row);
//   * list: row b's own compacted list of N entries of which the first
//     min(cnt_b, N) are its referrers (obs, st [B, N] gathered by torch
//     through Engine._ref_comp's per-slot lists, the referrer bound of
//     compile._referrer_bounds).
// p_r is read from row b's p (p_rows == B) or a shared one (p_rows == 1),
// indexed like obs.
//
// Bound on the H100 (3.35 TB/s): bytes, far below the launch floor at the
// flights shapes. On the flights path (list form, a referrer bound of 256,
// about 24 referrers a flight): obs, st and p of those referrers (9 B
// each), out [1, V] and row lc of the member mask, about 2 KB; in dense
// form t, alive, obs, st and p of all 2,376 rows, about 33 KB. A one-row
// launch is a latency chain: a few dependent global loads, a block scan
// and the option loop.
//
// Design: one block of 512 threads a row and up to 4,096 options (grid
// (B, option groups)). The block walks its referrer axis in chunks of
// 2,048 (four consecutive entries a thread), keeps the referrers by a
// block prefix scan, so their order stays the referrer order, and stages
// each kept referrer's code, state and two log terms in shared memory; then
// each thread adds the chunk's kept referrers, in that order, into the
// sums of its eight options (registers, in double: a crowded slot of a
// thousand referrers drifts by up to 1e-4 of its sum in sequential float
// adds, so a float accumulator would fail the tolerance below where torch's
// pairwise sums do not). The sums are not rewritten as a presum plus a
// correction: with p = 1e-5 a term is -11.5 and subtracting it back would
// trade exactness for nothing at these sizes. The terms are the plain
// version's float terms; the two agree to 1e-5 of each cell's sum of
// |terms|, not bit for bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPerThread = 4;                    // referrers a thread reads
constexpr int kChunk = kThreads * kPerThread;    // referrers a chunk
constexpr int kMaxTiles = 8;                     // options a thread owns
constexpr int kOptions = kThreads * kMaxTiles;   // options a block owns
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x >= hi ? hi - 1 : x);
}

template <bool kList>
__global__ void __launch_bounds__(kThreads)
maybe_swap_ext_kernel(const int32_t* __restrict__ t,
                      const bool* __restrict__ alive,
                      const int32_t* __restrict__ slot,
                      const int32_t* __restrict__ cnt,
                      const int32_t* __restrict__ obs,
                      const int8_t* __restrict__ st,
                      const float* __restrict__ p, int64_t p_rows,
                      const int32_t* __restrict__ lc,
                      const int32_t* __restrict__ lens, int64_t L,
                      const bool* __restrict__ member, int64_t V,
                      float* __restrict__ out, int64_t N) {
  __shared__ int32_t sh_obs[kChunk];
  __shared__ float sh_same[kChunk];   // log1p(-p_r)
  __shared__ float sh_diff[kChunk];   // log p_r - log len
  __shared__ int8_t sh_kind[kChunk];  // st_r: 1 or 2
  __shared__ int sh_warp[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t a0 = (int64_t)blockIdx.y * kOptions;
  const int32_t s = kList ? 0 : __ldg(slot + b);
  // entries to walk: the whole axis (dense) or the row's list
  const int64_t n = kList ? (int64_t)min(max(__ldg(cnt + b), 0), (int)N) : N;
  const int32_t* orow = obs + (kList ? b * N : 0);
  const int8_t* srow = st + (kList ? b * N : 0);
  const int64_t l = clamp64(__ldg(lc + b), L);
  const float loglen = logf((float)__ldg(lens + l));
  const float* prow = p + (p_rows == 1 ? 0 : b * N);
  const bool* mrow = member + l * V;

  double acc[kMaxTiles];
  bool mem[kMaxTiles];
#pragma unroll
  for (int k = 0; k < kMaxTiles; ++k) {
    const int64_t a = a0 + (int64_t)k * kThreads + tid;
    acc[k] = 0.0;
    mem[k] = a < V ? mrow[a] : false;
  }

  for (int64_t base = 0; base < n; base += kChunk) {
    const int64_t r0 = base + (int64_t)tid * kPerThread;
    bool keep[kPerThread];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t r = r0 + j;
      bool k = false;
      if (r < n && (kList || (alive[r] && __ldg(t + r) == s))) {
        const int8_t sr = srow[r];
        k = sr == 1 || sr == 2;
      }
      keep[j] = k;
      mine += k;
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
      int w = lane < kWarps ? sh_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += v;
      }
      if (lane < kWarps) sh_warp[lane] = w;
    }
    __syncthreads();
    int off = (warp > 0 ? sh_warp[warp - 1] : 0) + incl - mine;
    const int total = sh_warp[kWarps - 1];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (!keep[j]) continue;
      const int64_t r = r0 + j;
      const int8_t sr = srow[r];
      sh_kind[off] = sr;
      if (sr == 1) {
        const float pr = __ldg(prow + r);
        sh_obs[off] = __ldg(orow + r);
        sh_same[off] = log1pf(-pr);
        sh_diff[off] = logf(pr) - loglen;
      }
      ++off;
    }
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      if (sh_kind[i] == 1) {
        const int64_t o = sh_obs[i];
        const double same = sh_same[i], diff = sh_diff[i];
#pragma unroll
        for (int k = 0; k < kMaxTiles; ++k)
          acc[k] += (o == a0 + (int64_t)k * kThreads + tid) ? same : diff;
      } else {
#pragma unroll
        for (int k = 0; k < kMaxTiles; ++k)
          acc[k] += mem[k] ? 0.0 : -1000.0;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged referrers
  }
#pragma unroll
  for (int k = 0; k < kMaxTiles; ++k) {
    const int64_t a = a0 + (int64_t)k * kThreads + tid;
    if (a < V) out[b * V + a] = (float)acc[k];
  }
}

}  // namespace

// Dense form (cnt null): t [N] int32, alive [N] bool, slot [B] int32,
// obs [N] int32, st [N] int8. List form (t, alive, slot null): cnt [B]
// int32, obs [B, N] int32, st [B, N] int8. Both: p [p_rows, N] f32
// (p_rows 1 or B), lc [B] int32, lens [L] int32, member [L, V] bool, out
// [B, V] f32, on the device and contiguous. The plan
// (ops.maybe_swap_ext_plan) is launched as given: `threads` threads (512) a
// block, grid (B, option groups of 4,096). Returns cudaErrorInvalidValue
// for a plan or shape that does not fit, else cudaGetLastError() after the
// launch.
extern "C" int pclean_maybe_swap_ext(const int32_t* t, const bool* alive,
                                     const int32_t* slot, const int32_t* cnt,
                                     const int32_t* obs, const int8_t* st,
                                     const float* p, int64_t p_rows,
                                     const int32_t* lc, const int32_t* lens,
                                     int64_t L, const bool* member, int64_t V,
                                     float* out, int64_t B, int64_t N,
                                     int threads, int64_t grid_x,
                                     int64_t grid_y, void* stream) {
  const bool list = cnt != nullptr;
  if (L < 1 || V < 1 || N < 0 || N > (1 << 30) ||
      (p_rows != 1 && p_rows != B) ||
      (!list && (t == nullptr || alive == nullptr || slot == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  if (threads != kThreads || grid_x != B || grid_y < 1 || grid_y > 65535 ||
      grid_y * kOptions < V)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  if (list)
    maybe_swap_ext_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        t, alive, slot, cnt, obs, st, p, p_rows, lc, lens, L, member, V, out,
        N);
  else
    maybe_swap_ext_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        t, alive, slot, cnt, obs, st, p, p_rows, lc, lens, L, member, V, out,
        N);
  return (int)cudaGetLastError();
}
