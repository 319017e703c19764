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
// Design: two routes, one for each form (ops.maybe_swap_ext_plan).
//   * block (the dense form): one block of 512 threads a row and up to
//     4,096 options (grid (B, option groups)). The block walks the source
//     axis in chunks of 2,048 (four consecutive entries a thread), keeps
//     the row's referrers by a block prefix scan, so their order stays the
//     referrer order, and stages each kept referrer's code, state and two
//     log terms in shared memory; then each thread adds the chunk's kept
//     referrers, in that order, into the sums of its eight options
//     (registers, in double: a crowded slot of a thousand referrers drifts
//     by up to 1e-4 of its sum in sequential float adds, so a float
//     accumulator would fail the tolerance below where torch's pairwise
//     sums do not).
//   * warp (the list form, such as the flights path's 23 kept of 256): a
//     warp serves a row and 64 options (2 a lane), a block of up to 8
//     warps, grid (B, option groups of 64 x warps); each warp walks the
//     row's list itself, so there is no __syncthreads. A one-row launch
//     there is a latency chain, so every independent load is issued at
//     once before anything depends on it: cnt, lc, and 64 entries of obs,
//     st and p (2 a lane, masked by cnt afterwards: a load past cnt stays
//     inside the row's N entries); then lens and the member row, which
//     depend on lc alone, arrive while the step's terms are made, and the
//     next 64 entries load while this step's are summed.
//     Referrers are kept by one __ballot_sync for each 32 entries (a vote
//     with no kept entry skips them); each kept one's code, state, log1p(-p)
//     and log p go into the warp's shared-memory list at its rank (a
//     __popc of the vote), so the list keeps the referrer order. Then each
//     lane adds the list, in that order and without a branch, into its two
//     options' double sums, with the block route's float terms (log p -
//     log len subtracted in float, as the plain version does). The sums
//     are not rewritten as a presum of the log p terms plus corrections at
//     the observed options: with two options a lane it would save one
//     double add a referrer, and a p of 0 would turn it into -inf + inf.
// The terms are the plain version's float terms; the two agree to 1e-5 of
// each cell's sum of |terms|, not bit for bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPerThread = 4;                    // referrers a thread reads
constexpr int kChunk = kThreads * kPerThread;    // referrers a chunk
constexpr int kMaxTiles = 8;                     // options a thread owns
constexpr int kOptions = kThreads * kMaxTiles;   // options a block owns
constexpr int kWarps = kThreads / 32;
// the warp route (list form)
constexpr int kLaneOpt = 2;                      // options a lane owns
constexpr int kWarpOpt = 32 * kLaneOpt;          // options a warp owns
constexpr int kStep = 2;                         // entries a lane loads a step
constexpr int kMaxRouteWarps = 8;                // warps a block

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x >= hi ? hi - 1 : x);
}

// Block route (dense form): block (b, y) owns options a0 + 512 k + tid
// (k < 8), a0 = 4,096 y, and walks the whole source axis.
__global__ void __launch_bounds__(kThreads)
maybe_swap_ext_kernel(const int32_t* __restrict__ t,
                      const bool* __restrict__ alive,
                      const int32_t* __restrict__ slot,
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
  const int32_t s = __ldg(slot + b);
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

  for (int64_t base = 0; base < N; base += kChunk) {
    const int64_t r0 = base + (int64_t)tid * kPerThread;
    bool keep[kPerThread];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t r = r0 + j;
      bool k = false;
      if (r < N && alive[r] && __ldg(t + r) == s) {
        const int8_t sr = st[r];
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
      const int8_t sr = st[r];
      sh_kind[off] = sr;
      if (sr == 1) {
        const float pr = __ldg(prow + r);
        sh_obs[off] = __ldg(obs + r);
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

// Warp route (list form): warp k of block (b, y) owns options
// a0 + lane + 32 i (i < 2), a0 = (y * warps + k) * 64, and walks row b's
// list itself.
__global__ void __launch_bounds__(32 * kMaxRouteWarps)
maybe_swap_ext_warp(const int32_t* __restrict__ cnt,
                    const int32_t* __restrict__ obs,
                    const int8_t* __restrict__ st,
                    const float* __restrict__ p, int64_t p_rows,
                    const int32_t* __restrict__ lc,
                    const int32_t* __restrict__ lens, int64_t L,
                    const bool* __restrict__ member, int64_t V,
                    float* __restrict__ out, int64_t N) {
  __shared__ int2 sh_code[kMaxRouteWarps][32 * kStep];    // (obs, st)
  __shared__ float2 sh_log[kMaxRouteWarps][32 * kStep];   // (log1p(-p), log p)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.x;
  const int64_t a0 =
      ((int64_t)blockIdx.y * (blockDim.x >> 5) + warp) * kWarpOpt;
  if (a0 >= V) return;  // the whole warp: no block barrier follows
  const int32_t* orow = obs + b * N;
  const int8_t* srow = st + b * N;
  const float* prow = p + (p_rows == 1 ? 0 : b * N);
  // the independent loads: the row's count, its list code, and the first
  // step's entries
  const int32_t c = __ldg(cnt + b);
  const int32_t lcb = __ldg(lc + b);
  struct Step {   // a lane's entries base + 32 j + lane of one step
    int32_t o[kStep];
    int8_t sv[kStep];
    float pv[kStep];
  };
  auto load = [&](Step& x, int64_t base) {
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      const int64_t r = base + 32 * j + lane;
      const bool in = r < N;
      x.o[j] = in ? __ldg(orow + r) : 0;
      x.sv[j] = in ? srow[r] : (int8_t)0;
      x.pv[j] = in ? __ldg(prow + r) : 0.5f;
    }
  };
  Step cur, nxt;
  load(cur, 0);
  // then what depends on lc alone
  const int64_t l = clamp64(lcb, L);
  const int32_t len = __ldg(lens + l);
  const bool* mrow = member + l * V;
  bool miss[kLaneOpt];
#pragma unroll
  for (int i = 0; i < kLaneOpt; ++i) {
    const int64_t a = a0 + lane + 32 * i;
    miss[i] = a < V ? !mrow[a] : false;
  }
  // entries to walk: the row's list
  const int64_t n = (int64_t)min(max(c, 0), (int)N);
  const int rel = (int)(a0 + lane);   // option i of this lane: rel + 32 i
  const uint32_t below = (1u << lane) - 1u;
  int2* code = sh_code[warp];
  float2* logs = sh_log[warp];
  float loglen = 0.0f;
  bool have_len = false;
  double acc[kLaneOpt];
#pragma unroll
  for (int i = 0; i < kLaneOpt; ++i) acc[i] = 0.0;
  for (int64_t base = 0; base < n; base += 32 * kStep) {
    if (base + 32 * kStep < n) load(nxt, base + 32 * kStep);
    int k = 0;   // kept entries of this step, listed in referrer order
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      const int64_t r = base + 32 * j + lane;
      const int8_t sj = cur.sv[j];
      const bool keep = r < n && (sj == 1 || sj == 2);
      const uint32_t m = __ballot_sync(0xffffffffu, keep);
      if (m == 0u) continue;
      if (keep) {
        const int pos = k + __popc(m & below);
        code[pos] = make_int2(cur.o[j], (int)sj);
        logs[pos] = sj == 1 ? make_float2(log1pf(-cur.pv[j]),
                                          logf(cur.pv[j]))
                            : make_float2(0.0f, 0.0f);
      }
      k += __popc(m);
    }
    __syncwarp();
    if (k > 0 && !have_len) {
      loglen = logf((float)len);
      have_len = true;
    }
#pragma unroll 4
    for (int i = 0; i < k; ++i) {   // the same entry on every lane
      const int2 q = code[i];
      const float2 lg = logs[i];
      const float diff = lg.y - loglen;
      const int d = q.x - rel;
#pragma unroll
      for (int u = 0; u < kLaneOpt; ++u)
        acc[u] += q.y == 1 ? (double)(d == 32 * u ? lg.x : diff)
                           : (miss[u] ? -1000.0 : 0.0);
    }
    __syncwarp();   // the next step overwrites the list
    cur = nxt;
  }
#pragma unroll
  for (int i = 0; i < kLaneOpt; ++i) {
    const int64_t a = (int64_t)rel + 32 * i;
    if (a < V) out[b * V + a] = (float)acc[i];
  }
}

}  // namespace

// Dense form (cnt null): t [N] int32, alive [N] bool, slot [B] int32,
// obs [N] int32, st [N] int8. List form (t, alive, slot null): cnt [B]
// int32, obs [B, N] int32, st [B, N] int8. Both: p [p_rows, N] f32
// (p_rows 1 or B), lc [B] int32, lens [L] int32, member [L, V] bool, out
// [B, V] f32, on the device and contiguous. The plan
// (ops.maybe_swap_ext_plan) is launched as given: the dense form on the
// block route, 512 threads a block and grid (B, option groups of 4,096);
// the list form on the warp route, 32-256 threads a block and grid (B,
// option groups of 64 for each warp). Returns cudaErrorInvalidValue for a
// plan or shape that does not fit, else cudaGetLastError() after the
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
  const int64_t per_block =
      list ? (int64_t)(threads / 32) * kWarpOpt : (int64_t)kOptions;
  if (grid_x != B || grid_y < 1 || grid_y > 65535 || grid_y * per_block < V ||
      (list ? (threads < 32 || threads > 32 * kMaxRouteWarps ||
               threads % 32 != 0)
            : threads != kThreads))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaStream_t s = (cudaStream_t)stream;
  if (list)
    maybe_swap_ext_warp<<<grid, threads, 0, s>>>(
        cnt, obs, st, p, p_rows, lc, lens, L, member, V, out, N);
  else
    maybe_swap_ext_kernel<<<grid, kThreads, 0, s>>>(
        t, alive, slot, obs, st, p, p_rows, lc, lens, L, member, V, out, N);
  return (int)cudaGetLastError();
}
