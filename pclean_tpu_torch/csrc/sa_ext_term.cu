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
// entries the kept referrers touch (at most E * Vc * V floats, a few MB,
// L2-resident) and out [B, E]. At one row the 100 KB of w is far below the
// launch floor: a one-row launch is a latency chain.
//
// Design. The plan (ops.sa_ext_term_plan) splits each row's referrer axis
// over S blocks so that the launch fills the card: at one row 391 blocks
// of 256 referrers, at 4,096 rows one block a row (S = 1). Grid
// (B, S, option groups of 128).
//   * The walk: a block reads its slice of w with pclean_walk (common.cuh,
//     shared with K7's sparse route): 16-byte words, two 512-byte spans in
//     flight a warp, a span with no set byte skipped by one warp vote, the
//     bytes outside the slice masked, so rows and slices at any byte offset
//     are read alike. The batched masks are almost all empty, so this vote
//     is the hot loop. The words are streamed (evict-first), so the 410 MB
//     of a batched mask do not push SA, rv and val out of L2.
//   * The gather: for a span with set bytes each lane loads rv and val of
//     its own kept referrers only (up to 16, all issued together); the warp
//     compacts the in-range offsets rv * V + val into its shared-memory
//     list in referrer order (one ballot a bit position); then lane l adds
//     SA[e, offset] for its options e = 128 g + l + 32 k (k < 4) in list
//     order into doubles. The hospital path's batched County sweep puts
//     each live county's ~11,000 Records in one row, so that row's block
//     is a chain of such loads while the others stream empty rows. So
//     where E <= 32 (one option a lane, County's 14) a lane loads 8 list
//     entries' SA values before it adds them, an instantiation of its own
//     (kOne) whose registers do not weigh on the multi-option one; and the
//     mask is streamed, since loaded as cached data it pushed SA out of L2
//     under that chain. Giving an option several lanes that take
//     alternate entries lost: it cost registers at every shape.
//   * The merge, in a fixed order everywhere, so that two launches give
//     the same bits and no float atomics touch `out`: the block's warps
//     per option in warp order through shared memory; with S = 1 the block
//     writes out[b, e], else its partial into a [B, S, E] double scratch
//     (the wrapper's torch.empty), and a second launch sums each (row,
//     option)'s S partials with one warp: lane l takes partials l, l + 32,
//     ... in order, then a fixed shuffle tree.
// A County holds thousands to tens of thousands of Records at 100,000
// rows: the double sums keep the result within 1e-5 of its sum of |terms|,
// where a float accumulator over ~1,000 terms already drifted past it in
// K6 (PERF.md). The result differs from the plain version's f32 GEMM by
// that GEMM's rounding only.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOpt = 4;                // options a lane owns
constexpr int kGroup = 32 * kOpt;      // options a block owns
constexpr int kDepth = 2;              // spans a warp keeps in flight
constexpr int kBatch = 8;              // SA loads a lane issues together
constexpr int kMergeThreads = 256;     // the merge launch: a warp an output

// kOne: E <= 32, one option a lane (k = 0 alone).
template <bool kOne>
__global__ void __launch_bounds__(kThreads)
sa_ext_term_kernel(const float* __restrict__ SA, int64_t E, int64_t Vc,
                   int64_t V, const int32_t* __restrict__ rv,
                   const int32_t* __restrict__ val, int64_t pair_rows,
                   const uint8_t* __restrict__ w, int64_t R, int64_t per,
                   int64_t S, float* __restrict__ out,
                   double* __restrict__ part) {
  __shared__ uint4 stage[kWarps][32];
  __shared__ int32_t list[kWarps][PCLEAN_SPAN];
  __shared__ double red[kWarps][kGroup];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.x, s = blockIdx.y;
  const int64_t e0 = (int64_t)blockIdx.z * kGroup;
  const int32_t* crow = rv + (pair_rows == 1 ? 0 : b * R);
  const int32_t* vrow = val + (pair_rows == 1 ? 0 : b * R);
  const int64_t VcV = Vc * V;
  constexpr int kMine = kOne ? 1 : kOpt;   // options a lane owns
  const float* sa[kMine];
  bool own[kMine];
  double acc[kMine];
#pragma unroll
  for (int k = 0; k < kMine; ++k) {
    const int64_t e = e0 + lane + 32 * k;
    own[k] = e < E;
    sa[k] = SA + (own[k] ? e : 0) * VcV;
    acc[k] = 0.0;
  }
  int32_t* mine = list[warp];
  const int64_t r0 = s * per;
  pclean_walk<kWarps, kDepth, true>(
      w + b * R, r0, r0 + per < R ? r0 + per : R, stage[warp],
      [&](int64_t rb, uint32_t set) {
        int32_t c[16], o[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const bool on = (set >> j) & 1u;
          c[j] = on ? __ldg(crow + rb + 32 * j) : -1;
          o[j] = on ? __ldg(vrow + rb + 32 * j) : -1;
        }
        int n = 0;
        const uint32_t below = (1u << lane) - 1u;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const bool ok = c[j] >= 0 && c[j] < Vc && o[j] >= 0 && o[j] < V;
          const uint32_t m = __ballot_sync(0xffffffffu, ok);
          if (ok) mine[n + __popc(m & below)] = c[j] * (int32_t)V + o[j];
          n += __popc(m);
        }
        __syncwarp();
        if (kOne) {
          if (own[0])
            for (int i0 = 0; i0 < n; i0 += kBatch) {
              float x[kBatch];
#pragma unroll
              for (int u = 0; u < kBatch; ++u)
                x[u] = i0 + u < n ? __ldg(sa[0] + mine[i0 + u]) : 0.0f;
#pragma unroll
              for (int u = 0; u < kBatch; ++u)
                if (i0 + u < n) acc[0] += (double)x[u];
            }
        } else {
#pragma unroll 4
          for (int i = 0; i < n; ++i) {
            const int32_t off = mine[i];
#pragma unroll
            for (int k = 0; k < kMine; ++k)
              if (own[k]) acc[k] += (double)__ldg(sa[k] + off);
          }
        }
        __syncwarp();  // the next span overwrites the list
      });
#pragma unroll
  for (int k = 0; k < kMine; ++k)  // kOne: E <= 32, only red[.][0, 32) read
    red[warp][lane + 32 * k] = acc[k];
  __syncthreads();
  if (threadIdx.x < kGroup && e0 + threadIdx.x < E) {
    const int64_t e = e0 + threadIdx.x;
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += red[k][threadIdx.x];
    if (S == 1)
      out[b * E + e] = (float)t;
    else
      part[(b * S + s) * E + e] = t;
  }
}

// out[q] (q = b * E + e) = the sum of part[b, 0..S-1, e], a warp an output:
// lane l sums partials l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void __launch_bounds__(kMergeThreads)
sa_ext_term_merge(const double* __restrict__ part, int64_t S, int64_t E,
                  int64_t BE, float* __restrict__ out) {
  const int64_t q =
      ((int64_t)blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= BE) return;  // q is the same on every lane of the warp
  const int64_t b = q / E, e = q - b * E;
  const double* p = part + b * S * E + e;
  double t = 0.0;
  for (int64_t k = lane; k < S; k += 32) t += p[k * E];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  if (lane == 0) out[q] = (float)t;
}

}  // namespace

// SA [E, Vc, V] f32, rv and val [pair_rows, R] int32 (pair_rows 1 or B),
// w [B, R] bool (at any byte offset), out [B, E] f32, part [B, S, E] f64
// scratch (null when S is 1), on the device; every tensor contiguous. The
// plan (ops.sa_ext_term_plan) is launched as given: 256 threads a block,
// grid (B, S, groups) with S splits of `per` referrers a row and option
// groups of 128; where S > 1, a second launch of `merge_blocks` blocks of
// 256 threads, a warp for each of the B * E outputs. Returns
// cudaErrorInvalidValue for a plan or shape that does not fit, else
// cudaGetLastError() after the launches.
extern "C" int pclean_sa_ext_term(const float* SA, int64_t E, int64_t Vc,
                                  int64_t V, const int32_t* rv,
                                  const int32_t* val, int64_t pair_rows,
                                  const bool* w, int64_t R, float* out,
                                  double* part, int64_t B, int threads,
                                  int64_t splits, int64_t per,
                                  int64_t groups, int merge_threads,
                                  int64_t merge_blocks, void* stream) {
  if (E < 1 || Vc < 1 || V < 1 || R < 0 || Vc * V > 2147483647LL ||
      (pair_rows != 1 && pair_rows != B))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  if (threads != kThreads || B > 2147483647LL || splits < 1 ||
      splits > 65535 || per < 1 || splits * per < R || groups < 1 ||
      groups > 65535 || groups * kGroup < E ||
      (splits > 1 && (part == nullptr || merge_threads != kMergeThreads ||
                      merge_blocks < 1 ||
                      merge_blocks * (kMergeThreads / 32) < B * E)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)B, (unsigned)splits, (unsigned)groups);
  const uint8_t* w8 = reinterpret_cast<const uint8_t*>(w);
  if (E <= 32)
    sa_ext_term_kernel<true><<<grid, kThreads, 0, st>>>(
        SA, E, Vc, V, rv, val, pair_rows, w8, R, per, splits, out, part);
  else
    sa_ext_term_kernel<false><<<grid, kThreads, 0, st>>>(
        SA, E, Vc, V, rv, val, pair_rows, w8, R, per, splits, out, part);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sa_ext_term_merge<<<(unsigned)merge_blocks, kMergeThreads, 0, st>>>(
        part, splits, E, B * E, out);
  }
  return (int)cudaGetLastError();
}
