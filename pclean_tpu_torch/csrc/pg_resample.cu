// K9 pg_resample: one particle-Gibbs resampling decision per row.
//
// Replaces the resampling step of pclean_tpu/engine/particles.py
// propose_row_pg (particles.py:131-158). For R rows of P particle log
// weights ws, with m = max(ws), p = exp(ws - m), s1 = sum p, s2 = sum p^2,
// lse = m + log(s1) (logsumexp) and ESS = s1^2 / s2
// (exp(-logsumexp(2 log_normalize(ws)))):
//   resample mode (between blocks, particles.py:131-144): every particle i
//     draws an ancestor idx_i from categorical(ws) by inverse CDF with its
//     own uniform u[r, i]; with `retained` particle 0 keeps itself
//     (retain-first); where ESS < P / 2 the row resamples:
//     sel[r, i] = r P + idx_i, ws_out = 0, lml = lse - log P; elsewhere
//     sel[r, i] = r P + i, ws_out = ws, lml = 0.
//   final mode (particles.py:148-158): one draw j from categorical(ws)
//     with u[r]: j[r] = r P + j, lml = lse - log P.
// sel and j index the flattened [R P] particle axis, so the caller gathers
// each particle's env and births with x[sel] in one indexing.
//
// The draws follow K2's rule (csrc/inv_cdf_sample.cu): the pick is the
// number of prefix sums below the threshold (1 - u) * total, taken in
// (0, total]. Each p is rounded once to a 64-bit fixed-point integer
// q = rn(p * 2^32) and the prefix sums are integer sums, exact in any
// order, so the prefix sequence is monotone, ends at the total, and a
// zero-mass particle can never be drawn. A pick differs from the plain
// version's f32 torch.cumsum only where the threshold lies within the
// rounding (about P * 2^-33 of a total >= 1) of a boundary.
//
// Bound on the H100 (3.35 TB/s): bytes. Resample mode reads ws and u and
// writes sel (int64) and ws_out, 20 bytes a particle, and lml, 4 bytes a
// row; final mode reads ws, 4 bytes a particle, and u, j (int64) and lml,
// 16 bytes a row.
//
// Design. ops.pg_resample_plan picks one of two:
//   * group (P <= 32, pg16's P = 16): a group of G = the next power of two
//     >= P lanes a row, 32 / G rows a warp, several warps a block, no
//     barrier and no shared memory. Lane i holds weight i in a register
//     (loaded with its uniform in one round). The max, s1 and s2 are
//     __shfl_xor_sync butterflies over offsets G / 2, ..., 1 of the group:
//     the block path below adds +0.0 from its empty lanes at offsets 16,
//     ..., G and in its second stage, so the sums are its bits (p >= +0.0,
//     so x + 0.0 == x). The q prefix is an inclusive __shfl_up_sync scan
//     of the 64-bit fixed-point values (exact in any order); lane i's pick
//     is the number of the group's prefix sums below its threshold,
//     capped at P - 1, counted over the group's lanes by shuffles (the
//     final mode's one threshold by one ballot): the binary search's
//     index, the prefix being monotone.
//   * block (P > 32, up to 16384): one block a row.
//     1. The row's P weights are read once into shared memory, where they
//        stay as read; a warp-shuffle block reduction of each thread's max
//        gives the row's max m.
//     2. Each thread owns one contiguous chunk of the weights. It computes
//        p = exp(w - m) on the fly (p itself is not stored) and sums p,
//        p^2 and q, writing the chunk's running q sums into the shared
//        prefix array; two shuffle reductions give s1 and s2, an exclusive
//        block scan of the q sums gives each chunk's start, which the
//        thread adds to its chunk's prefix sums.
//     3. lse, ESS and the decision are the same in every thread. Where the
//        row resamples (or in final mode), each draw is a binary search
//        for the first prefix sum >= the threshold over the shared prefix
//        array.
//     4. One coalesced write of sel and ws_out (or j) and one of lml.

#include "common.cuh"

namespace {

constexpr float kScale = 4294967296.0f;  // 2^32
typedef unsigned long long u64;

__device__ __forceinline__ u64 quant(float p) {
  return __float2ull_rn(p * kScale);
}

// Block exclusive scan of one value per thread; `sh` holds >= 33 values.
__device__ __forceinline__ u64 block_scan_excl(u64 v, u64* sh, u64* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  u64 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    u64 t = lane < nwarps ? sh[lane] : 0ull;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nwarps) sh[lane] = t;
    if (lane == nwarps - 1) sh[32] = t;
  }
  __syncthreads();
  const u64 excl = x - v + (warp > 0 ? sh[warp - 1] : 0ull);
  *total = sh[32];
  __syncthreads();
  return excl;
}

// The first i in [0, P) with pre[i] >= ub (P - 1 if none); 0 where ub <= 0,
// as K2 draws index 0 from a row with no mass.
__device__ __forceinline__ int pick(const u64* pre, int P, double ub) {
  if (!(ub > 0.0)) return 0;
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((double)pre[mid] >= ub)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

__global__ void pg_resample_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ u,
                                   int64_t* __restrict__ idx,
                                   float* __restrict__ ws_out,
                                   float* __restrict__ lml, int P, int final,
                                   int retained) {
  extern __shared__ u64 pre[];  // [P] prefix sums, then [P] weights
  float* w = reinterpret_cast<float*>(pre + P);
  __shared__ float shf[33];
  __shared__ u64 shs[33];
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* x = ws + row * P;
  const int c = (P + blockDim.x - 1) / blockDim.x;
  const int lo = tid * c < P ? tid * c : P;
  const int hi = lo + c < P ? lo + c : P;

  float m = -INFINITY;
  for (int i = tid; i < P; i += blockDim.x) {
    const float v = x[i];
    w[i] = v;
    m = fmaxf(m, v);
  }
  __syncthreads();
  m = fmaxf(pclean_block_max(m, shf), PCLEAN_NEG_INF);

  float s1 = 0.0f, s2 = 0.0f;
  u64 q = 0;
  for (int i = lo; i < hi; ++i) {
    const float p = expf(w[i] - m);
    s1 += p;
    s2 += p * p;
    q += quant(p);
    pre[i] = q;  // the chunk's own prefix; its start is added below
  }
  s1 = pclean_block_sum(s1, shf);
  s2 = pclean_block_sum(s2, shf);
  u64 total;
  const u64 start = block_scan_excl(q, shs, &total);
  for (int i = lo; i < hi; ++i) pre[i] += start;
  __syncthreads();

  const float lse = m + logf(s1);
  const float lml_inc = lse - logf((float)P);
  const double tot = (double)total;
  if (final) {
    if (tid == 0) {
      idx[row] = row * P + pick(pre, P, (double)(1.0f - u[row]) * tot);
      lml[row] = lml_inc;
    }
    return;
  }
  const float ess = s1 * s1 / s2;
  const bool resample = ess < 0.5f * (float)P;
  const float* ur = u + row * P;
  for (int i = tid; i < P; i += blockDim.x) {
    int a = i;
    if (resample && !(retained && i == 0))
      a = pick(pre, P, (double)(1.0f - ur[i]) * tot);
    idx[row * P + i] = row * P + a;
    ws_out[row * P + i] = resample ? 0.0f : w[i];
  }
  if (tid == 0) lml[row] = resample ? lml_inc : 0.0f;
}

// The group path: row = (block's first row) + warp 32 / G + lane / G, lane
// i = lane % G of its group holding weight i.
__global__ void pg_resample_group_kernel(const float* __restrict__ ws,
                                         const float* __restrict__ u,
                                         int64_t* __restrict__ idx,
                                         float* __restrict__ ws_out,
                                         float* __restrict__ lml, int64_t R,
                                         int P, int G, int final,
                                         int retained) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, i = lane & (G - 1);
  const int64_t row = ((int64_t)blockIdx.x * (blockDim.x >> 5) +
                       (threadIdx.x >> 5)) * (32 / G) + lane / G;
  const bool on = row < R && i < P;
  // every load in one round: the weight and its uniform (final: the
  // row's)
  const float w = on ? ws[row * P + i] : -INFINITY;
  const float ui = final ? (row < R ? u[row] : 0.0f)
                         : (on ? u[row * P + i] : 0.0f);
  float m = fmaxf(-INFINITY, w);
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    if (o < G) m = fmaxf(m, __shfl_xor_sync(full, m, o, G));
  m = fmaxf(m, PCLEAN_NEG_INF);
  const float p = on ? expf(w - m) : 0.0f;
  float s1 = p, s2 = __fmul_rn(p, p);
  u64 q = on ? quant(p) : 0ull;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    if (o < G) {
      s1 = __fadd_rn(s1, __shfl_xor_sync(full, s1, o, G));
      s2 = __fadd_rn(s2, __shfl_xor_sync(full, s2, o, G));
    }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    if (o < G) {
      const u64 y = __shfl_up_sync(full, q, o, G);
      if (i >= o) q += y;
    }
  const u64 total = __shfl_sync(full, q, G - 1, G);
  const float lse = m + logf(s1);
  const float lml_inc = lse - logf((float)P);
  const double tot = (double)total, pre = (double)q;
  const double ub = (double)(1.0f - ui) * tot;
  if (final) {
    // the one threshold: the group's prefix sums below it, by one ballot
    const unsigned below = __ballot_sync(full, on && pre < ub);
    const int gbase = lane & ~(G - 1);
    int a = __popc((below >> gbase) & (G == 32 ? full : (1u << G) - 1u));
    a = !(ub > 0.0) ? 0 : a < P - 1 ? a : P - 1;
    if (i == 0 && row < R) {
      idx[row] = row * P + a;
      lml[row] = lml_inc;
    }
    return;
  }
  const float ess = s1 * s1 / s2;
  const bool resample = ess < 0.5f * (float)P;
  int a = 0;
  for (int k = 0; k < P; ++k)
    a += __shfl_sync(full, pre, k, G) < ub ? 1 : 0;
  a = !(ub > 0.0) ? 0 : a < P - 1 ? a : P - 1;
  if (!(resample && !(retained && i == 0))) a = i;
  if (on) {
    idx[row * P + i] = row * P + a;
    ws_out[row * P + i] = resample ? 0.0f : w;
  }
  if (i == 0 && row < R) lml[row] = resample ? lml_inc : 0.0f;
}

}  // namespace

// ws [R, P] f32 and u [R, P] (resample) or [R] (final) f32 in [0, 1);
// idx [R, P] (resample) or [R] (final) int64; ws_out [R, P] f32 (resample
// only, else null); lml [R] f32; contiguous. group 0: the block path, one
// block of `threads` threads a row, `smem` = 12 P bytes of dynamic shared
// memory; group G (a power of two, P <= G <= 32): the group path, blocks
// of `threads` threads, 32 / G rows a warp, smem 0 (ops.pg_resample_plan).
// Returns cudaErrorInvalidValue for a plan it does not take, the error of
// raising the shared-memory limit where the card refuses smem, else
// cudaGetLastError() after the launch.
extern "C" int pclean_pg_resample(const float* ws, const float* u,
                                  int64_t* idx, float* ws_out, float* lml,
                                  int64_t R, int P, int final, int retained,
                                  int threads, int smem, int group,
                                  void* stream) {
  if (P < 1 || P > 16384 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || R < 0 || R > 2147483647ll ||
      (!final && ws_out == nullptr) ||
      (group == 0 ? smem != 12 * P
                  : (group < P || group > 32 || (group & (group - 1)) != 0 ||
                     smem != 0)))
    return (int)cudaErrorInvalidValue;
  if (group > 0) {
    const int64_t rows = (int64_t)(threads / 32) * (32 / group);
    if (R > 0)
      pg_resample_group_kernel<<<(unsigned)((R + rows - 1) / rows), threads,
                                 0, (cudaStream_t)stream>>>(
          ws, u, idx, ws_out, lml, R, P, group, final, retained);
    return (int)cudaGetLastError();
  }
  static int smem_limit = 48 * 1024;  // a property of the function
  if (smem > smem_limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        pg_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_limit = smem;
  }
  if (R > 0) {
    pg_resample_kernel<<<(unsigned)R, threads, smem, (cudaStream_t)stream>>>(
        ws, u, idx, ws_out, lml, P, final, retained);
  }
  return (int)cudaGetLastError();
}
