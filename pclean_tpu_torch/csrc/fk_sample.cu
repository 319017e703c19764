// K16 fk_sample: one foreign key's sample step for every row of a block
// proposal, in one launch.
//
// Replaces the body of pclean_tpu/engine/propose.py BlockTracer.sample_fk
// before its children (propose.py:1026-1065), with _inv_cdf_from_u
// (:1153-1172) and the record pick at the ancestor positions: for row b,
//   logits = rec[b, anc_0[b], .., anc_{d-1}[b], :]           (K + 1 entries)
//   chosen = the draw at u[b] (inv_cdf.cuh, K2's own), or, retained, the
//            compact position of the stored slot rv[b] (comp inv, or rv)
//            where alive & refcount > 0 there, else K (re-birth in rv)
//   has_free = not all(mask[b]); free = the first dead slot of mask[b]
//   no free slot: chosen = argmax(logits[:K]) and not new
//   c_exist = min(chosen, K - 1); c_exist_slot = min(comp idx[c_exist],
//            cap - 1) (or c_exist); slot = rv where retained and dead, else
//            free; final = is_new ? slot : c_exist_slot
//   mask_out[b] = mask[b], with mask_out[b, slot] set where is_new & gate.
// Every gather clamps its index as the JAX gathers do; the alive write
// drops a slot outside [0, cap).
//
// Bound on the H100 (3.35 TB/s): bytes. A drawn row's K + 1 logits, its
// mask row (cap bytes, read once; written once where the mask is copied
// into the tracer's own buffer) and a few words a row; at B = 4,096,
// K + 1 = 11,265, cap = 11,264, copying: 185 MB + 92 MB, ~83 us.
//
// Design: one block of 512 threads a row (K2's geometry; the draw is
// inv_cdf.cuh's draw_row), then the block's threads walk the mask row
// once, copying it where the output buffer is not the input, and reduce
// the first dead slot; the argmax of the existing logits runs only where
// the row has no free slot (a block-uniform branch). Thread 0 writes the
// six outputs and, after a barrier that orders it after the row's copy,
// the alive bit. The plan (ops.fk_sample's words: pointers, strides,
// dtypes) is passed by value.

#include "inv_cdf.cuh"
#include "row_words.cuh"

namespace {

using namespace pclean_draw;

// Word indices of the plan (ops.fk_sample); from kAxes, each ancestor
// axis's stride, size, pointer and dtype (ops._rec_words).
enum {
  kB = 0, kK1, kCap, kTile, kSmem, kRec, kNd, kRecB, kU, kUStride, kRv,
  kRvDt, kRelAlive, kRelAliveS, kRelRc, kRelRcS, kCompIdx, kCompIdxDt,
  kCompIdxN, kCompInv, kCompInvDt, kCompInvN, kGate, kMaskIn, kMaskInS,
  kMaskOut, kInts, kFlags, kAxes
};

#define K16_MAX_ANC 7
#define K16_WORDS (kAxes + 4 * K16_MAX_ANC)

struct K16Plan {
  int64_t w[K16_WORDS];
};

// Block min of an int64 (every thread gets it). sh: >= 33 values.
__device__ __forceinline__ int64_t block_min(int64_t v, int64_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t y = __shfl_xor_sync(0xffffffffu, v, o);
    v = y < v ? y : v;
  }
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < kWarps ? sh[lane] : INT64_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const int64_t y = __shfl_xor_sync(0xffffffffu, w, o);
      w = y < w ? y : w;
    }
    if (lane == 0) sh[32] = w;
  }
  __syncthreads();
  const int64_t r = sh[32];
  __syncthreads();
  return r;
}

// The first index of the largest of x[0, n) (torch.argmax's and
// jnp.argmax's tie rule), by every thread of the block.
__device__ __forceinline__ int64_t block_argmax(const float* __restrict__ x,
                                                int64_t n, float* shf,
                                                int64_t* shi) {
  float m = -INFINITY;
  int64_t at = INT64_MAX;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const float v = x[i];
    if (v > m || at == INT64_MAX) {
      m = v;
      at = i;
    }
  }
  const float best = pclean_block_max(m, shf);
  return block_min(m == best ? at : INT64_MAX, shi);
}

__global__ void __launch_bounds__(kThreads)
    fk_sample_kernel(const __grid_constant__ K16Plan p) {
  extern __shared__ float4 buf4[];
  __shared__ float shf[33];
  __shared__ u64 shs[kWarps + 1];
  __shared__ int64_t shi[33];
  __shared__ int32_t drawn;
  const int64_t* w = p.w;
  const int64_t b = blockIdx.x, B = w[kB], K = w[kK1] - 1, cap = w[kCap];
  const int tid = threadIdx.x;

  const float* x = reinterpret_cast<const float*>(w[kRec]) +
                   pclean_rec_offset(w + kAxes, w[kNd], w[kRecB], b);

  int64_t chosen, rv = 0;
  bool dead = false;
  if (w[kRv] != 0) {
    rv = pclean_ld_i(w[kRv], w[kRvDt], b);
    const int64_t r = pclean_clamp(rv, cap);
    const bool live =
        reinterpret_cast<const uint8_t*>(w[kRelAlive])[b * w[kRelAliveS] +
                                                       r] != 0 &&
        reinterpret_cast<const int32_t*>(w[kRelRc])[b * w[kRelRcS] + r] > 0;
    const int64_t pos =
        w[kCompInv] != 0
            ? pclean_ld_i(w[kCompInv], w[kCompInvDt],
                          pclean_clamp(rv, w[kCompInvN]))
            : rv;
    chosen = live ? pos : K;
    dead = !live;
  } else {
    const float u = reinterpret_cast<const float*>(w[kU])[b * w[kUStride]];
    draw_row(x, K + 1, w[kTile], u, buf4, shf, shs, &drawn);
    __syncthreads();
    chosen = drawn;
  }

  // the mask row: copied into the output row where they differ, and the
  // first dead slot
  const uint8_t* mi = reinterpret_cast<const uint8_t*>(w[kMaskIn]) +
                      b * w[kMaskInS];
  uint8_t* mo = reinterpret_cast<uint8_t*>(w[kMaskOut]) + b * cap;
  const bool copy = mi != mo;
  int64_t first = INT64_MAX;
  for (int64_t i = tid; i < cap; i += kThreads) {
    const uint8_t v = mi[i];
    if (copy) mo[i] = v;
    if (!v && i < first) first = i;
  }
  first = block_min(first, shi);   // its barriers order the copy too
  const bool has_free = first < cap;
  const int64_t free_slot = has_free ? first : 0;

  bool is_new = chosen == K;
  if (is_new && !has_free) {   // full arena: the best existing candidate
    chosen = block_argmax(x, K, shf, shi);
    is_new = false;
  }
  if (tid != 0) return;
  const bool gate =
      reinterpret_cast<const uint8_t*>(w[kGate])[b] != 0;
  const bool eff = is_new && gate;
  const int64_t c_exist = chosen < K - 1 ? chosen : K - 1;
  int64_t c_slot = c_exist;
  if (w[kCompIdx] != 0) {
    c_slot = pclean_ld_i(w[kCompIdx], w[kCompIdxDt],
                         pclean_clamp(c_exist, w[kCompIdxN]));
    c_slot = c_slot < cap - 1 ? c_slot : cap - 1;
  }
  const int64_t slot = (w[kRv] != 0 && dead) ? rv : free_slot;
  int32_t* ints = reinterpret_cast<int32_t*>(w[kInts]);
  uint8_t* flags = reinterpret_cast<uint8_t*>(w[kFlags]);
  ints[b] = (int32_t)(is_new ? slot : c_slot);
  ints[B + b] = (int32_t)c_exist;
  ints[2 * B + b] = (int32_t)c_slot;
  ints[3 * B + b] = (int32_t)slot;
  flags[b] = is_new;
  flags[B + b] = eff;
  if (eff && slot >= 0 && slot < cap) mo[slot] = 1;
}

}  // namespace

// words: the plan (ops.fk_sample's words, K16_WORDS of them). Returns
// cudaErrorInvalidValue for a plan it does not take, the error of raising
// the shared-memory limit where the card refuses the draw's smem, else
// cudaGetLastError() after the launch.
extern "C" int pclean_fk_sample(const int64_t* words, int n_words,
                                void* stream) {
  if (n_words != K16_WORDS) return (int)cudaErrorInvalidValue;
  K16Plan p;
  for (int i = 0; i < K16_WORDS; ++i) p.w[i] = words[i];
  const int64_t B = p.w[kB];
  const bool drawn = p.w[kRv] == 0;
  int smem = 0;
  if (B < 0 || p.w[kK1] < 2 || p.w[kCap] < 1 || p.w[kNd] < 0 ||
      p.w[kNd] > K16_MAX_ANC || p.w[kRec] == 0 || p.w[kGate] == 0 ||
      p.w[kMaskIn] == 0 || p.w[kMaskOut] == 0 || p.w[kInts] == 0 ||
      p.w[kFlags] == 0 || (drawn && p.w[kU] == 0) ||
      (!drawn && (p.w[kRelAlive] == 0 || p.w[kRelRc] == 0)))
    return (int)cudaErrorInvalidValue;
  if (drawn) {
    smem = (int)p.w[kSmem];
    if (!plan_ok(p.w[kK1], p.w[kTile], smem))
      return (int)cudaErrorInvalidValue;
  }
  static int smem_limit = 48 * 1024;
  const cudaError_t e = smem_attr(fk_sample_kernel, smem, &smem_limit);
  if (e != cudaSuccess) return (int)e;
  if (B > 0)
    fk_sample_kernel<<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
        p);
  return (int)cudaGetLastError();
}
