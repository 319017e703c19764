// K21 py_prior: a batched foreign key's Pitman-Yor prior and children,
// K1's two inputs, in one launch.
//
// Replaces, in pclean_tpu/engine/propose.py, BlockTracer.py_logprobs
// (propose.py:241-258) and the batched score_fk's compaction select and
// adds before its logsumexp (:521-566). For each of the R rows of the
// enclosing enumeration axes (batch coordinate b) and each of the K
// candidate positions k:
//   logden    = log(total[b] + s)
//   slot      = comp ? min(idx[k], cap - 1) : k
//   prior     = comp && k >= nc ? NEG_INF
//             : alive[b, slot] && refcount[b, slot] > 0
//               ? log(max(refcount[b, slot] - d, 1e-30)) - logden : NEG_INF
//   exist[r, k] = prior + children[r, k]
//   new[r]      = (log(d * nrows[b] + s) - logden) + new_children[r]
// with the leaves shared ([cap], row stride 0) or per row ([B, cap]),
// total and nrows one element or [B], s and d the class's Pitman-Yor
// strength and discount (device scalars, or constants in the plan). The
// children come with their strides (0 on an axis they broadcast over).
//
// Bits: one rounding an operation (__fadd_rn, __fsub_rn, __fmul_rn: no
// contraction into a fused multiply-add, which torch does not do), logf as
// torch.log on the card: both outputs bit-equal to the plain version's.
//
// Bound on the H100 (3.35 TB/s): bytes. The leaves' entries at the K
// candidates read once (5 bytes a slot, per row where they are per row),
// the children once (4 R K where they vary over the rows), idx once, and
// exist [R, K] and new [R] written once: at B = 4,096 rows of 11,264 slots,
// about 370 MB, ~0.11 ms.
//
// Design: a thread an output entry, 256 threads a block, the R x K exist
// entries first, then the R new entries. The plan (ops.py_prior's words)
// is passed by value, so the launch can be captured in a CUDA graph.

#include <cuda_runtime.h>

#include "row_words.cuh"
#include "score_rows.cuh"

#define K21_WORDS 64
#define K21_THREADS 256
#define K21_MAX_DIMS 8

namespace {

struct K21Plan {
  int64_t w[K21_WORDS];
};

// Word indices of the plan (ops.py_prior).
enum {
  kRef = 0, kAlive, kRowStride, kCap, kTotal, kTotalDt, kTotalStride,
  kNrows, kNrowsDt, kNrowsStride, kS, kSBits, kD, kDBits, kIdx, kIdxDt,
  kNc, kNcDt, kCh, kNch, kExist, kNew, kR, kK, kNd, kSizes,
  kChStrides = kSizes + K21_MAX_DIMS, kChK = kChStrides + K21_MAX_DIMS,
  kNchStrides
};

__device__ __forceinline__ float scalar(const int64_t* w, int ptr, int bits) {
  return w[ptr] ? *reinterpret_cast<const float*>(w[ptr])
                : __int_as_float((int)w[bits]);
}

__global__ void __launch_bounds__(K21_THREADS)
    py_prior_kernel(const __grid_constant__ K21Plan p) {
  const int64_t* w = p.w;
  const int64_t R = w[kR], K = w[kK];
  const int64_t i = (int64_t)blockIdx.x * K21_THREADS + threadIdx.x;
  if (i >= R * K + R) return;
  const bool is_new = i >= R * K;
  const int64_t r = is_new ? i - R * K : i / K;
  const int64_t k = is_new ? 0 : i % K;
  // the row's offset into each child and its batch coordinate
  const int nd = (int)w[kNd];
  int64_t rem = r, och = 0, onch = 0, b = 0;
#pragma unroll
  for (int d = K21_MAX_DIMS - 1; d >= 0; --d) {
    if (d < nd) {
      const int64_t n = w[kSizes + d];
      const int64_t c = rem % n;
      rem /= n;
      och += c * w[kChStrides + d];
      onch += c * w[kNchStrides + d];
      if (d == 0) b = c;
    }
  }
  const float s = scalar(w, kS, kSBits), dv = scalar(w, kD, kDBits);
  const float total = (float)pclean_ld_f(w[kTotal], w[kTotalDt],
                                         b * w[kTotalStride]);
  const float logden = logf(__fadd_rn(total, s));
  if (is_new) {
    const float nv = (float)pclean_ld_f(w[kNrows], w[kNrowsDt],
                                        b * w[kNrowsStride]);
    const float fresh =
        __fsub_rn(logf(__fadd_rn(__fmul_rn(dv, nv), s)), logden);
    reinterpret_cast<float*>(w[kNew])[r] = __fadd_rn(
        fresh, reinterpret_cast<const float*>(w[kNch])[onch]);
    return;
  }
  const int64_t cap = w[kCap];
  float prior = PCLEAN_NEG_INF;
  bool in = true;
  int64_t slot = k;
  if (w[kIdx]) {
    in = k < pclean_ld_i(w[kNc], w[kNcDt], 0);
    slot = pclean_ld_i(w[kIdx], w[kIdxDt], k);
    slot = slot < cap - 1 ? slot : cap - 1;
    slot = slot < 0 ? 0 : slot;  // take()'s clamp
  }
  if (in) {
    const int64_t at = b * w[kRowStride] + slot;
    const int32_t cnt = reinterpret_cast<const int32_t*>(w[kRef])[at];
    const bool live = reinterpret_cast<const uint8_t*>(w[kAlive])[at] &&
                      cnt > 0;
    if (live)
      prior = __fsub_rn(logf(fmaxf(__fsub_rn((float)cnt, dv), 1e-30f)),
                        logden);
  }
  reinterpret_cast<float*>(w[kExist])[r * K + k] = __fadd_rn(
      prior, reinterpret_cast<const float*>(w[kCh])[och + k * w[kChK]]);
}

}  // namespace

// words: the plan (ops.py_prior's words, K21_WORDS of them). Returns
// cudaErrorInvalidValue for a plan it does not take, else
// cudaGetLastError() after the launch.
extern "C" int pclean_py_prior(const int64_t* words, int n_words,
                               void* stream) {
  if (n_words != K21_WORDS) return (int)cudaErrorInvalidValue;
  K21Plan p;
  for (int i = 0; i < K21_WORDS; ++i) p.w[i] = words[i];
  const int64_t* w = p.w;
  if (w[kR] < 0 || w[kK] < 1 || w[kCap] < 1 || w[kNd] < 1 ||
      w[kNd] > K21_MAX_DIMS || !w[kRef] || !w[kAlive] || !w[kTotal] ||
      !w[kNrows] || !w[kCh] || !w[kNch] || !w[kExist] || !w[kNew] ||
      (w[kIdx] && !w[kNc]) || (!w[kIdx] && w[kK] != w[kCap]))
    return (int)cudaErrorInvalidValue;
  const int64_t n = w[kR] * (w[kK] + 1);
  if (n == 0) return (int)cudaSuccess;
  const int64_t blocks = (n + K21_THREADS - 1) / K21_THREADS;
  py_prior_kernel<<<(unsigned)blocks, K21_THREADS, 0,
                    (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
