// K19 branch_select: a foreign key's existing/fresh branch select over
// every vertex of its subtree, in one launch.
//
// Replaces pclean_tpu/engine/propose.py BlockTracer.sample_fk's select
// after its two branches (propose.py:1093-1097): for each pair j of the
// subtree's (fresh value, existing value) and each row b,
//   out_j[b] = is_new[b] ? new_j[b] : existing_j[b] converted to new_j's
//   dtype (torch's .to: a float truncates toward zero into an integer, a
//   bool is v != 0),
// where a value of one element is broadcast over the B rows.
//
// Bound on the H100 (3.35 TB/s): bytes, each pair's two values and the
// is_new bits read and its output written once: a few KB at B = 4,096;
// the launch itself dominates.
//
// Design: a thread a (pair, row), rows fastest, 256 threads a block; the
// plan (ops.branch_select's words: each pair's pointers, dtypes and
// lengths, up to K19_MAX_PAIRS) is passed by value.

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K19_HEAD 4
#define K19_PAIR 8
#define K19_MAX_PAIRS 64
#define K19_WORDS (K19_HEAD + K19_PAIR * K19_MAX_PAIRS)
#define K19_THREADS 256

namespace {

struct K19Plan {
  int64_t w[K19_WORDS];
};

__global__ void __launch_bounds__(K19_THREADS)
    branch_select_kernel(const __grid_constant__ K19Plan p) {
  const int64_t* w = p.w;
  const int64_t pairs = w[0], B = w[1];
  const int64_t idx = (int64_t)blockIdx.x * K19_THREADS + threadIdx.x;
  if (idx >= pairs * B) return;
  const int64_t j = idx / B, b = idx - j * B;
  // [new, new dtype, new length, existing, existing dtype, existing
  // length, out, 0]
  const int64_t* q = w + K19_HEAD + K19_PAIR * j;
  const int64_t dt = q[1];
  const bool fresh = reinterpret_cast<const uint8_t*>(w[2])[b] != 0;
  if (fresh) {
    const int64_t i = q[2] == 1 ? 0 : b;
    if (pclean_dt_float(dt)) {
      if (dt == PCLEAN_DT_F32)
        reinterpret_cast<float*>(q[6])[b] =
            reinterpret_cast<const float*>(q[0])[i];
      else
        reinterpret_cast<double*>(q[6])[b] =
            reinterpret_cast<const double*>(q[0])[i];
    } else {
      pclean_st_i(q[6], dt, b, pclean_ld_i(q[0], dt, i));
    }
    return;
  }
  const int64_t i = q[5] == 1 ? 0 : b, edt = q[4];
  if (!pclean_dt_float(edt)) {
    const int64_t v = pclean_ld_i(q[3], edt, i);
    if (dt == PCLEAN_DT_F32)
      reinterpret_cast<float*>(q[6])[b] = (float)v;
    else if (dt == PCLEAN_DT_F64)
      reinterpret_cast<double*>(q[6])[b] = (double)v;
    else
      pclean_st_i(q[6], dt, b, v);
    return;
  }
  const double v = pclean_ld_f(q[3], edt, i);
  if (dt == PCLEAN_DT_F32)
    reinterpret_cast<float*>(q[6])[b] = (float)v;
  else if (dt == PCLEAN_DT_F64)
    reinterpret_cast<double*>(q[6])[b] = v;
  else if (dt == PCLEAN_DT_BOOL)
    reinterpret_cast<uint8_t*>(q[6])[b] = v != 0.0;
  else
    pclean_st_i(q[6], dt, b, (int64_t)v);
}

}  // namespace

// words: the plan (ops.branch_select's words): [pairs, B, is_new (bool
// [B]), 0], then each pair [new, new dtype, new length (1 or B),
// existing, existing dtype, existing length (1 or B), out ([B] of new's
// dtype), 0]. Returns cudaErrorInvalidValue for a plan it does not take,
// else cudaGetLastError() after the launch.
extern "C" int pclean_branch_select(const int64_t* words, int n_words,
                                    void* stream) {
  if (n_words < K19_HEAD || n_words > K19_WORDS || words[0] < 0 ||
      words[0] > K19_MAX_PAIRS || words[1] < 0 ||
      n_words != K19_HEAD + K19_PAIR * words[0] || words[2] == 0)
    return (int)cudaErrorInvalidValue;
  K19Plan p;
  for (int i = 0; i < K19_WORDS; ++i) p.w[i] = i < n_words ? words[i] : 0;
  for (int64_t j = 0; j < words[0]; ++j) {
    const int64_t* q = p.w + K19_HEAD + K19_PAIR * j;
    if (q[0] == 0 || q[3] == 0 || q[6] == 0 || q[1] < 0 || q[1] > 7 ||
        q[4] < 0 || q[4] > 7 || (q[2] != 1 && q[2] != words[1]) ||
        (q[5] != 1 && q[5] != words[1]))
      return (int)cudaErrorInvalidValue;
  }
  const int64_t n = words[0] * words[1];
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + K19_THREADS - 1) / K19_THREADS);
  branch_select_kernel<<<blocks, K19_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
