// K15 batch_write: a batch of accepted row proposals written into a
// class's value columns and alive bits.
//
// Replaces pclean_tpu/engine/smc.py _apply_batch (smc.py:210-227), the
// masked scatters XLA fuses into every batched step (scan_init_batched,
// scan_sweep_class_batched, _replay_alloc_step): for each of B rows with
// ok[b], each stored column's dst[slots[b]] = new[b] converted to dst's
// dtype (torch's .to), and with mark_alive the alive bit set. JAX writes
// where(ok, new, cur[slot]) at every slot; the kernel writes only where
// ok, which leaves the same columns (the slots of one batch are distinct,
// as JAX assumes). A slot follows mode="drop": one in [-C, -1] wraps to
// slot + C, the rest outside [0, C) drop, inside the kernel, so nothing is
// compacted on the host.
//
// Bound on the H100: bytes, a few tens of KB at B = 4,096 (the slots, the
// ok bits, the values read once, an element of each column written); at
// that size the launch itself dominates.
//
// Design: a thread a (column, row) pair, rows fastest, so the values of
// one column load side by side; 256 threads a block; the plan (pointers,
// dtypes, lengths of up to K15_MAX_COLS columns) passed by value. The
// wrapper (ops.batch_write) writes into columns the caller owns: the
// batched drivers' copies of the arenas (smc._apply_batch).

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K15_HEAD 8
#define K15_COL 6
#define K15_MAX_COLS 48
#define K15_WORDS (K15_HEAD + K15_COL * K15_MAX_COLS)
#define K15_THREADS 256

namespace {

struct K15Plan {
  int64_t w[K15_WORDS];
};

__global__ void __launch_bounds__(K15_THREADS)
    batch_write_kernel(const __grid_constant__ K15Plan plan) {
  const int64_t cols = plan.w[0], B = plan.w[1];
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cols * B) return;
  const int64_t c = idx / B, b = idx - c * B;
  if (!reinterpret_cast<const uint8_t*>(plan.w[3])[b]) return;
  const int64_t* col = plan.w + K15_HEAD + K15_COL * c;
  int64_t s = reinterpret_cast<const int64_t*>(plan.w[2])[b];
  if (s < 0) s += col[2];
  if (s < 0 || s >= col[2]) return;
  const int64_t dst = col[0], ddt = col[1], src = col[3], sdt = col[4];
  if (src == 0) {   // the alive bit
    pclean_st_i(dst, ddt, s, 1);
  } else if (!pclean_dt_float(sdt)) {
    pclean_st_i(dst, ddt, s, pclean_ld_i(src, sdt, b));
  } else {
    const double v = pclean_ld_f(src, sdt, b);
    if (ddt == PCLEAN_DT_F32)
      reinterpret_cast<float*>(dst)[s] = (float)v;
    else if (ddt == PCLEAN_DT_F64)
      reinterpret_cast<double*>(dst)[s] = v;
    else if (ddt == PCLEAN_DT_BOOL)
      reinterpret_cast<uint8_t*>(dst)[s] = v != 0.0;
    else
      pclean_st_i(dst, ddt, s, (int64_t)v);
  }
}

}  // namespace

// words: the plan (ops.batch_write's words): [columns, B, slots (int64
// [B]), ok (bool [B]), 0 x 4], then each column [dst, dst dtype, dst
// length, src ([B]) or 0 for True, src dtype, 0]. Returns
// cudaErrorInvalidValue for a plan it does not take, else
// cudaGetLastError() after the launch.
extern "C" int pclean_batch_write(const int64_t* words, int n_words,
                                  void* stream) {
  if (n_words < K15_HEAD || n_words > K15_WORDS || words[0] < 0 ||
      words[0] > K15_MAX_COLS || words[1] < 0 ||
      n_words < K15_HEAD + K15_COL * words[0] || words[2] == 0 ||
      words[3] == 0)
    return (int)cudaErrorInvalidValue;
  K15Plan plan;
  for (int i = 0; i < K15_WORDS; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  const int64_t n = words[0] * words[1];
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + K15_THREADS - 1) / K15_THREADS);
  batch_write_kernel<<<blocks, K15_THREADS, 0, (cudaStream_t)stream>>>(plan);
  return (int)cudaGetLastError();
}
