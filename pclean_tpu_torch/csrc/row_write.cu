// K11 row_write: one row's accepted proposal written into the arenas, in
// place.
//
// Replaces pclean_tpu/engine/smc.py apply_row (smc.py:173-207) and the
// ramp's alive write inside scan_init (1023-1083), the masked scatters XLA
// fuses into every sequential loop's scan body: each stored value of the
// row where `accept`, its alive bit where the loop marks it, and each
// birth's values at the birth's slot where accept & is_new, in list order.
// Each write is dst[slot] = src converted to dst's dtype (torch's .to), or
// True for the alive bit, with JAX's mode="drop" rule: a slot in
// [-len, -1] wraps to slot + len, the rest outside [0, len) drop (JAX's
// .at[].set writes cur[slot] back where the mask is false, the same
// arena).
//
// Bound on the H100: neither bytes (tens) nor operations; the chain of
// dependent loads of one write: the slot and the masks, then the value,
// then the store, one round trip to L2 each.
//
// Design: one warp, one launch a row, the plan passed by value. The plan
// gives every destination column one lane (wrapping past 32) and lists
// each lane's writes together, in write order, so two writes into one
// column (two births of one class) apply in list order and no two lanes
// write one address. Each lane walks its own list while the others walk
// theirs, so writes into different columns load and store side by side.

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K11_HEAD (2 + 64)   // n, 0, then (start, count) for 32 lanes
#define K11_WRITE 12
#define K11_MAX_WRITES 64
#define K11_WORDS (K11_HEAD + K11_WRITE * K11_MAX_WRITES)

namespace {

struct K11Plan {
  int64_t w[K11_WORDS];
};

__device__ __forceinline__ bool mask_ok(int64_t p, int64_t dt) {
  return p == 0 || pclean_ld_i(p, dt, 0) != 0;
}

__global__ void row_write_kernel(const __grid_constant__ K11Plan plan) {
  const int lane = threadIdx.x;
  const int64_t first = plan.w[2 + 2 * lane], count = plan.w[3 + 2 * lane];
  for (int64_t j = first; j < first + count; ++j) {
    const int64_t* wr = plan.w + K11_HEAD + K11_WRITE * j;
    // the slot, the masks and the value are loaded together, one round
    // trip, before anything depends on them
    const int64_t s0 = pclean_ld_i(wr[6], wr[7], 0);
    const bool ma = mask_ok(wr[8], wr[9]), mb = mask_ok(wr[10], wr[11]);
    const bool fsrc = pclean_dt_float(wr[5]);
    const double vf = wr[4] != 0 && fsrc ? pclean_ld_f(wr[4], wr[5], 0) : 0.0;
    const int64_t vi = wr[4] == 0 ? 1
                       : (fsrc ? 0 : pclean_ld_i(wr[4], wr[5], 0));
    const int64_t s = s0 < 0 ? s0 + wr[3] : s0;
    if (s < 0 || s >= wr[3] || !ma || !mb) continue;
    const int64_t dst = wr[1], ddt = wr[2];
    if (!fsrc || wr[4] == 0)
      pclean_st_i(dst, ddt, s, vi);
    else if (ddt == PCLEAN_DT_F32)
      reinterpret_cast<float*>(dst)[s] = (float)vf;
    else if (ddt == PCLEAN_DT_F64)
      reinterpret_cast<double*>(dst)[s] = vf;
    else if (ddt == PCLEAN_DT_BOOL)
      reinterpret_cast<uint8_t*>(dst)[s] = vf != 0.0;
    else
      pclean_st_i(dst, ddt, s, (int64_t)vf);
  }
}

}  // namespace

// words: the plan (ops.row_write's words: [n writes, 0], each lane's
// (first write, writes), then the writes, each lane's together: [lane,
// dst, dst dtype, dst len, src or 0 for True, src dtype, slot, slot dtype,
// mask or 0, its dtype, second mask or 0, its dtype]), n_words <=
// K11_WORDS. One block of 32 threads. Returns cudaErrorInvalidValue for a
// plan it does not take, else cudaGetLastError() after the launch.
extern "C" int pclean_row_write(const int64_t* words, int n_words,
                                void* stream) {
  if (n_words < K11_HEAD || n_words > K11_WORDS || words[0] < 0 ||
      words[0] > K11_MAX_WRITES ||
      n_words < K11_HEAD + K11_WRITE * words[0])
    return (int)cudaErrorInvalidValue;
  K11Plan plan;
  for (int i = 0; i < K11_WORDS; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  row_write_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(plan);
  return (int)cudaGetLastError();
}
