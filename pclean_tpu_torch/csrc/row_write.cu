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
// Bound on the H100: neither bytes (tens) nor operations; one round of
// dependent loads (every write's slot, masks and value side by side),
// then the stores.
//
// Design: one block of 128 threads, one launch a row, the plan passed by
// value in one parameter block (a block's size costs a launch nothing,
// what is read of it does: PERF.md section 3). The writes share their
// indices: the row's values one slot and `accept`, its alive bit the slot
// alone, each birth's values the birth's slot, `accept` and is_new. So
// the plan is a table of index groups (a group's slot, its masks, the
// length of the columns it writes into) and three words a write (its
// destination, its source or 0 for True, and one word packing the next
// write into the same column, its group and both dtypes), each field an
// array of its own, so a warp reads consecutive words. Thread 64 + g loads
// group g's slot and masks and thread j write j's value, so the groups'
// and the writes' words are read by warps of their own side by side (a
// warp's parameter reads go one after another: with the groups on the
// writes' warp, hospital's Record row took 0.0027 device ms on an H100,
// on warps of their own 0.0020, PERF.md). Every load is issued before any
// is used (a warp issues in order and stalls at the first use of a load
// in flight), and each is one predicated instruction of the element's
// size, so lanes of different dtypes do not diverge on a load and wait
// once. Each group's thread resolves its slot (the drop rule) and masks
// into shared memory; after one barrier each write's thread takes its
// group's and stores only where no later write into its column applies
// at the same slot (it follows the plan's links through them), so two
// writes into one column (two births of one class) keep list order with
// one store an address.

#include <cuda_runtime.h>
#include <string.h>

#include "row_words.cuh"

// The plan's words (ops.row_write_plan): the header (writes, groups), the
// groups' slot, first mask and second mask pointers and packed words
// (length << 12 | second mask's dtype << 8 | first mask's << 4 | slot's),
// then the writes' destinations, sources and packed words (next write
// into the same column + 1 << 16 | group << 8 | source's dtype << 4 |
// destination's).
#define K11_MAX_WRITES 64
#define K11_MAX_GROUPS 64
#define K11_HEAD 2
#define K11_G_SLOT K11_HEAD
#define K11_G_MA (K11_G_SLOT + K11_MAX_GROUPS)
#define K11_G_MB (K11_G_MA + K11_MAX_GROUPS)
#define K11_G_PK (K11_G_MB + K11_MAX_GROUPS)
#define K11_W_DST (K11_G_PK + K11_MAX_GROUPS)
#define K11_W_SRC (K11_W_DST + K11_MAX_WRITES)
#define K11_W_PK (K11_W_SRC + K11_MAX_WRITES)
#define K11_WORDS (K11_W_PK + K11_MAX_WRITES)
// the writes on threads 0-63, the groups on 64-127: a warp issues its
// parameter reads in turn, so the two tables are read side by side
#define K11_THREADS (K11_MAX_WRITES + K11_MAX_GROUPS)

namespace {

struct K11Plan {
  int64_t w[K11_WORDS];
};

__device__ __forceinline__ int dt_field(int64_t pk, int k) {
  return (int)((pk >> (4 * k)) & 15);
}

__global__ void __launch_bounds__(K11_THREADS)
    row_write_kernel(const __grid_constant__ K11Plan plan) {
  __shared__ int64_t sh_slot[K11_MAX_GROUPS];
  __shared__ uint8_t sh_ok[K11_MAX_GROUPS];
  const int64_t* w = plan.w;
  const int t = threadIdx.x, gt = t - K11_MAX_WRITES;   // gt: a group
  const int n = (int)w[0], ng = (int)w[1];
  const bool grp = gt >= 0 && gt < ng;
  // every load of the row goes out before any value is used
  int64_t gpk = 0, ma = 0, mb = 0;
  uint64_t sb = 0, ab = 0, bb = 0;
  if (grp) {
    gpk = w[K11_G_PK + gt];
    ma = w[K11_G_MA + gt];
    mb = w[K11_G_MB + gt];
    sb = pclean_ld_bits(w[K11_G_SLOT + gt],
                        pclean_dt_size(dt_field(gpk, 0)));
    ab = pclean_ld_bits(ma, ma ? pclean_dt_size(dt_field(gpk, 1)) : 0);
    bb = pclean_ld_bits(mb, mb ? pclean_dt_size(dt_field(gpk, 2)) : 0);
  }
  int64_t dst = 0, src = 0, wpk = 0;
  uint64_t vb = 0;
  if (t < n) {
    dst = w[K11_W_DST + t];
    src = w[K11_W_SRC + t];
    wpk = w[K11_W_PK + t];
    vb = pclean_ld_bits(src, src ? pclean_dt_size(dt_field(wpk, 1)) : 0);
  }
  // group gt: its slot under the drop rule and whether its writes apply
  if (grp) {
    const int64_t len = gpk >> 12;
    int64_t s = pclean_bits_i(sb, dt_field(gpk, 0));
    s = s < 0 ? s + len : s;
    const bool ok = (!ma || pclean_bits_i(ab, dt_field(gpk, 1)) != 0) &&
                    (!mb || pclean_bits_i(bb, dt_field(gpk, 2)) != 0) &&
                    s >= 0 && s < len;
    sh_slot[gt] = s;
    sh_ok[gt] = ok;
  }
  __syncthreads();
  if (t >= n) return;
  const int g = (int)((wpk >> 8) & 255);
  if (!sh_ok[g]) return;
  const int64_t s = sh_slot[g];
  // a later write into this column that applies at this slot stores last
  for (int nx = (int)(wpk >> 16); nx;) {
    const int64_t pk = w[K11_W_PK + nx - 1];
    const int h = (int)((pk >> 8) & 255);
    if (sh_ok[h] && sh_slot[h] == s) return;
    nx = (int)(pk >> 16);
  }
  const int ddt = dt_field(wpk, 0), sdt = dt_field(wpk, 1);
  if (!src || !pclean_dt_float(sdt)) {
    pclean_st_i(dst, ddt, s, src ? pclean_bits_i(vb, sdt) : 1);
    return;
  }
  const double vf = pclean_bits_f(vb, sdt);
  if (ddt == PCLEAN_DT_F32)
    reinterpret_cast<float*>(dst)[s] = (float)vf;
  else if (ddt == PCLEAN_DT_F64)
    reinterpret_cast<double*>(dst)[s] = vf;
  else if (ddt == PCLEAN_DT_BOOL)
    reinterpret_cast<uint8_t*>(dst)[s] = vf != 0.0;
  else
    pclean_st_i(dst, ddt, s, (int64_t)vf);
}

}  // namespace

// words: the plan (ops.row_write_plan's words, K11_WORDS of them): at most
// K11_MAX_WRITES writes and K11_MAX_GROUPS groups, each write's group
// below the groups' count and its link to a later write of this launch.
// One block of K11_THREADS threads. Returns cudaErrorInvalidValue for a
// plan it does not take, else cudaGetLastError() after the launch.
extern "C" int pclean_row_write(const int64_t* words, int n_words,
                                void* stream) {
  if (n_words != K11_WORDS) return (int)cudaErrorInvalidValue;
  const int64_t n = words[0], ng = words[1];
  if (n < 0 || n > K11_MAX_WRITES || ng < 0 || ng > K11_MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  for (int64_t g = 0; g < ng; ++g)
    if (!words[K11_G_SLOT + g] || words[K11_G_PK + g] < 0)
      return (int)cudaErrorInvalidValue;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t pk = words[K11_W_PK + j], nx = pk >> 16;
    if (!words[K11_W_DST + j] || pk < 0 || ((pk >> 8) & 255) >= ng ||
        (nx != 0 && (nx <= j + 1 || nx > n)))
      return (int)cudaErrorInvalidValue;
  }
  K11Plan plan;
  memcpy(plan.w, words, sizeof(plan.w));
  row_write_kernel<<<1, K11_THREADS, 0, (cudaStream_t)stream>>>(plan);
  return (int)cudaGetLastError();
}
