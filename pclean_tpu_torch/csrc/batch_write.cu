// K15 batch_write: a batch of accepted row proposals written out of place
// into new copies of a class's value columns and alive bits.
//
// Replaces pclean_tpu/engine/smc.py _apply_batch (smc.py:210-227), the
// functional update XLA fuses into every batched step (scan_init_batched,
// scan_sweep_class_batched, _replay_alloc_step): for each stored column,
// a new column equal to the old one except at each slot of a row b with
// ok[b], where it holds new[b] converted to the column's dtype (torch's
// .to); with mark_alive, a new alive vector with those slots set. A slot
// follows mode="drop": one in [-C, -1] wraps to slot + C, the rest outside
// [0, C) drop. The slots of one batch are distinct, as JAX assumes. The
// old columns are never written: the batched deltas read them as the old
// state.
//
// Bound on the H100: bytes. Every column is read once and written once
// (2 C elem a column, 2 C for the alive bits) and the batch is read once
// (B x (8 + 1 + the values' elements)): at scaled's Record (C = 1,000,000,
// four columns and alive) about 34 MB, 0.010 ms at 3.35 TB/s. At the
// latent classes' sizes (64-4,096 slots) the call is a chain of dependent
// reads on the launch floor instead.
//
// Design: one launch for the whole call. The columns are laid end to end
// in one byte space, each starting on a 16-byte boundary. A thread-block
// cluster owns one contiguous share of that space (a multiple of 16 bytes
// a block); at most one block an SM (ops.batch_write_plan: shares of at
// least ops.K15_MIN_SHARE a block, and about a cluster a column where the
// rows' writes would otherwise pile onto few clusters). A copy that fills
// the card takes clusters of one block (larger clusters, scheduled
// together, left SMs idle); a smaller call a block of its cluster for
// each 1,024 rows, up to K15_CLUSTER. Block j of a
// cluster copies the j-th part of the share and takes the j-th part of
// the batch's rows, so a cluster reads the batch once between its
// blocks. Each block
//   1. loads its rows' slots and ok bits into registers (W a thread a
//      round: 2 up to 1,024 rows a block, else 8; a kernel instance each),
//      and those rows' values of the first G columns the share touches (4
//      and 2): a value's address needs only its row, so every load goes
//      out before anything waits;
//   2. copies its part old -> new in 16-byte vectors, K15_UNROLL loads in
//      flight a thread before their stores, a column whose pointers are
//      not 16-byte aligned and a column's ragged end byte by byte;
//   3. works out which of its rows write into the cluster's share (a slot
//      in [tlo, thi) of the column) while the copy's loads are in flight;
//   4. after one cluster barrier (barrier.cluster arrive.release and
//      wait.acquire: every block's copy before any block's writes; a
//      block's __syncthreads where the cluster is one block), stores
//      those rows' values, G columns at a time (the alive bit,
//      int32 and float32 columns by typed stores inline, the rest out of
//      line), loading later groups' values and later rounds' rows then.
// A cluster writes only inside its own share, after the barrier that
// orders its own copy, so the copy comes before the writes with no grid
// sync, no atomics and no second launch. The plan (pointers, dtypes,
// lengths, offsets, the share, a table naming for each block the columns
// its cluster's share touches) travels by value in the parameter block.
//
// pclean_batch_write_scatter is the parent design (a thread a (column, row)
// pair, in place on copies the caller made), kept only as the yardstick
// kernel_bench times this launch against; the port never calls it.

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K15_HEAD 12
#define K15_COL 8
#define K15_MAX_COLS 48
#define K15_MAX_BLOCKS 256
#define K15_TABLE (K15_HEAD + K15_COL * K15_MAX_COLS)
#define K15_WORDS (K15_TABLE + K15_MAX_BLOCKS)
#define K15_THREADS 512
#define K15_CLUSTER 8
#define K15_UNROLL 4

namespace {

struct K15Plan {
  int64_t w[K15_WORDS];
};

// A column's record: [src (old), dst (new), dtype, length, values ([B]) or
// 0 for the alive bit, values' dtype, byte offset in the call's space,
// 1 where src and dst are 16-byte aligned].
__device__ __forceinline__ const int64_t* col_rec(const K15Plan& p, int c) {
  return p.w + K15_HEAD + K15_COL * c;
}

__device__ __forceinline__ int dt_shift(int64_t dt) {
  return dt <= PCLEAN_DT_U8 ? 0
         : dt == PCLEAN_DT_I16 ? 1
         : (dt == PCLEAN_DT_I32 || dt == PCLEAN_DT_F32) ? 2 : 3;
}

// Bytes [lo, hi) of the space, old -> new, starting from column ca (its
// record ra; one: the bytes lie inside it).
__device__ __forceinline__ void copy_part(const K15Plan& p, int64_t lo,
                                          int64_t hi, int ca,
                                          const int64_t* ra, bool one) {
  const int cols = (int)p.w[0];
  const int64_t u1 = hi >> 4;
  int c = ca;   // the column of this thread's unit; its units only grow
  for (int64_t base = (lo >> 4) + threadIdx.x; base < u1;
       base += (int64_t)K15_UNROLL * K15_THREADS) {
    uint4 v[K15_UNROLL];
    uint4* d[K15_UNROLL];
#pragma unroll
    for (int k = 0; k < K15_UNROLL; ++k) {
      const int64_t u = base + (int64_t)k * K15_THREADS;
      d[k] = nullptr;
      if (u >= u1) continue;
      if (!one)   // a part inside one column walks no records
        while (c + 1 < cols && (u << 4) >= col_rec(p, c + 1)[6]) ++c;
      const int64_t* r = one ? ra : col_rec(p, c);
      const int64_t b = (u << 4) - r[6];
      const int64_t nb = r[3] << dt_shift(r[2]);
      if (r[7] && b + 16 <= nb) {
        v[k] = *reinterpret_cast<const uint4*>(r[0] + b);
        d[k] = reinterpret_cast<uint4*>(r[1] + b);
      } else {   // unaligned pointers or the column's ragged end
        const int64_t e = min(b + 16, nb);
        for (int64_t j = b; j < e; ++j)
          reinterpret_cast<uint8_t*>(r[1])[j] =
              reinterpret_cast<const uint8_t*>(r[0])[j];
      }
    }
#pragma unroll
    for (int k = 0; k < K15_UNROLL; ++k)
      if (d[k]) *d[k] = v[k];
  }
}

// dst[s] = the row's value (bits v of dtype sdt; src == 0: the alive
// bit's True) converted as torch's .to does: an integer narrowed as a C
// cast, a float through a double. Out of line, for the column kinds
// store_group does not store inline.
__device__ __noinline__ void store_value(int64_t dst, int64_t ddt, int64_t s,
                                         int64_t src, int64_t sdt,
                                         uint64_t v) {
  if (src == 0) {
    pclean_st_i(dst, ddt, s, 1);
  } else if (!pclean_dt_float(sdt)) {
    pclean_st_i(dst, ddt, s, pclean_bits_i(v, sdt));
  } else {
    const double x = pclean_bits_f(v, sdt);
    if (ddt == PCLEAN_DT_F32)
      reinterpret_cast<float*>(dst)[s] = (float)x;
    else if (ddt == PCLEAN_DT_F64)
      reinterpret_cast<double*>(dst)[s] = x;
    else if (ddt == PCLEAN_DT_BOOL)
      reinterpret_cast<uint8_t*>(dst)[s] = x != 0.0;
    else
      pclean_st_i(dst, ddt, s, (int64_t)x);
  }
}

// The share's slots [tlo, thi) of column r: those whose element lies in
// [lo, hi) (the share and the column both start on 16-byte boundaries).
__device__ __forceinline__ void share_slots(const int64_t* r, int64_t lo,
                                            int64_t hi, int64_t& tlo,
                                            int64_t& thi) {
  const int sh = dt_shift(r[2]);
  tlo = min(r[3], max((int64_t)0, (lo - r[6]) >> sh));
  thi = min(r[3], max((int64_t)0, (hi - r[6]) >> sh));
}

// Rows i0 + tid + k T below `end`: their slots and ok bits (okm: bit k).
template <int W>
__device__ __forceinline__ unsigned load_rows(const int64_t* slots,
                                              const uint8_t* ok, int64_t i0,
                                              int64_t end,
                                              int64_t (&s)[W]) {
  unsigned okm = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int64_t i = i0 + threadIdx.x + k * K15_THREADS;
    s[k] = i < end ? slots[i] : 0;
    okm |= (i < end && ok[i]) ? 1u << k : 0u;
  }
  return okm;
}

// Those rows' values of the columns cg .. cg + G - 1 (those up to
// cb; rg is column cg's record), whatever their slots.
template <int W, int G>
__device__ __forceinline__ void load_group(const K15Plan& p, int cg, int cb,
                                           const int64_t* rg, int64_t i0,
                                           int64_t end,
                                           uint64_t (&v)[G][W]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (cg + g > cb) break;
    const int64_t* r = g == 0 ? rg : col_rec(p, cg + g);
    const int sh = dt_shift(r[5]);
    const int sz = r[4] ? 1 << sh : 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int64_t i = i0 + threadIdx.x + k * K15_THREADS;
      v[g][k] = pclean_ld_bits(r[4] + (i << sh), i < end ? sz : 0);
    }
  }
}

// Which of those rows write into each column of the group inside the
// share [lo, hi), and where: bit k of keep[g] and the slot's offset
// d[g][k] from the share's first slot tlo of the column (a share holds
// far fewer than 2^32 slots). Needs no copy, so it runs before the
// barrier.
template <int W, int G>
__device__ __forceinline__ void mark_group(const K15Plan& p, int cg, int cb,
                                           const int64_t* rg,
                                           const int64_t (&s)[W],
                                           unsigned okm, int64_t lo,
                                           int64_t hi,
                                           unsigned (&keep)[G],
                                           uint32_t (&d)[G][W]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    keep[g] = 0;
    if (cg + g > cb) break;
    const int64_t* r = g == 0 ? rg : col_rec(p, cg + g);
    int64_t tlo, thi;
    share_slots(r, lo, hi, tlo, thi);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int64_t t = s[k] < 0 ? s[k] + r[3] : s[k];
      d[g][k] = (uint32_t)(t - tlo);
      keep[g] |= (((okm >> k) & 1) && t >= tlo && t < thi) ? 1u << k : 0u;
    }
  }
}

// The group's kept rows into their columns: the common column kinds (the
// alive bit, an int32 column of integer values, a float32 column of
// float32 values) by typed stores inline, the rest through store_value.
template <int W, int G>
__device__ __forceinline__ void store_group(const K15Plan& p, int cg, int cb,
                                            int64_t lo, int64_t hi,
                                            const unsigned (&keep)[G],
                                            const uint32_t (&d)[G][W],
                                            const uint64_t (&v)[G][W]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (cg + g > cb) break;
    if (!keep[g]) continue;
    const int64_t* r = col_rec(p, cg + g);
    const int64_t ddt = r[2], src = r[4], sdt = r[5];
    int64_t tlo, thi;
    share_slots(r, lo, hi, tlo, thi);
    if (src == 0 && ddt == PCLEAN_DT_BOOL) {
      uint8_t* o = reinterpret_cast<uint8_t*>(r[1]) + tlo;
#pragma unroll
      for (int k = 0; k < W; ++k)
        if ((keep[g] >> k) & 1) o[d[g][k]] = 1;
    } else if (src != 0 && ddt == PCLEAN_DT_I32 && !pclean_dt_float(sdt)) {
      int32_t* o = reinterpret_cast<int32_t*>(r[1]) + tlo;
#pragma unroll
      for (int k = 0; k < W; ++k)
        if ((keep[g] >> k) & 1)
          o[d[g][k]] = (int32_t)pclean_bits_i(v[g][k], sdt);
    } else if (src != 0 && ddt == PCLEAN_DT_F32 && sdt == PCLEAN_DT_F32) {
      uint32_t* o = reinterpret_cast<uint32_t*>(r[1]) + tlo;
#pragma unroll
      for (int k = 0; k < W; ++k)
        if ((keep[g] >> k) & 1) o[d[g][k]] = (uint32_t)v[g][k];
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k)
        if ((keep[g] >> k) & 1)
          store_value(r[1], ddt, tlo + d[g][k], src, sdt, v[g][k]);
    }
  }
}

// Step 1-3 of the design for the first round of rows and the first group
// of columns: ra is column ca's record.
template <int W, int G>
__device__ __forceinline__ void prologue(
    const K15Plan& p, const int64_t* ra, int ca, int cb, int64_t r_lo,
    int64_t r_hi, int64_t plo, int64_t phi, int64_t lo, int64_t hi,
    unsigned (&keep)[G], uint32_t (&d)[G][W], uint64_t (&v)[G][W]) {
  const int64_t* slots = reinterpret_cast<const int64_t*>(p.w[2]);
  const uint8_t* ok = reinterpret_cast<const uint8_t*>(p.w[3]);
  int64_t s[W];
  const unsigned okm = load_rows<W>(slots, ok, r_lo, r_hi, s);
  load_group<W, G>(p, ca, cb, ra, r_lo, r_hi, v);
  copy_part(p, plo, phi, ca, ra, ca == cb);
  mark_group<W, G>(p, ca, cb, ra, s, okm, lo, hi, keep, d);
}

template <int W, int G>
__global__ void __launch_bounds__(K15_THREADS)
    batch_write_kernel(const __grid_constant__ K15Plan plan) {
  // the header: [columns, B, slots, ok, share, total, blocks a cluster n,
  // part (share / n), rows a block (ceil(B / n)), W, 0, 0]
  const int64_t share = plan.w[4], total = plan.w[5];
  const unsigned n = (unsigned)plan.w[6];
  const unsigned q = blockIdx.x / n, j = blockIdx.x - q * n;
  // the cluster's share [lo, hi), this block's part of it and of the rows
  const int64_t lo = q * share, hi = min(lo + share, total);
  const int64_t plo = min(hi, lo + j * plan.w[7]);
  const int64_t phi = min(hi, plo + plan.w[7]);
  const int64_t r_lo = min(plan.w[1], j * plan.w[8]);
  const int64_t r_hi = min(plan.w[1], r_lo + plan.w[8]);
  // the columns the share touches: [ca, cb] (the plan's block table, read
  // beside the header: no read waits on another)
  const int64_t cw = plan.w[K15_TABLE + blockIdx.x];
  const int ca = (int)(cw & 0xffffffff), cb = (int)(cw >> 32) - 1;
  // the first round's rows and the first group's values, then the copy:
  // every load out before the block waits; which rows write into the
  // share is worked out while the copy's loads are in flight
  unsigned keep[G];
  uint32_t d[G][W];
  uint64_t v[G][W];
  prologue<W, G>(plan, col_rec(plan, ca), ca, cb, r_lo, r_hi, plo, phi, lo,
                 hi, keep, d, v);
  // every block's copy of the share before any block's writes into it
  if (n == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  const int64_t* slots = reinterpret_cast<const int64_t*>(plan.w[2]);
  const uint8_t* ok = reinterpret_cast<const uint8_t*>(plan.w[3]);
  for (int64_t i0 = r_lo; i0 < r_hi;
       i0 += (int64_t)W * K15_THREADS) {
    for (int cg = ca; cg <= cb; cg += G) {
      if (i0 > r_lo || cg > ca) {
        int64_t s[W];
        const unsigned okm = load_rows<W>(slots, ok, i0, r_hi, s);
        load_group<W, G>(plan, cg, cb, col_rec(plan, cg), i0, r_hi, v);
        mark_group<W, G>(plan, cg, cb, col_rec(plan, cg), s, okm, lo, hi,
                         keep, d);
      }
      store_group<W, G>(plan, cg, cb, lo, hi, keep, d, v);
    }
  }
}

// The parent design: a thread a (column, row) pair writing in place.
#define K15_SCATTER_COL 6
#define K15_SCATTER_HEAD 8
#define K15_SCATTER_WORDS (K15_SCATTER_HEAD + K15_SCATTER_COL * K15_MAX_COLS)
#define K15_SCATTER_THREADS 256

struct K15ScatterPlan {
  int64_t w[K15_SCATTER_WORDS];
};

__global__ void __launch_bounds__(K15_SCATTER_THREADS)
    batch_write_scatter_kernel(const __grid_constant__ K15ScatterPlan plan) {
  const int64_t cols = plan.w[0], B = plan.w[1];
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cols * B) return;
  const int64_t c = idx / B, b = idx - c * B;
  if (!reinterpret_cast<const uint8_t*>(plan.w[3])[b]) return;
  const int64_t* col = plan.w + K15_SCATTER_HEAD + K15_SCATTER_COL * c;
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

// words: the plan (ops._k15_launches): [columns, B, slots (int64 [B]),
// ok (bool [B]), share (bytes a cluster, a multiple of 16 x the cluster's
// blocks), total (the space's bytes), blocks a cluster n (1-K15_CLUSTER),
// share / n, ceil(B / n), rows a thread a round W (2, or 8 past 1,024
// rows a block), 0, 0], then each column's record (col_rec), then a word
// a block: the first column its cluster's share touches | (the last +
// 1) << 32, which the kernel reads from K15_TABLE. The grid is
// ceil(total / share) clusters (1 for an empty space) of that many
// blocks of K15_THREADS.
// Returns cudaErrorInvalidValue for a plan it does not take, else the
// launch's error.
extern "C" int pclean_batch_write(const int64_t* words, int n_words,
                                  void* stream) {
  if (n_words < K15_HEAD || n_words > K15_WORDS || words[0] < 0 ||
      words[0] > K15_MAX_COLS || words[1] < 0 || words[2] == 0 ||
      words[3] == 0 || words[6] < 1 || words[6] > K15_CLUSTER ||
      words[4] <= 0 || words[4] % (16 * words[6]) != 0 || words[5] < 0 ||
      (words[5] & 15) != 0 || words[7] * words[6] != words[4] ||
      words[8] * words[6] < words[1] || (words[9] != 2 && words[9] != 8))
    return (int)cudaErrorInvalidValue;
  const int64_t clusters =
      words[5] == 0 ? 1 : (words[5] + words[4] - 1) / words[4];
  const int64_t blocks = clusters * words[6];
  if (blocks > K15_MAX_BLOCKS ||
      n_words != K15_HEAD + K15_COL * words[0] + blocks)
    return (int)cudaErrorInvalidValue;
  if (words[0] == 0) return (int)cudaSuccess;
  // the records where the host put them, the block table at K15_TABLE
  K15Plan plan;
  const int n_rec = K15_HEAD + K15_COL * (int)words[0];
  for (int i = 0; i < K15_TABLE; ++i) plan.w[i] = i < n_rec ? words[i] : 0;
  for (int i = 0; i < K15_MAX_BLOCKS; ++i)
    plan.w[K15_TABLE + i] = i < blocks ? words[n_rec + i] : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(K15_THREADS, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)words[6];
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      words[9] == 2 ? cudaLaunchKernelEx(&cfg, batch_write_kernel<2, 4>, plan)
                    : cudaLaunchKernelEx(&cfg, batch_write_kernel<8, 2>, plan);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The parent's entry (kernel_bench's yardstick): [columns, B, slots, ok,
// 0 x 4], then each column [dst, dst dtype, dst length, src ([B]) or 0 for
// True, src dtype, 0], written in place.
extern "C" int pclean_batch_write_scatter(const int64_t* words, int n_words,
                                          void* stream) {
  if (n_words < K15_SCATTER_HEAD || n_words > K15_SCATTER_WORDS ||
      words[0] < 0 || words[0] > K15_MAX_COLS || words[1] < 0 ||
      n_words < K15_SCATTER_HEAD + K15_SCATTER_COL * words[0] ||
      words[2] == 0 ||
      words[3] == 0)
    return (int)cudaErrorInvalidValue;
  K15ScatterPlan plan;
  for (int i = 0; i < K15_SCATTER_WORDS; ++i)
    plan.w[i] = i < n_words ? words[i] : 0;
  const int64_t n = words[0] * words[1];
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks =
      (unsigned)((n + K15_SCATTER_THREADS - 1) / K15_SCATTER_THREADS);
  batch_write_scatter_kernel<<<blocks, K15_SCATTER_THREADS, 0,
                               (cudaStream_t)stream>>>(plan);
  return (int)cudaGetLastError();
}
