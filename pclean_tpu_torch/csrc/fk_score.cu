// K12 fk_score: a foreign key's enumeration record and logZ for one row,
// with its two child levels summed in the same launch.
//
// Replaces, in pclean_tpu/engine/propose.py, BlockTracer.score_fk
// (propose.py:521-564) with its Pitman-Yor prior py_logprobs (:241), for
// one dataset row (the one-row loops' B = 1 step, no compact candidate
// axis), together with the sums of its existing and fresh branches'
// children: score_plan's running sums (:383-387) with their copy-mode
// and observed terms (:424-442, :471-499), which XLA fuses into the same
// lax.scan body. For each of the R rows of the enclosing enumeration axes
// and each of the target class's K = cap slots:
//   logden   = log(total + s)
//   exist[k] = alive[k] && refcount[k] > 0
//              ? log(max(refcount[k] - d, 1e-30)) - logden : NEG_INF
//   rec[r, k] = exist[k] + ch_e[r, k]                   (k < K)
//   rec[r, K] = (log(d * nrows + s) - logden) + ch_n[r]
//   logz[r]   = logsumexp(rec[r]) with pclean_tpu.utils.logsumexp's NEG_INF
//               rules,
// s and d the class's Pitman-Yor strength and discount (device scalars
// where the parameters hold them, else the class's constants as words),
// ch_e and ch_n the two levels' postfix sum programs (csrc/level_eval.cuh,
// K20's own code) evaluated at (r, k) over [R, K] and at r over [R].
//
// The record's entries round as the plain version's do, one operation at
// a time (__fadd_rn and friends keep the compiler from fusing a multiply
// and an add, which torch does not), with logf as torch.log on the card,
// and each child rounds step by step as K20 rounds it: the record is
// bit-equal to the plain version's (K20's sums, then K12's arithmetic),
// and logZ agrees to float rounding (its sum runs in another order, as
// K1's).
//
// Bound on the H100 (3.35 TB/s): bytes. refcount and alive read once (5 K
// bytes), the levels' references (each element once) and their gathers'
// distinct matrix entries, the record and logZ written once (4 R (K + 1)
// + 4 R). At one row of a few thousand slots that is tens of KB: a
// launch floor of work, so the kernel is a latency chain: one launch
// where the parent had three.
//
// Design: the plan (ops.fk_score_words: K12's head words, then ch_e's
// level words over [R, K], then ch_n's over [R], each in ops.level_plan's
// layout) is passed by value in the smallest of three parameter blocks
// that holds it (where both levels do not fit the largest with the head,
// ch_n is summed by K20 first and read here as one dense term), so the
// launch needs no table in device memory and is captured in the row graph
// as one node. Geometry (ops.fk_score_plan, ops.score_spread) follows
// ch_e's cost: a slot's level is a chain of dependent loads through the
// program's walk, which a thread taking several slots runs one after
// another, so at one row each slot gets a thread of its own, in a block
// of up to 1,024 or a cluster of up to 8 such blocks a row past 1,024
// slots (the threads looping past 8,192); over more rows a light level
// keeps K1's plan, a warp a row for short rows and a block a row for
// longer ones, each thread taking slots t, t + T, .... Each thread
// computes the prior term, adds its child, writes the record entry and
// folds it into a running (max, sum) pair; thread 0 of the row adds the
// fresh-row entry with ch_n. The pairs merge by warp shuffles, shared
// memory and, over a cluster, distributed shared memory; thread 0 of the
// row writes logZ (csrc/score_rows.cuh). The log of the prior is
// recomputed per row: R is the product of the enclosing enumeration axes,
// small on every path.

#include "level_eval.cuh"
#include "score_rows.cuh"

#define K12_HEAD 32
#define K12_TIER0 256
#define K12_TIER1 1024
// the largest parameter block (32,760 bytes of the 32,764 a launch takes)
#define K12_WORDS 4095

namespace {

using namespace score_rows;

// Word indices of the head (ops.fk_score_words): the leaves, K, the
// counts and their dtype codes, strength and discount (a device pointer,
// else the float's bits), the outputs, R, the geometry (path, threads a
// row, cluster), the instantiation, and where ch_n's level words start
// (ch_e's start at K12_HEAD).
enum { hRefc = 0, hAlive, hK, hTotal, hTotalDt, hNrows, hNrowsDt, hSp,
       hSBits, hDp, hDBits, hRec, hLogz, hR, hPath, hTpr, hCluster,
       hKernel, hNLevel };

template <int W>
struct K12Plan {
  int64_t w[W];
};

__device__ __forceinline__ float scalar(const int64_t* h, int ptr,
                                        int bits) {
  return h[ptr] ? *reinterpret_cast<const float*>(h[ptr])
                : __int_as_float((int)h[bits]);
}

template <int W, int D, bool NARROW>
__global__ void __launch_bounds__(kMaxThreads)
    fk_score_kernel(const __grid_constant__ K12Plan<W> p) {
  const int64_t* h = p.w;
  const int64_t* lve = p.w + K12_HEAD;
  const int64_t* lvn = p.w + h[hNLevel];
  const int64_t R = h[hR];
  const int K = (int)h[hK];
  const Row x = row_of((int)h[hPath], (int)h[hTpr]);
  const int64_t r = x.r;
  const bool in = r < R;
  float m = PCLEAN_NEG_INF, s = 0.0f;
  if (in) {
    const float sv = scalar(h, hSp, hSBits);
    const float dv = scalar(h, hDp, hDBits);
    const float logden = logf(__fadd_rn(
        load_f32(reinterpret_cast<const void*>(h[hTotal]), (int)h[hTotalDt],
                 0),
        sv));
    const int32_t* refcount = reinterpret_cast<const int32_t*>(h[hRefc]);
    const uint8_t* alive = reinterpret_cast<const uint8_t*>(h[hAlive]);
    float* out = reinterpret_cast<float*>(h[hRec]) + r * (int64_t)(K + 1);
    if (x.t == 0) {
      const float nv = load_f32(reinterpret_cast<const void*>(h[hNrows]),
                                (int)h[hNrowsDt], 0);
      const float fresh =
          __fsub_rn(logf(__fadd_rn(__fmul_rn(dv, nv), sv)), logden);
      const float y = __fadd_rn(fresh, level_eval::at<D, NARROW>(lvn, r));
      out[K] = y;
      add(m, s, y);
    }
    for (int k = x.t; k < K; k += x.T) {
      const int32_t cnt = refcount[k];
      const float ex =
          (alive[k] && cnt > 0)
              ? __fsub_rn(logf(fmaxf(__fsub_rn((float)cnt, dv), 1e-30f)),
                          logden)
              : PCLEAN_NEG_INF;
      const float y = __fadd_rn(ex, level_eval::at<D, NARROW>(
                                        lve, r * (int64_t)K + k));
      out[k] = y;
      add(m, s, y);
    }
  }
  row_logz(m, s, x, in, reinterpret_cast<float*>(h[hLogz]));
}

template <int W, int D, bool NARROW>
int launch(const int64_t* words, int n_words, int threads, int cluster,
           int64_t grid_x, int64_t grid_y, cudaStream_t st) {
  K12Plan<W> p;
  for (int i = 0; i < W; ++i) p.w[i] = i < n_words ? words[i] : 0;
  return launch_rows(fk_score_kernel<W, D, NARROW>, p, threads, cluster,
                     grid_x, grid_y, st);
}

template <int W>
int launch_tier(const int64_t* words, int n_words, int kernel, int threads,
                int cluster, int64_t gx, int64_t gy, cudaStream_t st) {
  switch (kernel) {
    case 0: return launch<W, 2, true>(words, n_words, threads, cluster, gx,
                                      gy, st);
    case 1: return launch<W, 4, true>(words, n_words, threads, cluster, gx,
                                      gy, st);
    case 2: return launch<W, 8, true>(words, n_words, threads, cluster, gx,
                                      gy, st);
    default: return launch<W, 0, false>(words, n_words, threads, cluster,
                                        gx, gy, st);
  }
}

}  // namespace

// words: the plan (ops.fk_score_words: the head, ch_e's level words over
// [R, K] from K12_HEAD, ch_n's over [R] from the head's hNLevel word);
// the launch's threads a block and grid (the plan's path: warp, threads
// = 32 rows, grid (ceil(R / rows), 1); block, grid (R, 1); slots, grid
// (cluster, R) in clusters of `cluster` blocks). Returns
// cudaErrorInvalidValue for a plan it does not take (the head's counts
// and geometry, or either level's words: level_eval::check, their
// element counts R K and R and a depth the instantiation holds), else the
// launch's error or cudaGetLastError() after it.
extern "C" int pclean_fk_score(const int64_t* words, int n_words,
                               int threads, int rows, int64_t grid_x,
                               int64_t grid_y, void* stream) {
  if (n_words < K12_HEAD + 2 * K20_HEAD || n_words > K12_WORDS)
    return (int)cudaErrorInvalidValue;
  const int64_t* h = words;
  const int64_t R = h[hR], K = h[hK], kernel = h[hKernel];
  const int64_t cluster = h[hCluster], nl = h[hNLevel];
  if (K < 1 || R < 0 || kernel < 0 || kernel > 3 || h[hRefc] == 0 ||
      h[hAlive] == 0 || h[hTotal] == 0 || h[hNrows] == 0 ||
      h[hRec] == 0 || h[hLogz] == 0 || nl < K12_HEAD + K20_HEAD ||
      nl > n_words - K20_HEAD ||
      !geometry_ok(h[hPath], h[hTpr], cluster, threads, rows, grid_x,
                   grid_y, R))
    return (int)cudaErrorInvalidValue;
  static const int depth[4] = {2, 4, 8, K20_MAX_STACK};
  const int64_t* lve = words + K12_HEAD;
  const int64_t* lvn = words + nl;
  int rc = level_eval::check(lve, nl - K12_HEAD, 1, depth[kernel],
                             kernel < 3, false);
  if (rc == (int)cudaSuccess)
    rc = level_eval::check(lvn, n_words - nl, 1, depth[kernel], kernel < 3,
                           false);
  if (rc != (int)cudaSuccess) return rc;
  if (lve[level_eval::kN] != R * K || lvn[level_eval::kN] != R)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (n_words <= K12_TIER0)
    return launch_tier<K12_TIER0>(words, n_words, (int)kernel, threads,
                                  (int)cluster, grid_x, grid_y, st);
  if (n_words <= K12_TIER1)
    return launch_tier<K12_TIER1>(words, n_words, (int)kernel, threads,
                                  (int)cluster, grid_x, grid_y, st);
  return launch_tier<K12_WORDS>(words, n_words, (int)kernel, threads,
                                (int)cluster, grid_x, grid_y, st);
}
