// K12 fk_score: a foreign key's enumeration record and logZ for one row.
//
// Replaces, in pclean_tpu/engine/propose.py, BlockTracer.score_fk
// (propose.py:521-564) with its Pitman-Yor prior py_logprobs (:241), for
// one dataset row (the one-row loops' B = 1 step, no compact candidate
// axis). For each of the R rows of the enclosing enumeration axes and each
// of the target class's K = cap slots:
//   logden   = log(total + s)
//   exist[k] = alive[k] && refcount[k] > 0
//              ? log(max(refcount[k] - d, 1e-30)) - logden : NEG_INF
//   rec[r, k] = exist[k] + children[r, k]               (k < K)
//   rec[r, K] = (log(d * nrows + s) - logden) + new_children[r]
//   logz[r]   = logsumexp(rec[r]) with pclean_tpu.utils.logsumexp's NEG_INF
//               rules,
// s and d the class's Pitman-Yor strength and discount (device scalars
// where the parameters hold them, else the class's constants as kernel
// arguments). The children come with their strides (0 on an axis they
// broadcast over), so a broadcast operand is read in place, never copied.
//
// The record's entries round as the plain version's do, one operation at
// a time (__fadd_rn and friends keep the compiler from fusing a multiply
// and an add, which torch does not), with logf as torch.log on the card:
// the record is bit-equal to the plain version's on the card, and logZ
// agrees to float rounding (its sum runs in another order, as K1's).
//
// Bound on the H100 (3.35 TB/s): bytes. refcount and alive are read once
// (5 K bytes), the children once (4 R K where they vary over the rows,
// else 4 K), and the record and logZ written once (4 R (K + 1) + 4 R). At
// one row of a few thousand slots that is tens of KB: a launch floor of
// work, so the kernel is a latency chain: one pass, each thread's loads
// issued back to back, no second kernel.
//
// Design: the geometry of K1's plan at the same (R, K) (ops.fk_score_plan):
// a warp a row for short rows, a block a row for longer ones (where K1
// would split a row over a cluster, one block of K1's widest). Each thread
// takes slots t, t + T, ... of its row, computes the prior term, adds its
// child, writes the record entry and folds it into a running (max, sum)
// pair; thread 0 adds the fresh-row entry. The pairs merge by warp
// shuffles (and, a block a row, through shared memory), and thread 0
// writes logZ. The log of the prior is recomputed per row: R is the
// product of the enclosing enumeration axes, small on every path.

#include "score_rows.cuh"

namespace {

using namespace score_rows;

__global__ void fk_score_kernel(
    const int32_t* __restrict__ refcount, const uint8_t* __restrict__ alive,
    int K, const void* total, int total_dt, const void* nrows, int nrows_dt,
    const float* strength_p, const float* discount_p, float strength,
    float discount, const float* __restrict__ ch,
    const float* __restrict__ nch, Axes ax, Strides chs, int64_t sk,
    Strides ncs, float* __restrict__ rec, float* __restrict__ logz,
    int64_t R, int tpr) {
  __shared__ float sh[64];
  const int t = threadIdx.x % tpr;
  const int64_t r =
      (int64_t)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool in = r < R;
  float m = PCLEAN_NEG_INF, s = 0.0f;
  if (in) {
    const float sv = strength_p ? *strength_p : strength;
    const float dv = discount_p ? *discount_p : discount;
    const float logden = logf(__fadd_rn(load_f32(total, total_dt, 0), sv));
    const float* c = ch + offset(ax, chs, r);
    float* out = rec + r * (int64_t)(K + 1);
    if (t == 0) {
      const float nv = load_f32(nrows, nrows_dt, 0);
      const float fresh =
          __fsub_rn(logf(__fadd_rn(__fmul_rn(dv, nv), sv)), logden);
      const float x = __fadd_rn(fresh, nch[offset(ax, ncs, r)]);
      out[K] = x;
      add(m, s, x);
    }
    for (int k = t; k < K; k += tpr) {
      const int32_t cnt = refcount[k];
      const float ex =
          (alive[k] && cnt > 0)
              ? __fsub_rn(logf(fmaxf(__fsub_rn((float)cnt, dv), 1e-30f)),
                          logden)
              : PCLEAN_NEG_INF;
      const float x = __fadd_rn(ex, c[(int64_t)k * sk]);
      out[k] = x;
      add(m, s, x);
    }
  }
  reduce(m, s, tpr, sh);
  if (in && t == 0) logz[r] = finish(m, s);
}

}  // namespace

// refcount [K] int32, alive [K] bool; total and nrows one element of dtype
// code total_dt / nrows_dt; strength_p / discount_p a device float or null
// (then the float arguments); children read at ch + offset over `nd` row
// axes `sizes` with `ch_strides` (nd + 1, the last the slot axis),
// new_children at nch with `nc_strides` (nd); rec [R, K + 1] and logz [R]
// written. `threads` threads a block, `rows` rows a block (threads / rows a
// row: 32, or the whole block with rows = 1), `grid` blocks.
extern "C" int pclean_fk_score(
    const int32_t* refcount, const uint8_t* alive, int K, const void* total,
    int total_dt, const void* nrows, int nrows_dt, const float* strength_p,
    const float* discount_p, float strength, float discount,
    const float* ch, const float* nch, int nd, const int64_t* sizes,
    const int64_t* ch_strides, const int64_t* nc_strides, float* rec,
    float* logz, int64_t R, int threads, int rows, int64_t grid,
    void* stream) {
  if (K < 1 || nd < 0 || nd > kMaxDims || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || rows < 1 || threads % rows != 0 ||
      (rows > 1 && threads / rows != 32) || grid < 0 ||
      grid > 2147483647ll || grid * rows < R)
    return (int)cudaErrorInvalidValue;
  Axes ax{};
  Strides chs{}, ncs{};
  ax.nd = nd;
  for (int i = 0; i < nd; ++i) {
    ax.size[i] = sizes[i];
    chs.s[i] = ch_strides[i];
    ncs.s[i] = nc_strides[i];
  }
  if (R > 0) {
    fk_score_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
        refcount, alive, K, total, total_dt, nrows, nrows_dt, strength_p,
        discount_p, strength, discount, ch, nch, ax, chs, ch_strides[nd],
        ncs, rec, logz, R, threads / rows);
  }
  return (int)cudaGetLastError();
}
