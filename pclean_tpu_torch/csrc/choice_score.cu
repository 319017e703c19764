// K13 choice_score: an enumerable choice's record and logZ for one row.
//
// Replaces, in pclean_tpu/engine/propose.py, the enumerable branch of
// BlockTracer.score_choice (propose.py:454-519) from its enum logits to
// the logsumexp, for one dataset row (the one-row loops' B = 1 step). For
// each of the R rows of the enclosing enumeration axes and each of the
// choice's V options:
//   logit[r, v] = state[r] == 1 ? (v == obs[r] ? obs_ld[r] : NEG_INF)
//                               : enum[r, v]
//   rec[r, v]   = logit[r, v] + children[r, v]
//   logz[r]     = logsumexp(rec[r]) with pclean_tpu.utils.logsumexp's
//                 NEG_INF rules.
// The state is a static code (a kernel argument: 0 where the choice has
// no observation) or a per-row int8 flag (0 unobserved, 1 observed, 2
// missing). Every operand comes with its strides (0 on an axis it
// broadcasts over), so the enum logits and the children are read in place.
//
// The record's entries round as the plain version's (one __fadd_rn): the
// record is bit-equal to it, logZ agrees to float rounding (K1's rule).
//
// Bound on the H100 (3.35 TB/s): bytes. enum and children read once (at
// most 4 R V each), the observation, its log-density and the state once a
// row, the record and logZ written once (4 R V + 4 R): a few hundred bytes
// at one row, so the launch is a latency chain on the launch floor.
//
// Design: K1's plan at the same (R, V) in choice mode
// (ops.choice_score_plan): a warp a row for V <= 512 (every path's
// vocabulary), a block a row above. Each thread takes options t, t + T,
// ..., writes their record entries and folds them into a running (max,
// sum) pair; shuffles (and shared memory, a block a row) merge the pairs
// and thread 0 writes logZ.

#include "score_rows.cuh"

namespace {

using namespace score_rows;

__global__ void choice_score_kernel(
    const float* __restrict__ en, const float* __restrict__ ch,
    const float* __restrict__ obs_ld, const void* obs, int obs_dt,
    const int8_t* __restrict__ state, int static_code, int V, Axes ax,
    Strides ens, int64_t es, Strides chs, int64_t cs, Strides lds,
    Strides obss, Strides sts, float* __restrict__ rec,
    float* __restrict__ logz, int64_t R, int tpr) {
  __shared__ float sh[64];
  const int t = threadIdx.x % tpr;
  const int64_t r =
      (int64_t)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool in = r < R;
  float m = PCLEAN_NEG_INF, s = 0.0f;
  if (in) {
    const int code = state ? (int)state[offset(ax, sts, r)] : static_code;
    const bool seen = obs != nullptr && code == 1;
    const int64_t ov = seen ? load_i64(obs, obs_dt, offset(ax, obss, r)) : 0;
    const float ld = seen ? obs_ld[offset(ax, lds, r)] : 0.0f;
    const float* e = en + offset(ax, ens, r);
    const float* c = ch + offset(ax, chs, r);
    float* out = rec + r * (int64_t)V;
    for (int v = t; v < V; v += tpr) {
      const float lg = seen ? (v == ov ? ld : PCLEAN_NEG_INF)
                            : e[(int64_t)v * es];
      const float x = __fadd_rn(lg, c[(int64_t)v * cs]);
      out[v] = x;
      add(m, s, x);
    }
  }
  reduce(m, s, tpr, sh);
  if (in && t == 0) logz[r] = finish(m, s);
}

void fill(Strides& dst, const int64_t* src, int n) {
  for (int i = 0; i < n; ++i) dst.s[i] = src ? src[i] : 0;
}

}  // namespace

// enum and children read over `nd` row axes `sizes` with strides of nd + 1
// entries (the last the option axis); obs_ld, obs (dtype code obs_dt) and
// state (int8) with strides of nd entries, each null where absent (obs
// null: no observation, the logits are enum; state null: static_code for
// every row); rec [R, V] and logz [R] written. Geometry as
// pclean_fk_score's.
extern "C" int pclean_choice_score(
    const float* en, const float* ch, const float* obs_ld, const void* obs,
    int obs_dt, const int8_t* state, int static_code, int V, int nd,
    const int64_t* sizes, const int64_t* en_strides,
    const int64_t* ch_strides, const int64_t* ld_strides,
    const int64_t* obs_strides, const int64_t* st_strides, float* rec,
    float* logz, int64_t R, int threads, int rows, int64_t grid,
    void* stream) {
  if (V < 1 || nd < 0 || nd > kMaxDims || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || rows < 1 || threads % rows != 0 ||
      (rows > 1 && threads / rows != 32) || grid < 0 ||
      grid > 2147483647ll || grid * rows < R ||
      (obs != nullptr && obs_ld == nullptr))
    return (int)cudaErrorInvalidValue;
  Axes ax{};
  ax.nd = nd;
  for (int i = 0; i < nd; ++i) ax.size[i] = sizes[i];
  Strides ens{}, chs{}, lds{}, obss{}, sts{};
  fill(ens, en_strides, nd);
  fill(chs, ch_strides, nd);
  fill(lds, ld_strides, nd);
  fill(obss, obs_strides, nd);
  fill(sts, st_strides, nd);
  if (R > 0) {
    choice_score_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
        en, ch, obs_ld, obs, obs_dt, state, static_code, V, ax, ens,
        en_strides[nd], chs, ch_strides[nd], lds, obss, sts, rec, logz, R,
        threads / rows);
  }
  return (int)cudaGetLastError();
}
