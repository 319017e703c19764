// K13 choice_score: an enumerable choice's record and logZ for one row,
// with its child level summed in the same launch.
//
// Replaces, in pclean_tpu/engine/propose.py, the enumerable branch of
// BlockTracer.score_choice (propose.py:454-519) from its enum logits to
// the logsumexp, for one dataset row (the one-row loops' B = 1 step),
// together with the sum of its children: score_plan's running sum over
// the choice's rest (:383-387) with the copy-mode and observed terms
// (:424-442, :471-499), which XLA fuses into the same lax.scan body. For
// each of the R rows of the enclosing enumeration axes and each of the
// choice's V options:
//   logit[r, v] = state[r] == 1 ? (v == obs[r] ? obs_ld[r] : NEG_INF)
//                               : enum[r, v]
//   rec[r, v]   = logit[r, v] + child[r, v]
//   logz[r]     = logsumexp(rec[r]) with pclean_tpu.utils.logsumexp's
//                 NEG_INF rules,
// child the level's postfix sum program (csrc/level_eval.cuh, K20's own
// code) evaluated at (r, v) over the record's shape, broadcast where the
// level is. The state is a static code (a word: 0 where the choice has
// no observation) or a per-row int8 flag (0 unobserved, 1 observed, 2
// missing). enum, obs_ld, obs and the state come with their strides (0 on
// an axis they broadcast over) and are read in place.
//
// Bits: the child's value rounds step by step as K20 rounds it, and the
// record's entry is one __fadd_rn of it, as the eager logits + children:
// the record is bit-equal to the plain version's (K20's sum, then the
// add), logZ agrees to float rounding (K1's rule).
//
// Bound on the H100 (3.35 TB/s): bytes. The enum logits, the level's
// references (each element once) and its gathers' distinct matrix
// entries read once, the observation, its log-density and the state once
// a row, the record and logZ written once: a few KB at one row, so the
// launch is a latency chain: one launch where the parent had two.
//
// Design: the plan (ops.choice_score_words: K13's head words, then the
// level's words in ops.level_plan's layout over the record's shape) is
// passed by value in the smallest of three parameter blocks that holds
// it, so the launch needs no table in device memory and is captured in
// the row graph as one node. Geometry (ops.choice_score_plan,
// ops.score_spread) follows the level's cost: an option's level is a
// chain of dependent loads through the program's walk, which a thread
// taking several options runs one after another, so at one row each
// option gets a thread of its own, in a block of up to 1,024 or a
// cluster of up to 8 such blocks a row past 1,024 options (the threads
// looping past 8,192); over more rows a light level (no gather, a few
// operands) keeps K1's plan, a warp a row for V <= 512 and a block a row
// above, each thread taking options t, t + T, .... Each thread folds its
// entries into a running (max, sum) pair; warp shuffles and shared memory
// merge a block's pairs, distributed shared memory a cluster's, and
// thread 0 of the row writes logZ (csrc/score_rows.cuh).

#include "level_eval.cuh"
#include "score_rows.cuh"

#define K13_HEAD 64
#define K13_TIER0 256
#define K13_TIER1 1024
#define K13_WORDS (K13_HEAD + K20_WORDS)

namespace {

using namespace score_rows;

// Word indices of the head (ops.choice_score_words): the pointers, the
// observation's dtype code, the static code, V, the row axes, the outputs,
// R, the geometry (path, threads a row, cluster), the instantiation, the
// enum's option stride, then the row axes' sizes and each operand's
// strides over them; the level's words start at K13_HEAD.
enum { hEn = 0, hLd, hObs, hObsDt, hState, hCode, hV, hNd, hRec, hLogz,
       hR, hPath, hTpr, hCluster, hKernel, hEs, hSizes = 16,
       hEnSt = hSizes + kMaxDims, hLdSt = hEnSt + kMaxDims,
       hObsSt = hLdSt + kMaxDims, hStSt = hObsSt + kMaxDims };

template <int W>
struct K13Plan {
  int64_t w[W];
};

template <int W, int D, bool NARROW>
__global__ void __launch_bounds__(kMaxThreads)
    choice_score_kernel(const __grid_constant__ K13Plan<W> p) {
  const int64_t* h = p.w;
  const int64_t* lv = p.w + K13_HEAD;
  const int64_t R = h[hR];
  const int V = (int)h[hV];
  const Row x = row_of((int)h[hPath], (int)h[hTpr]);
  const int64_t r = x.r;
  const bool in = r < R;
  float m = PCLEAN_NEG_INF, s = 0.0f;
  if (in) {
    const int nd = (int)h[hNd];
    const int8_t* state = reinterpret_cast<const int8_t*>(h[hState]);
    const int code =
        state ? (int)state[offset(nd, h + hSizes, h + hStSt, r)]
              : (int)h[hCode];
    const bool seen = h[hObs] != 0 && code == 1;
    const int64_t ov =
        seen ? load_i64(reinterpret_cast<const void*>(h[hObs]),
                        (int)h[hObsDt], offset(nd, h + hSizes, h + hObsSt, r))
             : 0;
    const float ld =
        seen ? reinterpret_cast<const float*>(
                   h[hLd])[offset(nd, h + hSizes, h + hLdSt, r)]
             : 0.0f;
    const float* e = reinterpret_cast<const float*>(h[hEn]) +
                     offset(nd, h + hSizes, h + hEnSt, r);
    const int64_t es = h[hEs];
    float* out = reinterpret_cast<float*>(h[hRec]) + r * (int64_t)V;
    for (int v = x.t; v < V; v += x.T) {
      const float lg = seen ? (v == ov ? ld : PCLEAN_NEG_INF)
                            : e[(int64_t)v * es];
      const float y = __fadd_rn(lg, level_eval::at<D, NARROW>(
                                        lv, r * (int64_t)V + v));
      out[v] = y;
      add(m, s, y);
    }
  }
  row_logz(m, s, x, in, reinterpret_cast<float*>(h[hLogz]));
}

template <int W, int D, bool NARROW>
int launch(const int64_t* words, int n_words, int threads, int cluster,
           int64_t grid_x, int64_t grid_y, cudaStream_t st) {
  K13Plan<W> p;
  for (int i = 0; i < W; ++i) p.w[i] = i < n_words ? words[i] : 0;
  return launch_rows(choice_score_kernel<W, D, NARROW>, p, threads,
                     cluster, grid_x, grid_y, st);
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

// words: the plan (ops.choice_score_words: the head, then the level's
// words over [R, V]); the launch's threads a block and grid (the plan's
// path: warp, threads = 32 rows, grid (ceil(R / rows), 1); block, grid
// (R, 1); slots, grid (cluster, R) in clusters of `cluster` blocks).
// Returns cudaErrorInvalidValue for a plan it does not take (the head's
// counts and geometry, or the level's words: level_eval::check, its
// element count R V and a depth its instantiation holds), else the
// launch's error or cudaGetLastError() after it.
extern "C" int pclean_choice_score(const int64_t* words, int n_words,
                                   int threads, int rows, int64_t grid_x,
                                   int64_t grid_y, void* stream) {
  if (n_words < K13_HEAD + K20_HEAD || n_words > K13_WORDS)
    return (int)cudaErrorInvalidValue;
  const int64_t* h = words;
  const int64_t R = h[hR], V = h[hV], nd = h[hNd], kernel = h[hKernel];
  const int64_t cluster = h[hCluster];
  if (V < 1 || R < 0 || nd < 0 || nd > kMaxDims || kernel < 0 ||
      kernel > 3 || h[hEn] == 0 || h[hRec] == 0 || h[hLogz] == 0 ||
      (h[hObs] != 0 && h[hLd] == 0) ||
      !geometry_ok(h[hPath], h[hTpr], cluster, threads, rows, grid_x,
                   grid_y, R))
    return (int)cudaErrorInvalidValue;
  static const int depth[4] = {2, 4, 8, K20_MAX_STACK};
  const int64_t* lv = words + K13_HEAD;
  const int rc = level_eval::check(lv, n_words - K13_HEAD, 1,
                                   depth[kernel], kernel < 3, false);
  if (rc != (int)cudaSuccess) return rc;
  if (lv[level_eval::kN] != R * V) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (n_words <= K13_TIER0)
    return launch_tier<K13_TIER0>(words, n_words, (int)kernel, threads,
                                  (int)cluster, grid_x, grid_y, st);
  if (n_words <= K13_TIER1)
    return launch_tier<K13_TIER1>(words, n_words, (int)kernel, threads,
                                  (int)cluster, grid_x, grid_y, st);
  return launch_tier<K13_WORDS>(words, n_words, (int)kernel, threads,
                                (int)cluster, grid_x, grid_y, st);
}
