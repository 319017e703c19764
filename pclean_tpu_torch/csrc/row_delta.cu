// K10 row_delta: the one-row relational delta, in place on the carried
// relational state.
//
// Replaces the one-row (dense=False) forms of pclean_tpu/engine/refresh.py
// row_delta (refresh.py:209-280) with _fk_delta (74-124), latent_row_delta
// (127-146) and hop_move (177-206), which XLA fuses into the scan body of
// every sequential loop (scan_init, scan_sweep_class, the replays). For one
// row `slot` of the swept class and sign = +1 or -1 (ops.row_delta):
//   * m = alive[slot] (the arena's for an observed class, the relational
//     state's for a latent one), false where slot is out of range;
//   * the fk tree: the recursion of _fk_delta, flattened by the plan in its
//     DFS order. Node i reads t_i = fk_i[clamp(src)] (src = slot at a root,
//     the parent's t below), and with dd = (sign m at a root, the parent's
//     flip below) where t_i lies in [0, cap), else 0: refcount[t] += dd,
//     was = alive[clamp t], now = refcount[clamp t] > 0, alive[t] = now,
//     total += dd, nrows += now - was, flip_i = now - was;
//   * obs mode: each propagated-observation chain of the swept class
//     (refresh.propagated_obs_specs): sm = m & state[slot] == 1, the
//     target t = the chain's fk columns followed from slot; where t is in
//     range, cnt[t] += sign sm and code[t] = max(code[t], sm ? codes[slot]
//     : 0) on +1, or code[t] = cnt[t] > 0 ? code[t] : 0 on -1;
//   * hop mode (latent, after the row's fk rewrite, sign +1): each hop
//     histogram entry moves g = gcnt[slot] referrers from the old chain
//     target (the saved old fk value, followed down the suffix) to the new
//     one: cnt[of] -= g, code[of] = cnt[of] > 0 ? code[of] : 0, cnt[nf] +=
//     g, code[nf] = max(code[nf], g > 0 ? gcode[slot] : 0), each where its
//     target is in range.
// Every index is clamped as take() clamps it and every write dropped out of
// range as mode="drop" drops it, so the clamped reads still feed was / now
// where t is out of range.
//
// Bound on the H100: neither bytes (a few hundred) nor operations; the
// chain of dependent loads. A node's fk read needs its parent's t, its
// refcount read-modify-write and alive read need t, its children need its
// flip: the hospital Record's six nodes three deep are about eighteen
// dependent global accesses in one thread, each a round trip to L2.
//
// Design: two warps, one launch a row, the plan passed by value (no device
// table, no copy before the launch) in the smaller of two parameter blocks
// that holds it. Warp 0's lane 0 walks the fk tree in
// DFS order, so a class reached by two paths sees the first subtree's
// flips before the second subtree's bump. The propagated chains (or hop
// entries) run on warp 1 beside it, a warp of its own so that it does not
// wait for the tree: they read only arena columns and write only prop
// leaves, which the tree never touches. The plan puts every entry of one
// (target class, vertex) on one lane, in spec order, and lists each lane's
// entries together, so each lane walks its own list while the others walk
// theirs: entries that share a target apply in order and no two lanes
// write one address. The latent -1 call saves the row's root fk values
// (its old fks) for the +1 call's hop entries. The slot is a device
// scalar, so the loop around the launch never reads it back.

#include <cuda_runtime.h>

#include "row_words.cuh"

#define K10_HEAD (8 + 64)   // 8 words, then (start, count) for 32 lanes
#define K10_NODE 12
// The two parameter blocks (ops.K10_TIERS; word 7 of a plan names its
// tier): fk-tree nodes, hops a chain and chains. Tier 0 (24, 6, 32) holds
// every class of the repository's workloads in 11.8 KB; tier 1 (64, 16,
// 48) holds deeper and wider models in 31.7 KB.
#define K10_PROP(HOPS) (17 + 3 * (HOPS))
#define K10_WORDS(NODES, HOPS, PROPS) \
  (K10_HEAD + K10_NODE * (NODES) + K10_PROP(HOPS) * (PROPS))

namespace {

template <int NODES, int HOPS, int PROPS>
struct K10Plan {
  int64_t w[K10_WORDS(NODES, HOPS, PROPS)];
};

// One chain's target from its start t: its fk columns followed in turn.
__device__ __forceinline__ int64_t follow(const int64_t* pr, int64_t t) {
  const int64_t n = pr[16];
  for (int64_t h = 0; h < n; ++h) {
    const int64_t* hp = pr + 17 + 3 * h;
    t = pclean_ld_i(hp[0], hp[2], pclean_clamp(t, hp[1]));
  }
  return t;
}

template <int NODES, int HOPS, int PROPS>
__global__ void row_delta_kernel(
    const __grid_constant__ K10Plan<NODES, HOPS, PROPS> plan,
    const int64_t* __restrict__ slot, int sign,
    int64_t* __restrict__ save_fk, const int64_t* __restrict__ old_fk) {
  const int64_t* w = plan.w;
  const int64_t mode = w[0], n_nodes = w[1], n_props = w[2], cap0 = w[3];
  const int64_t s = *slot;
  const bool m = s >= 0 && s < cap0 &&
                 pclean_ld_i(w[4], w[6], pclean_clamp(s, w[5])) != 0;
  if (threadIdx.x == 0) {
    int64_t t[NODES];
    int flip[NODES];
    const int d0 = sign * (int)m;
    for (int64_t i = 0; i < n_nodes; ++i) {
      const int64_t* nd = w + K10_HEAD + K10_NODE * i;
      const int64_t parent = nd[3];
      const int64_t src = parent < 0 ? s : t[parent];
      const int64_t ti = pclean_ld_i(nd[0], nd[2], pclean_clamp(src, nd[1]));
      t[i] = ti;
      if (nd[4] >= 0 && save_fk != nullptr) save_fk[nd[4]] = ti;
      const int64_t cap = nd[7];
      const bool inb = ti >= 0 && ti < cap;
      const int dd = inb ? (parent < 0 ? d0 : flip[parent]) : 0;
      const int64_t tc = pclean_clamp(ti, cap);
      int32_t* rc = reinterpret_cast<int32_t*>(nd[5]);
      uint8_t* alive = reinterpret_cast<uint8_t*>(nd[6]);
      if (inb) rc[tc] += dd;
      const int was = alive[tc] != 0;
      const int now = rc[tc] > 0;
      if (inb) alive[tc] = (uint8_t)now;
      flip[i] = now - was;
      pclean_st_i(nd[8], nd[9], 0, pclean_ld_i(nd[8], nd[9], 0) + dd);
      pclean_st_i(nd[10], nd[11], 0,
                  pclean_ld_i(nd[10], nd[11], 0) + (now - was));
    }
    return;
  }
  if (threadIdx.x < 32 || n_props == 0) return;
  const int lane = threadIdx.x - 32;
  const int64_t first = w[8 + 2 * lane], count = w[9 + 2 * lane];
  for (int64_t j = first; j < first + count; ++j) {
    const int64_t* pr = w + K10_HEAD + K10_NODE * NODES + K10_PROP(HOPS) * j;
    const int64_t code = pr[1], code_dt = pr[2], cnt = pr[3], cnt_dt = pr[4];
    const int64_t cap_t = pr[5];
    if (mode == 0) {
      const bool sm =
          m && pclean_ld_i(pr[9], pr[11], pclean_clamp(s, pr[10])) == 1;
      const int64_t t = follow(pr, s);
      if (t < 0 || t >= cap_t) continue;
      const int64_t c = pclean_ld_i(cnt, cnt_dt, t) + sign * (int64_t)sm;
      pclean_st_i(cnt, cnt_dt, t, c);
      const int64_t cur = pclean_ld_i(code, code_dt, t);
      if (sign > 0) {
        const int64_t v =
            sm ? pclean_ld_i(pr[6], pr[8], pclean_clamp(s, pr[7])) : 0;
        pclean_st_i(code, code_dt, t, v > cur ? v : cur);
      } else if (c <= 0) {
        pclean_st_i(code, code_dt, t, 0);
      }
    } else {
      const int64_t g = pclean_ld_i(pr[6], pr[8], pclean_clamp(s, pr[7]));
      const int64_t gc = pclean_ld_i(pr[9], pr[11], pclean_clamp(s, pr[10]));
      const int64_t of = follow(pr, old_fk[pr[15]]);
      const int64_t nf =
          follow(pr, pclean_ld_i(pr[12], pr[14], pclean_clamp(s, pr[13])));
      if (of >= 0 && of < cap_t) {
        const int64_t c = pclean_ld_i(cnt, cnt_dt, of) - g;
        pclean_st_i(cnt, cnt_dt, of, c);
        if (c <= 0) pclean_st_i(code, code_dt, of, 0);
      }
      if (nf >= 0 && nf < cap_t) {
        pclean_st_i(cnt, cnt_dt, nf, pclean_ld_i(cnt, cnt_dt, nf) + g);
        const int64_t v = g > 0 ? gc : 0;
        const int64_t cur = pclean_ld_i(code, code_dt, nf);
        pclean_st_i(code, code_dt, nf, v > cur ? v : cur);
      }
    }
  }
}

template <int NODES, int HOPS, int PROPS>
int launch(const int64_t* words, int n_words, const int64_t* slot, int sign,
           int64_t* save_fk, const int64_t* old_fk, cudaStream_t stream) {
  constexpr int W = K10_WORDS(NODES, HOPS, PROPS);
  if (n_words > W || words[1] > NODES || words[2] > PROPS)
    return (int)cudaErrorInvalidValue;
  K10Plan<NODES, HOPS, PROPS> plan;
  for (int i = 0; i < W; ++i) plan.w[i] = i < n_words ? words[i] : 0;
  row_delta_kernel<NODES, HOPS, PROPS><<<1, 64, 0, stream>>>(
      plan, slot, sign, save_fk, old_fk);
  return (int)cudaGetLastError();
}

}  // namespace

// words: the plan (ops.row_delta_plan's words with this call's pointers,
// at most its tier's K10_WORDS; word 7 the tier, 0 or 1); slot: one int64
// on the card; sign +1 or -1; save_fk: int64 [roots] written with the
// row's root fk values, or null; old_fk: int64 [roots] read by hop mode,
// else null. One block of 64 threads. Returns cudaErrorInvalidValue for a
// plan it does not take, else cudaGetLastError() after the launch.
extern "C" int pclean_row_delta(const int64_t* words, int n_words,
                                const int64_t* slot, int sign,
                                int64_t* save_fk, const int64_t* old_fk,
                                void* stream) {
  if (n_words < K10_HEAD || slot == nullptr || (sign != 1 && sign != -1))
    return (int)cudaErrorInvalidValue;
  const int64_t mode = words[0], n_nodes = words[1], n_props = words[2];
  if (mode < 0 || mode > 2 || n_nodes < 0 || n_props < 0 ||
      (mode == 2 && (old_fk == nullptr || sign != 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (words[7] == 0)
    return launch<24, 6, 32>(words, n_words, slot, sign, save_fk, old_fk, st);
  if (words[7] == 1)
    return launch<64, 16, 48>(words, n_words, slot, sign, save_fk, old_fk,
                              st);
  return (int)cudaErrorInvalidValue;
}

// The yardstick of K10's dependent-load bound (kernel_bench.l2_latency_ms):
// one thread follows next[] n times from index 0, each load through L2
// (ld.global.cg) and dependent on the one before, and writes where it
// ends. Its device time over n, less its time at n = 1, is the latency of
// one dependent load that hits L2.
namespace {
__global__ void chase_kernel(const int32_t* __restrict__ next, int n,
                             int32_t* __restrict__ out) {
  int32_t i = 0;
  for (int k = 0; k < n; ++k) i = __ldcg(next + i);
  *out = i;
}
}  // namespace

extern "C" int pclean_chase_probe(const int32_t* next, int n, int32_t* out,
                                  void* stream) {
  if (n < 0 || next == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(next, n, out);
  return (int)cudaGetLastError();
}
