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
// refcount and alive reads need its t: the hospital Record's six nodes
// three deep need the slot, three levels of fk reads and one round of
// refcount and alive reads, five round trips to L2.
//
// Design: two warps, one launch a row, the plan passed by value (no device
// table, no copy before the launch) in the smaller of two parameter
// blocks that holds it (ops.K10_TIERS; a block's size costs a launch
// nothing, what is read of it does: PERF.md section 3). A warp issues in
// order and stalls at the first instruction that needs a load still in
// flight, so each thread sends out every load it can before it uses one:
// the slot first, its words of the plan and the counters while the slot
// is in flight, alive[slot] beside the first level's fk reads, and no
// value compared before it is needed. Warp 0 walks the fk tree a lane a
// node (two nodes a lane past 32), in three phases:
//   A. one level of the tree at a time, each node reads its fk value from
//      its parent's t (shared memory, __syncwarp between levels); then
//      every node reads its refcount and alive at once;
//   B. the flips in rounds the plan assigns (a node after its parent and
//      after the class's earlier nodes in DFS order): each node takes dd
//      from its parent's flip and its refcount and alive from the loads, or
//      from the latest earlier node of its class that wrote the same index
//      (the plan links a class's nodes), so _fk_delta's order holds where
//      two paths reach one class, in integers and bit for bit;
//   C. each index's last writer stores its refcount and alive, and each
//      counter's owner lane adds the sum of its nodes' dd and flips to
//      `total` and `nrows`, loaded at the start: one store a counter.
// The propagated chains (or hop entries) run on warp 1 beside it: they
// read only arena columns and write only prop leaves, which the tree never
// touches. The plan puts every entry of one (target class, vertex) on one
// lane, in spec order, so entries that share a target apply in order and
// no two lanes write one address; each entry issues the loads that do not
// need its walk (state, codes, its first hop; the hop histograms, the old
// fk) together, and a hop entry walks its old and new targets side by
// side and reads both targets' count and code at once. The latent -1 call
// saves the row's root fk values (its old fks) for the +1 call's hop
// entries. The slot is a device scalar, so the loop around the launch
// never reads it back.

#include <cuda_runtime.h>
#include <string.h>

#include "row_words.cuh"

// The plan's words (ops.row_delta_plan): a header (with each chain lane's
// first entry, a byte a lane), NODES node records, NODES counter records,
// then the chains. A column's length and dtype share one word (length <<
// 4 | dtype).
#define K10_HEAD 14
#define K10_LANES 10
#define K10_NODE 6
#define K10_COUNTER 4
#define K10_PROP(HOPS) (10 + 2 * (HOPS))
#define K10_WORDS(NODES, HOPS, PROPS) \
  (K10_HEAD + (K10_NODE + K10_COUNTER) * (NODES) + K10_PROP(HOPS) * (PROPS))

namespace {

template <int NODES, int HOPS, int PROPS>
struct K10Plan {
  int64_t w[K10_WORDS(NODES, HOPS, PROPS)];
};

__device__ __forceinline__ int64_t col_len(int64_t lendt) {
  return lendt >> 4;
}

__device__ __forceinline__ int64_t col_dt(int64_t lendt) {
  return lendt & 15;
}

// p[clamp(i)] of a column (pointer, length << 4 | dtype).
__device__ __forceinline__ int64_t ld_col(int64_t p, int64_t lendt,
                                          int64_t i) {
  return pclean_ld_i(p, col_dt(lendt), pclean_clamp(i, col_len(lendt)));
}

// A node's packed word: depth, round, parent + 1, root + 1, the class's
// previous and next node + 1, a byte each.
__device__ __forceinline__ int nd_field(int64_t packed, int k) {
  return (int)((packed >> (8 * k)) & 255);
}

// Warp 0: the fk tree, a lane a node (phases A-C above).
template <int NODES>
__device__ __forceinline__ void tree(const int64_t* w, int lane,
                                     const int64_t* slot, int sign,
                                     int64_t* save_fk) {
  constexpr int NPL = (NODES + 31) / 32;   // nodes (and counters) a lane
  __shared__ int64_t sh_t[NODES], sh_pk[NODES];
  __shared__ int32_t sh_rc[NODES];
  __shared__ int8_t sh_al[NODES], sh_flip[NODES], sh_dd[NODES];
  // (every load out before anything waits on one: the design note above)
  const int64_t s = *slot;
  const int n_nodes = (int)w[1], n_cnt = (int)w[6];
  const int depth = (int)w[8], rounds = (int)w[9];
  const int64_t* nodes = w + K10_HEAD;
  const int64_t* cnts = nodes + K10_NODE * NODES;
  int64_t fk[NPL], fkc[NPL], rcp[NPL], alp[NPL], cap[NPL], pk[NPL];
  int64_t ctp[NPL], cnp[NPL], cdt[NPL], cmask[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k;
    pk[k] = 0;   // (depth 0 and round 0: no level or round takes it)
    if (i < n_nodes) {
      const int64_t* nd = nodes + K10_NODE * i;
      fk[k] = nd[0], fkc[k] = nd[1], rcp[k] = nd[2], alp[k] = nd[3];
      cap[k] = nd[4], pk[k] = nd[5];
    }
    if (lane + 32 * k < n_cnt) {
      const int64_t* q = cnts + K10_COUNTER * (lane + 32 * k);
      ctp[k] = q[0], cnp[k] = q[1], cdt[k] = q[2], cmask[k] = q[3];
    }
  }
  int64_t tot[NPL], nr[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k)
    if (lane + 32 * k < n_cnt) {
      tot[k] = pclean_ld_i(ctp[k], cdt[k] & 15, 0);
      nr[k] = pclean_ld_i(cnp[k], (cdt[k] >> 4) & 15, 0);
    }
  const uint8_t alive_s =
      reinterpret_cast<const uint8_t*>(w[4])[pclean_clamp(s, w[5] >> 4)];
#pragma unroll
  for (int k = 0; k < NPL; ++k)   // (read after the levels' __syncwarp)
    if (lane + 32 * k < n_nodes) sh_pk[lane + 32 * k] = pk[k];
  // A: the fk values level by level, then every node's refcount and
  // alive
  int64_t t[NPL];
  int32_t rc0[NPL];
  int8_t al0[NPL];
  for (int level = 1; level <= depth; ++level) {
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      if (nd_field(pk[k], 0) != level) continue;
      const int i = lane + 32 * k;
      const int parent = nd_field(pk[k], 2) - 1, root = nd_field(pk[k], 3);
      const int64_t ti = ld_col(fk[k], fkc[k], parent < 0 ? s : sh_t[parent]);
      t[k] = ti;
      sh_t[i] = ti;
      if (root > 0 && save_fk != nullptr) save_fk[root - 1] = ti;
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (lane + 32 * k >= n_nodes) continue;
    const int64_t tc = pclean_clamp(t[k], cap[k]);
    rc0[k] = reinterpret_cast<const int32_t*>(rcp[k])[tc];
    al0[k] = reinterpret_cast<const uint8_t*>(alp[k])[tc] != 0;
  }
  // B: the flips, in the plan's rounds
  const bool m = s >= 0 && s < w[3] && alive_s != 0;
  const int d0 = sign * (int)m;
  for (int r = 1; r <= rounds; ++r) {
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      if (nd_field(pk[k], 1) != r) continue;
      const int i = lane + 32 * k;
      const int parent = nd_field(pk[k], 2) - 1;
      const bool inb = t[k] >= 0 && t[k] < cap[k];
      const int64_t tc = pclean_clamp(t[k], cap[k]);
      const int dd = inb ? (parent < 0 ? d0 : sh_flip[parent]) : 0;
      int32_t rc = rc0[k];
      int al = al0[k];
      for (int j = nd_field(pk[k], 4) - 1; j >= 0;
           j = nd_field(sh_pk[j], 4) - 1)
        if (sh_t[j] == tc) {   // (then node j was in range and wrote)
          rc = sh_rc[j];
          al = sh_al[j];
          break;
        }
      rc += dd;
      const int now = rc > 0;
      sh_rc[i] = rc;
      sh_al[i] = (int8_t)(inb ? now : al);
      sh_flip[i] = (int8_t)(now - al);
      sh_dd[i] = (int8_t)dd;
    }
    __syncwarp();
  }
  // C: each index's last writer stores it; each counter once
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int i = lane + 32 * k;
    if (i >= n_nodes || t[k] < 0 || t[k] >= cap[k]) continue;
    bool last = true;
    for (int j = nd_field(pk[k], 5) - 1; j >= 0;
         j = nd_field(sh_pk[j], 5) - 1)
      if (sh_t[j] == t[k]) {
        last = false;
        break;
      }
    if (last) {
      reinterpret_cast<int32_t*>(rcp[k])[t[k]] = sh_rc[i];
      reinterpret_cast<uint8_t*>(alp[k])[t[k]] = (uint8_t)sh_al[i];
    }
  }
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (lane + 32 * k >= n_cnt) continue;
    uint64_t mask = (uint64_t)cmask[k];
    int64_t sdd = 0, sfl = 0;
    while (mask) {
      const int i = __ffsll((long long)mask) - 1;
      mask &= mask - 1;
      sdd += sh_dd[i];
      sfl += sh_flip[i];
    }
    pclean_st_i(ctp[k], cdt[k] & 15, 0, tot[k] + sdd);
    pclean_st_i(cnp[k], (cdt[k] >> 4) & 15, 0, nr[k] + sfl);
  }
}

// Warp 1: the propagated chains (obs mode) or hop entries (hop mode), a
// lane a target, its entries linked in spec order from the header's
// table.
template <int NODES, int HOPS>
__device__ __forceinline__ void chains(const int64_t* w, int lane,
                                       const int64_t* slot, int sign,
                                       const int64_t* old_fk) {
  const int64_t* props = w + K10_HEAD + (K10_NODE + K10_COUNTER) * NODES;
  const int64_t s = *slot;   // (as the tree: loads out before any wait)
  int j = (int)((w[K10_LANES + lane / 8] >> (8 * (lane % 8))) & 255) - 1;
  if (j < 0) return;
  const int mode = (int)w[0];
  const uint8_t alive_s =
      reinterpret_cast<const uint8_t*>(w[4])[pclean_clamp(s, w[5] >> 4)];
  while (j >= 0) {
    // [code, cnt, cap_t, dtypes | lane | root | hops | next, v1, v1 col,
    //  v2, v2 col, fk, fk col, the hops (pointer, col)]
    const int64_t* pr = props + K10_PROP(HOPS) * j;
    const int64_t code = pr[0], cnt = pr[1], cap_t = pr[2], pk = pr[3];
    const int64_t v1 = pr[4], v1c = pr[5], v2 = pr[6], v2c = pr[7];
    const int64_t fk = pr[8], fkc = pr[9], h0 = pr[10], h0c = pr[11];
    const int64_t code_dt = pk & 15, cnt_dt = (pk >> 4) & 15;
    const int nh = (int)((pk >> 24) & 255);
    j = (int)((pk >> 32) & 255) - 1;
    if (mode == 0) {
      // state, codes and the first hop, together
      const int64_t cv = ld_col(v1, v1c, s);
      const int64_t state = ld_col(v2, v2c, s);
      int64_t t = nh > 0 ? ld_col(h0, h0c, s) : s;
      for (int h = 1; h < nh; ++h)
        t = ld_col(pr[10 + 2 * h], pr[11 + 2 * h], t);
      const bool sm = s >= 0 && s < w[3] && alive_s != 0 && state == 1;
      if (t < 0 || t >= cap_t) continue;
      const int64_t c0 = pclean_ld_i(cnt, cnt_dt, t);
      const int64_t cur = pclean_ld_i(code, code_dt, t);
      const int64_t c = c0 + sign * (int64_t)sm;
      pclean_st_i(cnt, cnt_dt, t, c);
      if (sign > 0) {
        const int64_t v = sm ? cv : 0;
        pclean_st_i(code, code_dt, t, v > cur ? v : cur);
      } else if (c <= 0) {
        pclean_st_i(code, code_dt, t, 0);
      }
    } else {
      // the histograms, the old fk and the new one, together
      const int64_t g = ld_col(v1, v1c, s);
      const int64_t gc = ld_col(v2, v2c, s);
      int64_t of = old_fk[(pk >> 16) & 255];
      int64_t nf = ld_col(fk, fkc, s);
      for (int h = 0; h < nh; ++h) {
        of = ld_col(pr[10 + 2 * h], pr[11 + 2 * h], of);
        nf = ld_col(pr[10 + 2 * h], pr[11 + 2 * h], nf);
      }
      const bool oin = of >= 0 && of < cap_t, nin = nf >= 0 && nf < cap_t;
      const int64_t oc = pclean_clamp(of, cap_t);
      const int64_t nc = pclean_clamp(nf, cap_t);
      const int64_t c_of = pclean_ld_i(cnt, cnt_dt, oc);
      const int64_t k_of = pclean_ld_i(code, code_dt, oc);
      int64_t c_nf = pclean_ld_i(cnt, cnt_dt, nc);
      int64_t k_nf = pclean_ld_i(code, code_dt, nc);
      if (oin) {
        const int64_t c = c_of - g;
        pclean_st_i(cnt, cnt_dt, of, c);
        if (c <= 0) pclean_st_i(code, code_dt, of, 0);
        if (nf == of) {   // the new target's reads see the old's writes
          c_nf = c;
          k_nf = c <= 0 ? 0 : k_of;
        }
      }
      if (nin) {
        pclean_st_i(cnt, cnt_dt, nf, c_nf + g);
        const int64_t v = g > 0 ? gc : 0;
        pclean_st_i(code, code_dt, nf, v > k_nf ? v : k_nf);
      }
    }
  }
}

template <int NODES, int HOPS, int PROPS>
__global__ void __launch_bounds__(64) row_delta_kernel(
    const __grid_constant__ K10Plan<NODES, HOPS, PROPS> plan,
    const int64_t* __restrict__ slot, int sign,
    int64_t* __restrict__ save_fk, const int64_t* __restrict__ old_fk) {
  if (threadIdx.x < 32)
    tree<NODES>(plan.w, threadIdx.x, slot, sign, save_fk);
  else
    chains<NODES, HOPS>(plan.w, threadIdx.x - 32, slot, sign, old_fk);
}

template <int NODES, int HOPS, int PROPS>
int launch(const int64_t* words, int n_words, const int64_t* slot, int sign,
           int64_t* save_fk, const int64_t* old_fk, cudaStream_t stream) {
  constexpr int W = K10_WORDS(NODES, HOPS, PROPS);
  if (n_words > W ||
      n_words < K10_HEAD + (K10_NODE + K10_COUNTER) * NODES ||
      words[1] > NODES || words[2] > PROPS || words[6] > NODES ||
      words[8] > NODES || words[9] > NODES)
    return (int)cudaErrorInvalidValue;
  // every link of a node points inside the plan, in DFS order
  for (int64_t i = 0; i < words[1]; ++i) {
    const int64_t pk = words[K10_HEAD + K10_NODE * i + 5];
    const int64_t depth = pk & 255, round = (pk >> 8) & 255;
    const int64_t parent = ((pk >> 16) & 255) - 1;
    const int64_t prev = ((pk >> 32) & 255) - 1;
    const int64_t next = ((pk >> 40) & 255) - 1;
    if (depth < 1 || depth > words[8] || round < 1 || round > words[9] ||
        parent >= i || prev >= i || (next >= 0 && (next <= i ||
                                                   next >= words[1])))
      return (int)cudaErrorInvalidValue;
  }
  const int64_t* cnts = words + K10_HEAD + K10_NODE * NODES;
  for (int64_t c = 0; c < words[6]; ++c)
    if (words[1] < 64 &&
        ((uint64_t)cnts[K10_COUNTER * c + 3] >> words[1]) != 0)
      return (int)cudaErrorInvalidValue;
  const int64_t* props = cnts + K10_COUNTER * NODES;
  for (int64_t j = 0; j < words[2]; ++j) {
    const int64_t pk = props[K10_PROP(HOPS) * j + 3];
    const int64_t next = ((pk >> 32) & 255) - 1;
    if (((pk >> 24) & 255) > HOPS || (next >= 0 && (next <= j ||
                                                    next >= words[2])))
      return (int)cudaErrorInvalidValue;
  }
  for (int lane = 0; lane < 32; ++lane)
    if (((words[K10_LANES + lane / 8] >> (8 * (lane % 8))) & 255) >
        (uint64_t)words[2])
      return (int)cudaErrorInvalidValue;
  K10Plan<NODES, HOPS, PROPS> plan;
  memcpy(plan.w, words, sizeof(int64_t) * n_words);
  row_delta_kernel<NODES, HOPS, PROPS><<<1, 64, 0, stream>>>(
      plan, slot, sign, save_fk, old_fk);
  return (int)cudaGetLastError();
}

}  // namespace

// words: the plan (ops.row_delta_plan's words with this call's pointers,
// at most its tier's K10_WORDS; word 7 the tier: 0 (24 nodes, 6 hops, 32
// chains) or 1 (64, 16, 48)); slot: one int64 on the card; sign +1 or -1;
// save_fk: int64 [roots] written with the row's root fk values, or null;
// old_fk: int64 [roots] read by hop mode, else null. One block of 64 threads. Returns cudaErrorInvalidValue for a plan
// it does not take, else cudaGetLastError() after the launch.
extern "C" int pclean_row_delta(const int64_t* words, int n_words,
                                const int64_t* slot, int sign,
                                int64_t* save_fk, const int64_t* old_fk,
                                void* stream) {
  if (n_words < K10_HEAD || slot == nullptr || (sign != 1 && sign != -1))
    return (int)cudaErrorInvalidValue;
  const int64_t mode = words[0], n_nodes = words[1], n_props = words[2];
  if (mode < 0 || mode > 2 || n_nodes < 0 || n_props < 0 || words[6] < 0 ||
      words[8] < 0 || words[9] < 0 ||
      (mode == 2 && (old_fk == nullptr || sign != 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (words[7]) {
    case 0:
      return launch<24, 6, 32>(words, n_words, slot, sign, save_fk, old_fk,
                               st);
    case 1:
      return launch<64, 16, 48>(words, n_words, slot, sign, save_fk, old_fk,
                                st);
  }
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

// What a kernel's parameter block costs a launch
// (kernel_bench.param_block_ms): a __grid_constant__ block of BYTES bytes
// whose word 8 k holds 8 (k + 1) (one word a 64-byte line), read by one
// warp in one of four ways and summed into out: mode 0 lane 0 reads word
// 0 (what the block's size costs); mode 1 lane 0 reads n lines' first
// words, independent of each other; mode 2 lane l < n reads line l's
// (one instruction, n addresses); mode 3 lane 0 follows n lines, each
// read's address the word the one before read (n dependent reads).
namespace {
template <int BYTES>
struct ProbeBlock {
  int64_t w[BYTES / 8];
};

template <int BYTES>
__global__ void param_probe_kernel(const __grid_constant__ ProbeBlock<BYTES> p,
                                   int mode, int n,
                                   int64_t* __restrict__ out) {
  const int lane = threadIdx.x;
  int64_t v = 0;
  if (mode == 0) {
    if (lane == 0) v = p.w[0];
  } else if (mode == 1) {
    if (lane == 0)
      for (int k = 0; k < n; ++k) v += p.w[8 * k];
  } else if (mode == 2) {
    if (lane < n) v = p.w[8 * lane];
  } else if (lane == 0) {
    int64_t i = 0;
    for (int k = 0; k < n; ++k) i = p.w[i];
    v = i;
  }
  if (lane < n || lane == 0) out[lane] = v;
}

template <int BYTES>
int probe(int mode, int n, int64_t* out, cudaStream_t stream) {
  ProbeBlock<BYTES> p;
  memset(p.w, 0, sizeof(p.w));
  for (int k = 0; 8 * k < BYTES / 8; ++k)
    p.w[8 * k] = 8 * (k + 1) < BYTES / 8 ? 8 * (k + 1) : 0;
  param_probe_kernel<BYTES><<<1, 32, 0, stream>>>(p, mode, n, out);
  return (int)cudaGetLastError();
}
}  // namespace

// out: int64 [32] on the card; n <= 32 lines, within the block.
extern "C" int pclean_param_probe(int bytes, int mode, int n, int64_t* out,
                                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (out == nullptr || mode < 0 || mode > 3 || n < 0 || n > 32 ||
      (mode > 0 && 64 * n > bytes))
    return (int)cudaErrorInvalidValue;
  switch (bytes) {
    case 8: return probe<8>(mode, n, out, st);
    case 64: return probe<64>(mode, n, out, st);
    case 512: return probe<512>(mode, n, out, st);
    case 1024: return probe<1024>(mode, n, out, st);
    case 2048: return probe<2048>(mode, n, out, st);
    case 4096: return probe<4096>(mode, n, out, st);
    case 4128: return probe<4128>(mode, n, out, st);
    case 8192: return probe<8192>(mode, n, out, st);
    case 11840: return probe<11840>(mode, n, out, st);
    case 32000: return probe<32000>(mode, n, out, st);
  }
  return (int)cudaErrorInvalidValue;
}
