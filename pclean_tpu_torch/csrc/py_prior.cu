// K21 py_prior: a batched foreign key's Pitman-Yor prior and children,
// K1's two inputs, in one launch.
//
// Replaces, in pclean_tpu/engine/propose.py, BlockTracer.py_logprobs
// (propose.py:241-258) and the batched score_fk's compaction select and
// adds before its logsumexp (:521-566). For each of the R rows of the
// enclosing enumeration axes (batch coordinate b) and each of the K
// candidate positions k:
//   logden    = log(total[b] + s)
//   slot      = comp ? min(idx[k], cap - 1) : k
//   prior     = comp && k >= nc ? NEG_INF
//             : alive[b, slot] && refcount[b, slot] > 0
//               ? log(max(refcount[b, slot] - d, 1e-30)) - logden : NEG_INF
//   exist[r, k] = prior + children[r, k]
//   new[r]      = (log(d * nrows[b] + s) - logden) + new_children[r]
// with the leaves shared ([cap], row stride 0) or per row ([B, cap]),
// total and nrows one element or [B], s and d the class's Pitman-Yor
// strength and discount (device scalars, or constants in the plan). The
// children come with their strides (0 on an axis they broadcast over).
//
// Bits: one rounding an operation (__fadd_rn, __fsub_rn, __fmul_rn: no
// contraction into a fused multiply-add, which torch does not do), logf as
// torch.log on the card: both outputs bit-equal to the plain version's.
//
// Bound on the H100 (3.35 TB/s): bytes. The leaves' entries at the K
// candidates read once (5 bytes a slot, per row where they are per row),
// the children once (4 R K where they vary over the rows), idx once, and
// exist [R, K] and new [R] written once: at B = 4,096 rows of 11,264
// slots with per-row leaves, about 600 MB, ~0.18 ms.
//
// Design: two kernels, the plan's unit word choosing by the call's size
// (ops.py_prior_words). The row kernel, where four candidates a thread
// still give the card a block on each SM: a row a group of threads (a
// power of two up to the block's 256, enough for the row's units of four
// candidates; a block holds 256 / that many rows, so a long row takes a
// block and short rows share one), rows along blockIdx.x only. Each
// thread decomposes its row (its batch coordinate and child offsets)
// once, in 32-bit division, loads total[b], nrows[b], s, d and nc once and
// computes logden once, out of the candidate loop; the row's first thread
// writes its `new` entry last. Each thread walks the row a unit of four
// candidates at a time, the first unit's loads issued beside the row's
// terms'. Where the plan's vector route says the addresses allow (no
// compaction, and the leaves, children or exist 16-byte aligned along
// every row), refcount (16 bytes), alive (4), the children (16) and exist
// (16) move as vectors, and so does idx; elsewhere element by element,
// the leaves gathered at the compacted slots, and a row's last unit of
// fewer than four candidates element by element. The flat kernel, for
// smaller calls: a thread an output entry in 32-bit indices, so the call
// waits on one thread's chain of loads and logs (on an H100 at [16, 128]
// the row kernel took 0.0031 device ms, the flat one 0.0022, PERF.md).
// The plan is passed by value, so the launch can be captured in a CUDA
// graph.

#include <cuda_runtime.h>

#include "row_words.cuh"
#include "score_rows.cuh"

#define K21_WORDS 64
#define K21_THREADS 256
#define K21_MAX_DIMS 8

namespace {

struct K21Plan {
  int64_t w[K21_WORDS];
};

// Word indices of the plan (ops.py_prior_words).
enum {
  kRef = 0, kAlive, kRowStride, kCap, kTotal, kTotalDt, kTotalStride,
  kNrows, kNrowsDt, kNrowsStride, kS, kSBits, kD, kDBits, kIdx, kIdxDt,
  kNc, kNcDt, kCh, kNch, kExist, kNew, kR, kK, kNd, kSizes,
  kChStrides = kSizes + K21_MAX_DIMS, kChK = kChStrides + K21_MAX_DIMS,
  kNchStrides, kRoute = kNchStrides + K21_MAX_DIMS, kRowLog, kUnit
};

// The vector route's bits (ops.K21_LEAF_VEC and the three after it): which
// loads and stores move as 16-byte vectors
enum {
  kLeafVec = 1,    // refcount and alive at slot k (no compaction)
  kChVec = 2,      // the children, contiguous along k
  kExistVec = 4,   // exist's rows (K a multiple of 4)
  kIdxVec = 8      // idx (int32 or int64)
};

__device__ __forceinline__ float scalar(const int64_t* w, int ptr, int bits) {
  return w[ptr] ? *reinterpret_cast<const float*>(w[ptr])
                : __int_as_float((int)w[bits]);
}

// The row kernel's unit: four candidates' refcounts, alive bytes and
// children.
struct Unit {
  int32_t cnt[4];
  uint32_t al;
  float c[4];
};

// The loads of the unit at candidate k0 (m of its four candidates are
// real): vectors where the route says, else element by element.
__device__ __forceinline__ Unit load_unit(const int64_t* w, int route,
                                          int64_t k0, int m,
                                          const int32_t* ref,
                                          const uint8_t* alv, const float* ch,
                                          int64_t chk) {
  Unit x;
  int64_t slot[4];
  const int64_t idx = w[kIdx];
  if (idx) {
    const int64_t idt = w[kIdxDt], cap = w[kCap];
    if (m == 4 && (route & kIdxVec) && idt == PCLEAN_DT_I32) {
      const int4 v = *reinterpret_cast<const int4*>(
          reinterpret_cast<const int32_t*>(idx) + k0);
      slot[0] = v.x, slot[1] = v.y, slot[2] = v.z, slot[3] = v.w;
    } else if (m == 4 && (route & kIdxVec)) {
      const longlong2* q = reinterpret_cast<const longlong2*>(
          reinterpret_cast<const int64_t*>(idx) + k0);
      const longlong2 v0 = q[0], v1 = q[1];
      slot[0] = v0.x, slot[1] = v0.y, slot[2] = v1.x, slot[3] = v1.y;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        slot[i] = i < m ? pclean_ld_i(idx, idt, k0 + i) : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      slot[i] = slot[i] < cap - 1 ? slot[i] : cap - 1;
      slot[i] = slot[i] < 0 ? 0 : slot[i];  // take()'s clamp
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) slot[i] = k0 + i;
  }
  if (m == 4 && (route & kLeafVec)) {
    const int4 v = *reinterpret_cast<const int4*>(ref + k0);
    x.cnt[0] = v.x, x.cnt[1] = v.y, x.cnt[2] = v.z, x.cnt[3] = v.w;
    x.al = *reinterpret_cast<const uint32_t*>(alv + k0);
  } else {
    x.al = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x.cnt[i] = i < m ? ref[slot[i]] : 0;
      x.al |= i < m ? (uint32_t)alv[slot[i]] << (8 * i) : 0u;
    }
  }
  if (m == 4 && (route & kChVec)) {
    const float4 v = *reinterpret_cast<const float4*>(ch + k0);
    x.c[0] = v.x, x.c[1] = v.y, x.c[2] = v.z, x.c[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x.c[i] = i < m ? ch[(k0 + i) * chk] : 0.0f;
  }
  return x;
}

// Row r's batch coordinate b and its offsets into the children, in 32-bit
// division.
__device__ __forceinline__ void row_coords(const int64_t* w, uint32_t r,
                                           uint32_t& b, int64_t& och,
                                           int64_t& onch) {
  const int nd = (int)w[kNd];
  uint32_t rem = r;
  b = 0, och = 0, onch = 0;
#pragma unroll
  for (int d = K21_MAX_DIMS - 1; d >= 0; --d) {
    if (d < nd) {
      const uint32_t n = (uint32_t)w[kSizes + d];
      const uint32_t c = rem % n;
      rem /= n;
      och += (int64_t)c * w[kChStrides + d];
      onch += (int64_t)c * w[kNchStrides + d];
      if (d == 0) b = c;
    }
  }
}

// The row kernel (unit 4): a row a group of 2^kRowLog threads, four
// candidates a thread at a time. At most 64 registers, so that four blocks
// stay resident on an SM and keep enough loads in flight (at 78 registers
// [4,096, 11,264] with shared leaves took 0.1609 device ms, at 63 0.1448
// on an H100, PERF.md).
__global__ void __launch_bounds__(K21_THREADS, 4)
    py_prior_rows(const __grid_constant__ K21Plan p) {
  const int64_t* w = p.w;
  const int tl = (int)w[kRowLog];
  const uint32_t tpr = 1u << tl;
  const uint32_t t = threadIdx.x & (tpr - 1);
  const uint32_t r = blockIdx.x * (K21_THREADS >> tl) + (threadIdx.x >> tl);
  if (r >= (uint32_t)w[kR]) return;
  const int64_t K = w[kK];
  uint32_t b;
  int64_t och, onch;
  row_coords(w, r, b, och, onch);
  // every load the row's terms and the thread's first unit need goes out
  // before any value is used
  const float s = scalar(w, kS, kSBits), dv = scalar(w, kD, kDBits);
  const float total = (float)pclean_ld_f(w[kTotal], w[kTotalDt],
                                         (int64_t)b * w[kTotalStride]);
  float nv = 0.0f, nch = 0.0f;
  if (t == 0) {
    nv = (float)pclean_ld_f(w[kNrows], w[kNrowsDt],
                            (int64_t)b * w[kNrowsStride]);
    nch = reinterpret_cast<const float*>(w[kNch])[onch];
  }
  const int route = (int)w[kRoute];
  const int64_t at0 = (int64_t)b * w[kRowStride];
  const int32_t* ref = reinterpret_cast<const int32_t*>(w[kRef]) + at0;
  const uint8_t* alv = reinterpret_cast<const uint8_t*>(w[kAlive]) + at0;
  const float* ch = reinterpret_cast<const float*>(w[kCh]) + och;
  const int64_t chk = w[kChK];
  float* ex = reinterpret_cast<float*>(w[kExist]) + (int64_t)r * K;
  const int64_t nc = w[kIdx] ? pclean_ld_i(w[kNc], w[kNcDt], 0) : K;
  const int64_t units = (K + 3) >> 2;
  Unit x;
  if (t < units) {
    const int64_t k0 = (int64_t)t << 2;
    x = load_unit(w, route, k0, K - k0 < 4 ? (int)(K - k0) : 4, ref, alv, ch,
                  chk);
  }
  // the row's terms, once
  const float logden = logf(__fadd_rn(total, s));
  for (int64_t u = t; u < units; u += tpr) {
    const int64_t k0 = u << 2;
    const int m = K - k0 < 4 ? (int)(K - k0) : 4;   // candidates here
    if (u != t) x = load_unit(w, route, k0, m, ref, alv, ch, chk);
    // the prior and the children's sum, one rounding an operation; every
    // candidate's log taken, the dead ones' discarded, so no lane waits
    // on another's branch
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool live = k0 + i < nc && ((x.al >> (8 * i)) & 255) &&
                        x.cnt[i] > 0;
      const float lp = __fsub_rn(
          logf(fmaxf(__fsub_rn((float)x.cnt[i], dv), 1e-30f)), logden);
      e[i] = __fadd_rn(live ? lp : PCLEAN_NEG_INF, x.c[i]);
    }
    if (m == 4 && (route & kExistVec)) {
      *reinterpret_cast<float4*>(ex + k0) = make_float4(e[0], e[1], e[2],
                                                        e[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < m) ex[k0 + i] = e[i];
    }
  }
  if (t == 0) {
    const float fresh =
        __fsub_rn(logf(__fadd_rn(__fmul_rn(dv, nv), s)), logden);
    reinterpret_cast<float*>(w[kNew])[r] = __fadd_rn(fresh, nch);
  }
}

// The flat kernel (unit 1), for calls too small to fill the card four
// candidates a thread: a thread an output entry, the R x K exist entries
// first, then the R new entries, its indices in 32 bits (the plan keeps
// R (K + 1) below 2^31), so each thread's one chain of loads and logs is
// all a short call waits on.
__global__ void __launch_bounds__(K21_THREADS)
    py_prior_flat(const __grid_constant__ K21Plan p) {
  const int64_t* w = p.w;
  const uint32_t R = (uint32_t)w[kR], K = (uint32_t)w[kK];
  const uint32_t i = blockIdx.x * K21_THREADS + threadIdx.x;
  if (i >= R * K + R) return;
  const bool is_new = i >= R * K;
  const uint32_t r = is_new ? i - R * K : i / K;
  const uint32_t k = is_new ? 0 : i - r * K;
  uint32_t b;
  int64_t och, onch;
  row_coords(w, r, b, och, onch);
  const float s = scalar(w, kS, kSBits), dv = scalar(w, kD, kDBits);
  const float total = (float)pclean_ld_f(w[kTotal], w[kTotalDt],
                                         (int64_t)b * w[kTotalStride]);
  const float logden = logf(__fadd_rn(total, s));
  if (is_new) {
    const float nv = (float)pclean_ld_f(w[kNrows], w[kNrowsDt],
                                        (int64_t)b * w[kNrowsStride]);
    const float fresh =
        __fsub_rn(logf(__fadd_rn(__fmul_rn(dv, nv), s)), logden);
    reinterpret_cast<float*>(w[kNew])[r] = __fadd_rn(
        fresh, reinterpret_cast<const float*>(w[kNch])[onch]);
    return;
  }
  const int64_t cap = w[kCap];
  float prior = PCLEAN_NEG_INF;
  bool in = true;
  int64_t slot = k;
  if (w[kIdx]) {
    in = k < pclean_ld_i(w[kNc], w[kNcDt], 0);
    slot = pclean_ld_i(w[kIdx], w[kIdxDt], k);
    slot = slot < cap - 1 ? slot : cap - 1;
    slot = slot < 0 ? 0 : slot;  // take()'s clamp
  }
  if (in) {
    const int64_t at = (int64_t)b * w[kRowStride] + slot;
    const int32_t cnt = reinterpret_cast<const int32_t*>(w[kRef])[at];
    const bool live = reinterpret_cast<const uint8_t*>(w[kAlive])[at] &&
                      cnt > 0;
    if (live)
      prior = __fsub_rn(logf(fmaxf(__fsub_rn((float)cnt, dv), 1e-30f)),
                        logden);
  }
  reinterpret_cast<float*>(w[kExist])[(int64_t)r * K + k] = __fadd_rn(
      prior, reinterpret_cast<const float*>(w[kCh])[och + k * w[kChK]]);
}

}  // namespace

// words: the plan (ops.py_prior_words, K21_WORDS of them). Returns
// cudaErrorInvalidValue for a plan it does not take, else
// cudaGetLastError() after the launch.
extern "C" int pclean_py_prior(const int64_t* words, int n_words,
                               void* stream) {
  if (n_words != K21_WORDS) return (int)cudaErrorInvalidValue;
  K21Plan p;
  for (int i = 0; i < K21_WORDS; ++i) p.w[i] = words[i];
  const int64_t* w = p.w;
  if (w[kR] < 0 || w[kR] > 0x7fffffff || w[kK] < 1 || w[kCap] < 1 ||
      w[kNd] < 1 || w[kNd] > K21_MAX_DIMS || !w[kRef] || !w[kAlive] ||
      !w[kTotal] || !w[kNrows] || !w[kCh] || !w[kNch] || !w[kExist] ||
      !w[kNew] || (w[kIdx] && !w[kNc]) || (!w[kIdx] && w[kK] != w[kCap]) ||
      w[kRowLog] < 0 || w[kRowLog] > 8 || (w[kUnit] != 1 && w[kUnit] != 4) ||
      (w[kUnit] == 1 && w[kR] * (w[kK] + 1) > 0x7fffffff) ||
      (w[kIdx] && (w[kRoute] & kLeafVec)) ||
      ((w[kRoute] & kIdxVec) && (!w[kIdx] || (w[kIdxDt] != PCLEAN_DT_I32 &&
                                              w[kIdxDt] != PCLEAN_DT_I64))))
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < w[kNd]; ++d)
    if (w[kSizes + d] < 1 || w[kSizes + d] > 0xffffffffLL)
      return (int)cudaErrorInvalidValue;
  if (w[kR] == 0) return (int)cudaSuccess;
  if (w[kUnit] == 1) {
    const int64_t n = w[kR] * (w[kK] + 1);
    py_prior_flat<<<(unsigned)((n + K21_THREADS - 1) / K21_THREADS),
                    K21_THREADS, 0, (cudaStream_t)stream>>>(p);
  } else {
    const int64_t rows = K21_THREADS >> w[kRowLog];
    py_prior_rows<<<(unsigned)((w[kR] + rows - 1) / rows), K21_THREADS, 0,
                    (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
