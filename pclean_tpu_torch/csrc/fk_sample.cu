// K16 fk_sample: one foreign key's sample step for every row of a block
// proposal, in one launch.
//
// Replaces the body of pclean_tpu/engine/propose.py BlockTracer.sample_fk
// before its children (propose.py:1026-1065), with _inv_cdf_from_u
// (:1153-1172) and the record pick at the ancestor positions: for row b,
//   logits = rec[b, anc_0[b], .., anc_{d-1}[b], :]           (K + 1 entries)
//   chosen = the draw at u[b] (inv_cdf.cuh: K2's index), or, retained, the
//            compact position of the stored slot rv[b] (comp inv, or rv)
//            where alive & refcount > 0 there, else K (re-birth in rv)
//   has_free = not all(mask[b]); free = the first dead slot of mask[b]
//   no free slot: chosen = argmax(logits[:K]) and not new
//   c_exist = min(chosen, K - 1); c_exist_slot = min(comp idx[c_exist],
//            cap - 1) (or c_exist); slot = rv where retained and dead, else
//            free; final = is_new ? slot : c_exist_slot
//   mask_out[b] = mask[b], with mask_out[b, slot] set where is_new & gate.
// Every gather clamps its index as the JAX gathers do; the alive write
// drops a slot outside [0, cap).
//
// Bound on the H100 (3.35 TB/s): bytes. A drawn row's K + 1 logits, its
// mask row (cap bytes, read once; written once where the mask is copied
// into the tracer's own buffer) and a few words a row; at B = 4,096,
// K + 1 = 11,265, cap = 11,264, copying: 185 MB + 92 MB, ~83 us.
//
// Design: a row is worked by a warp, a block of 512 or a cluster of up
// to 8 blocks (ops.draw_plan's geometry for its K + 1 logits and its mask;
// the draw in that geometry, inv_cdf.cuh). The mask row is read as the
// 16-byte words of the output row's aligned grid (a scalar head and tail
// where b cap is not 16-byte aligned; byte loads where the input row sits
// at another 16-byte phase), thread t of the row's T taking words t, t + T,
// ...: each thread issues the loads of its first words (two a lane of a
// warp row, one a thread of a block) before the draw, so they overlap it,
// copies every word where the output buffer is
// not the input, and finds the first dead slot by a zero-byte test on each
// 4-byte lane of a word; the row's minimum is a shuffle, block or cluster
// reduction. The argmax of the existing logits runs, in the same geometry,
// only where the row has no free slot (a row-uniform branch). The row's
// first thread writes the six outputs; the thread that copied the word
// holding the born slot writes its alive byte, after its own copy of that
// word. The plan (ops.fk_sample's words: pointers, strides, dtypes, the
// geometry) is passed by value.

#include "inv_cdf.cuh"
#include "row_words.cuh"

namespace {

using namespace pclean_draw;

// Word indices of the plan (ops.fk_sample); from kAxes, each ancestor
// axis's stride, size, pointer and dtype (ops._rec_words).
enum {
  kB = 0, kK1, kCap, kTile, kGeom, kRec, kNd, kRecB, kU, kUStride, kRv,
  kRvDt, kRelAlive, kRelAliveS, kRelRc, kRelRcS, kCompIdx, kCompIdxDt,
  kCompIdxN, kCompInv, kCompInvDt, kCompInvN, kGate, kMaskIn, kMaskInS,
  kMaskOut, kInts, kFlags, kCluster, kAxes
};

#define K16_MAX_ANC 7
#define K16_WORDS (kAxes + 4 * K16_MAX_ANC)

struct K16Plan {
  int64_t w[K16_WORDS];
};

// A mask row as the 16-byte words of the output row's aligned grid.
struct MaskRow {
  const uint8_t* mi;
  uint8_t* mo;
  uintptr_t lo, hi, a0;  // the output row's bytes, its grid's start
  int64_t W;             // words of the grid
  int64_t shift;         // mi - mo in bytes
  bool aligned;          // the input at the output's 16-byte phase

  __device__ __forceinline__ MaskRow(const uint8_t* in, uint8_t* out,
                                     int64_t cap)
      : mi(in), mo(out) {
    lo = reinterpret_cast<uintptr_t>(out);
    hi = lo + cap;
    a0 = lo & ~(uintptr_t)15;
    W = (int64_t)((hi - a0 + 15) >> 4);
    shift = (int64_t)(reinterpret_cast<uintptr_t>(in) - lo);
    aligned = (shift & 15) == 0;
  }

  // Word w's input bytes, those outside the row set to 1 (alive).
  __device__ __forceinline__ uint4 load(int64_t w) const {
    const uintptr_t a = a0 + 16 * (uintptr_t)w;
    if (aligned && a >= lo && a + 16 <= hi)
      return *reinterpret_cast<const uint4*>(a + shift);
    uint32_t c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t v = (a + k >= lo && a + k < hi) ? mi[a + k - lo] : 1u;
      c[k >> 2] |= v << (8 * (k & 3));
    }
    return make_uint4(c[0], c[1], c[2], c[3]);
  }

  // Word w's in-row bytes into the output row.
  __device__ __forceinline__ void store(int64_t w, uint4 v) const {
    const uintptr_t a = a0 + 16 * (uintptr_t)w;
    if (a >= lo && a + 16 <= hi) {
      *reinterpret_cast<uint4*>(a) = v;
      return;
    }
    const uint32_t c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (a + k >= lo && a + k < hi)
        mo[a + k - lo] = (uint8_t)(c[k >> 2] >> (8 * (k & 3)));
  }

  // The row position of word w's first zero byte, else INT64_MAX: the
  // lowest set bit of (c - 0x01..) & ~c & 0x80.. marks the lowest zero
  // byte of c (a borrow only marks bytes above a zero one).
  __device__ __forceinline__ int64_t first_dead(int64_t w, uint4 v) const {
    const uint32_t c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t z = (c[i] - 0x01010101u) & ~c[i] & 0x80808080u;
      if (z)
        return (int64_t)(a0 + 16 * (uintptr_t)w + 4 * i +
                         ((__ffs(z) - 1) >> 3) - lo);
    }
    return INT64_MAX;
  }

  // The word holding row byte i.
  __device__ __forceinline__ int64_t word_of(int64_t i) const {
    return (int64_t)((lo + i - a0) >> 4);
  }
};

__device__ __forceinline__ int64_t warp_min_i64(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t y = __shfl_xor_sync(kFull, v, o);
    v = y < v ? y : v;
  }
  return v;
}

// Block min of an int64 (every thread gets it). sh: >= 33 values.
__device__ __forceinline__ int64_t block_min(int64_t v, int64_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min_i64(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int64_t x = warp_min_i64(lane < kWarps ? sh[lane] : INT64_MAX);
    if (lane == 0) sh[32] = x;
  }
  __syncthreads();
  const int64_t r = sh[32];
  __syncthreads();
  return r;
}

// The minimum of v over the row's threads in geometry G (every thread
// gets it); `arr` is a cluster-shared slot array.
template <int G>
__device__ __forceinline__ int64_t row_min(int64_t v, int64_t* shi,
                                           int64_t* arr) {
  if (G == kGeomWarp) return warp_min_i64(v);
  v = block_min(v, shi);
  if (G != kGeomCluster) return v;
  cg::cluster_group cl = cg::this_cluster();
  cluster_share(cl, v, arr);
  int64_t r = INT64_MAX;
  for (unsigned j = 0; j < cl.num_blocks(); ++j) r = arr[j] < r ? arr[j] : r;
  return r;
}

// The first index of the largest of x[0, n) (torch.argmax's and
// jnp.argmax's tie rule) over the row's T threads, thread t taking
// entries t, t + T, ...
template <int G>
__device__ __forceinline__ int64_t row_argmax(const float* __restrict__ x,
                                              int64_t n, int t, int T,
                                              float* shf, int64_t* shi,
                                              ClusterSh* cs) {
  float m = -INFINITY;
  int64_t at = INT64_MAX;
  for (int64_t i = t; i < n; i += T) {
    const float v = x[i];
    if (v > m || at == INT64_MAX) {
      m = v;
      at = i;
    }
  }
  float best;
  if (G == kGeomWarp) {
    best = pclean_warp_max(m);
  } else {
    best = pclean_block_max(m, shf);
    if (G == kGeomCluster) {
      cg::cluster_group cl = cg::this_cluster();
      cluster_share(cl, best, cs->m);
      for (unsigned j = 0; j < cl.num_blocks(); ++j)
        best = fmaxf(best, cs->m[j]);
    }
  }
  return row_min<G>(m == best ? at : INT64_MAX, shi, cs->j);
}

// A block row at three blocks an SM (40 registers, some spilled; on the
// H100 at [4,096, 11,265] 0.1169 device ms against 0.1454 at two), a
// cluster's block at two.
template <int G>
__global__ void __launch_bounds__(kThreads, G == kGeomBlock ? 3
                                             : G == kGeomCluster ? 2 : 1)
    fk_sample_kernel(const __grid_constant__ K16Plan p) {
  // mask words a thread loads before the draw: two a lane of a warp row,
  // one a thread of a block (which keeps the block's registers at two
  // blocks an SM)
  constexpr int kPre = G == kGeomWarp ? 2 : 1;
  extern __shared__ float4 buf4[];
  __shared__ float shf[33];
  __shared__ u64 shs[kWarps + 1];
  __shared__ int64_t shi[33];
  __shared__ int32_t drawn;
  __shared__ ClusterSh cs;
  const int64_t* w = p.w;
  const int64_t B = w[kB], K = w[kK1] - 1, cap = w[kCap];

  // the row and this thread's place t among its T threads
  int64_t b;
  int t, T;
  if (G == kGeomWarp) {
    b = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= B) return;   // the whole warp
    t = threadIdx.x & 31;
    T = 32;
  } else if (G == kGeomCluster) {
    cluster_arrive_relaxed();
    cg::cluster_group cl = cg::this_cluster();
    b = blockIdx.x / cl.num_blocks();
    t = (int)cl.block_rank() * kThreads + threadIdx.x;
    T = (int)cl.num_blocks() * kThreads;
  } else {
    b = blockIdx.x;
    t = threadIdx.x;
    T = kThreads;
  }

  const MaskRow mr(reinterpret_cast<const uint8_t*>(w[kMaskIn]) +
                       b * w[kMaskInS],
                   reinterpret_cast<uint8_t*>(w[kMaskOut]) + b * cap, cap);
  const bool copy = mr.mi != mr.mo;
  uint4 pre[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k)
    if (t + (int64_t)k * T < mr.W) pre[k] = mr.load(t + (int64_t)k * T);

  const float* x = reinterpret_cast<const float*>(w[kRec]) +
                   pclean_rec_offset(w + kAxes, w[kNd], w[kRecB], b);
  int64_t chosen, rv = 0;
  bool dead = false;
  if (w[kRv] != 0) {
    if (G == kGeomCluster) cluster_wait();
    rv = pclean_ld_i(w[kRv], w[kRvDt], b);
    const int64_t r = pclean_clamp(rv, cap);
    const bool live =
        reinterpret_cast<const uint8_t*>(w[kRelAlive])[b * w[kRelAliveS] +
                                                       r] != 0 &&
        reinterpret_cast<const int32_t*>(w[kRelRc])[b * w[kRelRcS] + r] > 0;
    const int64_t pos =
        w[kCompInv] != 0
            ? pclean_ld_i(w[kCompInv], w[kCompInvDt],
                          pclean_clamp(rv, w[kCompInvN]))
            : rv;
    chosen = live ? pos : K;
    dead = !live;
  } else {
    const float u = reinterpret_cast<const float*>(w[kU])[b * w[kUStride]];
    if (G == kGeomWarp) {
      chosen = draw_warp(x, K + 1, u);
    } else if (G == kGeomCluster) {
      draw_cluster<true>(x, K + 1, u, buf4, shf, shs, &cs, nullptr);
      chosen = cs.drawn;
    } else {
      draw_row(x, K + 1, w[kTile], u, buf4, shf, shs, &drawn);
      __syncthreads();
      chosen = drawn;
    }
  }

  // the mask row: copied into the output row where they differ, and the
  // first dead slot
  int64_t first = INT64_MAX;
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int64_t wk = t + (int64_t)k * T;
    if (wk < mr.W) {
      if (copy) mr.store(wk, pre[k]);
      const int64_t f = mr.first_dead(wk, pre[k]);
      first = f < first ? f : first;
    }
  }
  for (int64_t wk = t + (int64_t)kPre * T; wk < mr.W; wk += 2 * T) {
    const bool two = wk + T < mr.W;   // two words' loads in flight
    const uint4 v0 = mr.load(wk);
    uint4 v1 = v0;
    if (two) v1 = mr.load(wk + T);
    if (copy) mr.store(wk, v0);
    int64_t f = mr.first_dead(wk, v0);
    first = f < first ? f : first;
    if (two) {
      if (copy) mr.store(wk + T, v1);
      f = mr.first_dead(wk + T, v1);
      first = f < first ? f : first;
    }
  }
  first = row_min<G>(first, shi, cs.i);
  const bool has_free = first < cap;
  const int64_t free_slot = has_free ? first : 0;

  bool is_new = chosen == K;
  if (is_new && !has_free) {   // full arena: the best existing candidate
    chosen = row_argmax<G>(x, K, t, T, shf, shi, &cs);
    is_new = false;
  }
  const bool gate = reinterpret_cast<const uint8_t*>(w[kGate])[b] != 0;
  const bool eff = is_new && gate;
  const int64_t slot = (w[kRv] != 0 && dead) ? rv : free_slot;
  // the born slot's alive byte, by the thread that copied its word
  if (eff && slot >= 0 && slot < cap && mr.word_of(slot) % T == t)
    mr.mo[slot] = 1;
  if (t != 0) return;
  const int64_t c_exist = chosen < K - 1 ? chosen : K - 1;
  int64_t c_slot = c_exist;
  if (w[kCompIdx] != 0) {
    c_slot = pclean_ld_i(w[kCompIdx], w[kCompIdxDt],
                         pclean_clamp(c_exist, w[kCompIdxN]));
    c_slot = c_slot < cap - 1 ? c_slot : cap - 1;
  }
  int32_t* ints = reinterpret_cast<int32_t*>(w[kInts]);
  uint8_t* flags = reinterpret_cast<uint8_t*>(w[kFlags]);
  ints[b] = (int32_t)(is_new ? slot : c_slot);
  ints[B + b] = (int32_t)c_exist;
  ints[2 * B + b] = (int32_t)c_slot;
  ints[3 * B + b] = (int32_t)slot;
  flags[b] = is_new;
  flags[B + b] = eff;
}

template <int G>
cudaError_t launch(const K16Plan& p, int64_t B, int smem, int64_t cluster,
                   cudaStream_t st) {
  static int smem_limit = 48 * 1024;
  const cudaError_t e = smem_attr(fk_sample_kernel<G>, smem, &smem_limit);
  if (e != cudaSuccess) return e;
  const int threads = G == kGeomWarp ? 32 * (int)warp_rows(B) : kThreads;
  const int64_t rows = threads / 32;
  const int64_t blocks = G == kGeomWarp ? (B + rows - 1) / rows
                         : G == kGeomCluster ? B * cluster : B;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  if (G == kGeomCluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t le = cudaLaunchKernelEx(&cfg, fk_sample_kernel<G>, p);
    if (le != cudaSuccess) return le;
  } else {
    fk_sample_kernel<G><<<(unsigned)blocks, threads, smem, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// words: the plan (ops.fk_sample's words, K16_WORDS of them). Returns
// cudaErrorInvalidValue for a plan it does not take, the error of raising
// the shared-memory limit where the card refuses the draw's smem, else
// the launch's error or cudaGetLastError() after it.
extern "C" int pclean_fk_sample(const int64_t* words, int n_words,
                                void* stream) {
  if (n_words != K16_WORDS) return (int)cudaErrorInvalidValue;
  K16Plan p;
  for (int i = 0; i < K16_WORDS; ++i) p.w[i] = words[i];
  const int64_t B = p.w[kB], K1 = p.w[kK1], g = p.w[kGeom];
  const int64_t cl = g == kGeomCluster ? p.w[kCluster] : 1;
  const bool drawn = p.w[kRv] == 0;
  if (B < 0 || K1 < 2 || K1 > (1ll << 21) || p.w[kCap] < 1 ||
      p.w[kNd] < 0 || p.w[kNd] > K16_MAX_ANC || p.w[kRec] == 0 ||
      p.w[kGate] == 0 || p.w[kMaskIn] == 0 || p.w[kMaskOut] == 0 ||
      p.w[kInts] == 0 || p.w[kFlags] == 0 || (drawn && p.w[kU] == 0) ||
      (!drawn && (p.w[kRelAlive] == 0 || p.w[kRelRc] == 0)) ||
      g < kGeomWarp || g > kGeomStream ||
      (g == kGeomCluster && (cl < 2 || cl > kMaxCluster)))
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  if (drawn) {
    const int64_t tile = p.w[kTile];
    if (g == kGeomCluster) {
      smem = (int)((cluster_slice(K1, (int)cl) + 4) * 4);
    } else if (g != kGeomWarp) {
      if (!plan_ok(K1, tile, (int)(((tile < K1 ? tile : K1) + 4) * 4)) ||
          (g == kGeomBlock) != (tile >= K1))
        return (int)cudaErrorInvalidValue;
      smem = (int)(((tile < K1 ? tile : K1) + 4) * 4);
    }
  } else if (g == kGeomStream) {
    return (int)cudaErrorInvalidValue;   // no draw: no tiles
  }
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (g) {
    case kGeomWarp: return (int)launch<kGeomWarp>(p, B, smem, cl, st);
    case kGeomCluster: return (int)launch<kGeomCluster>(p, B, smem, cl, st);
    default: return (int)launch<kGeomBlock>(p, B, smem, cl, st);
  }
}
