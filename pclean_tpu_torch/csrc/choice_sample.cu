// K17 choice_sample: one choice's sample step for every row of a block
// proposal, in one launch: a draw, a retained value, or a recorded pick;
// and, in group mode, the draws of every ancestor-free draw-mode choice of
// a block in one launch.
//
// Replaces pclean_tpu/engine/propose.py BlockTracer.sample_choice
// (propose.py:981-1019), with _inv_cdf_from_u (:1153-1172) and the record
// pick at the ancestor positions (rec[anc] under vmap): for row b, with
// r = rec[b, anc_0[b], .., anc_{d-1}[b]] (each index clamped into its
// axis, as JAX's gather clamps),
//   draw mode:     out[b] = the draw over the V logits r at u[b]
//                  (inv_cdf.cuh: K2's index);
//   retained mode: out[b] = rv[b], or the dummy code where the choice has
//                  one and r[clamp(rv[b])] <= NEG_INF / 2 (a retained value
//                  outside the enumerated support);
//   pick mode:     out[b] = r, the one recorded value of the row (a
//                  statically observed value or a score-pass prior draw),
//                  copied in its own dtype;
//   group mode:    out[m, b] = the draw over member m's V_m logits
//                  rec_m[b] (a record with no ancestor axis) at
//                  pool[b, col_m], for up to K17_GROUP_MAX members.
// Draw, retained and group modes write int32.
//
// Bound on the H100 (3.35 TB/s): bytes. A draw reads a row's V logits
// and writes 4 bytes (B = 4,096, V = 7,735: 127 MB, ~38 us); at one row
// the launch and the draw's dependent steps bind, not the bytes.
//
// Design: each draw runs in the geometry ops.draw_plan gives its (B, V)
// (inv_cdf.cuh): a warp a row (several rows a block, no block barrier),
// a block of 512 a row, a cluster of up to 8 blocks over one row, or
// the streamed tiles; every geometry returns K2's index. A group launch
// lays its members' blocks out one after another (each member's run a
// multiple of the launch's cluster size) and each block finds its member
// by a binary search of the runs' starts; a member is drawn in its own
// geometry, so one launch mixes warp rows and block rows. Retained and
// pick modes are a thread a row, 256 threads a block. The plans
// (ops.choice_sample's and ops.choice_sample_group's words: pointers,
// strides, dtypes, geometries) are passed by value.

#include "inv_cdf.cuh"
#include "row_words.cuh"

#define K17_THREADS 256

namespace {

using namespace pclean_draw;

// Word indices of the plan (ops.choice_sample); from kAxes, each ancestor
// axis's stride, size, pointer and dtype (ops._rec_words).
enum {
  kB = 0, kV, kMode, kTile, kGeom, kRec, kNd, kRecB, kU, kUStride, kRv,
  kRvDt, kDummy, kHasDummy, kOut, kEsize, kCluster, kAxes
};

#define K17_MAX_ANC 7
#define K17_WORDS (kAxes + 4 * K17_MAX_ANC)

// The group plan (ops.choice_sample_group): a header, then each member's
// record pointer, record row stride (0: one row for every b), V, pool
// column, geometry, tile and cluster size.
enum { gN = 0, gB, gPool, gPool0, gPool1, gOut, gHead };
enum { mRec = 0, mStride, mV, mCol, mGeom, mTile, mCluster, mWords };
#define K17_GROUP_MAX 64
#define K17_GROUP_WORDS (gHead + mWords * K17_GROUP_MAX)

struct K17Plan {
  int64_t w[K17_WORDS];
};

struct K17Group {
  int64_t w[K17_GROUP_WORDS];
  int64_t start[K17_GROUP_MAX + 1];  // each member's first block
};

// The element offset of row b's record entry (its first logit).
__device__ __forceinline__ int64_t rec_offset(const int64_t* w, int64_t b) {
  return pclean_rec_offset(w + kAxes, w[kNd], w[kRecB], b);
}

// Rows a block draws in geometry g with `threads` threads, and the
// blocks a draw of B rows takes there.
__host__ __device__ __forceinline__ int64_t draw_blocks(int64_t g, int64_t B,
                                                        int threads,
                                                        int64_t cluster) {
  if (g == kGeomWarp) {
    const int64_t r = threads / 32;
    return (B + r - 1) / r;
  }
  return g == kGeomCluster ? B * cluster : B;
}

// The dynamic shared memory a draw of V entries takes in geometry g.
inline int draw_smem(int64_t g, int64_t V, int64_t tile, int64_t cluster) {
  if (g == kGeomWarp) return 0;
  if (g == kGeomCluster) return (int)((cluster_slice(V, (int)cluster) + 4) * 4);
  return (int)(((tile < V ? tile : V) + 4) * 4);
}

inline bool geom_ok(int64_t g, int64_t V, int64_t tile, int64_t cluster) {
  if (V < 1 || V > (1ll << 21)) return false;
  switch (g) {
    case kGeomWarp: return true;
    case kGeomBlock: return tile >= V;
    case kGeomStream: return tile >= 4 && tile % 4 == 0 && tile < V;
    case kGeomCluster: return cluster >= 2 && cluster <= kMaxCluster;
    default: return false;
  }
}

// The draw of row b of the rows a block takes (local block j of the
// draw's run): row(b, &x, &u) gives the row and its uniform; the index
// goes to out[b].
template <class Row>
__device__ __forceinline__ void draw_rows(int64_t g, int64_t j, int64_t B,
                                          int64_t V, int64_t tile,
                                          int64_t cluster, const Row& row,
                                          int32_t* out, float4* buf4,
                                          float* shf, u64* shs,
                                          ClusterSh* cs) {
  const float* x;
  float u;
  if (g == kGeomWarp) {
    const int64_t b = j * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= B) return;   // the whole warp
    row(b, &x, &u);
    const int64_t idx = draw_warp(x, V, u);
    if ((threadIdx.x & 31) == 0) out[b] = (int32_t)idx;
  } else if (g == kGeomCluster) {
    cluster_arrive_relaxed();
    const int64_t b = j / cluster;
    row(b, &x, &u);
    draw_cluster<false>(x, V, u, buf4, shf, shs, cs, out + b);
  } else {
    row(j, &x, &u);
    draw_row(x, V, tile, u, buf4, shf, shs, out + j);
  }
}

// One choice's draws, instantiated for each geometry (a launch has one).
// Two blocks an SM: at three a block row spills, and its launches on the
// paths (choices with ancestors, one row or a few) lose more to the
// spills than they gain.
template <int G>
__global__ void __launch_bounds__(kThreads, 2)
    choice_draw_kernel(const __grid_constant__ K17Plan p) {
  extern __shared__ float4 buf4[];
  __shared__ float shf[33];
  __shared__ u64 shs[kWarps + 1];
  __shared__ ClusterSh cs;
  const int64_t* w = p.w;
  const float* rec = reinterpret_cast<const float*>(w[kRec]);
  const float* U = reinterpret_cast<const float*>(w[kU]);
  const int64_t us = w[kUStride];
  auto row = [&](int64_t b, const float** x, float* u) {
    *x = rec + rec_offset(w, b);
    *u = U[b * us];
  };
  draw_rows(G == kGeomStream ? kGeomBlock : G, blockIdx.x, w[kB], w[kV],
            w[kTile], w[kCluster], row, reinterpret_cast<int32_t*>(w[kOut]),
            buf4, shf, shs, &cs);
}

__global__ void __launch_bounds__(kThreads, 2)
    choice_group_kernel(const __grid_constant__ K17Group p) {
  extern __shared__ float4 buf4[];
  __shared__ float shf[33];
  __shared__ u64 shs[kWarps + 1];
  __shared__ ClusterSh cs;
  const int64_t* w = p.w;
  const int64_t n = w[gN], B = w[gB];
  // the member whose run holds this block: the last start <= blockIdx.x
  int lo = 0, hi = (int)n - 1;
  const int64_t blk = blockIdx.x;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.start[mid] <= blk) lo = mid; else hi = mid - 1;
  }
  const int64_t* m = w + gHead + mWords * lo;
  const int64_t j = blk - p.start[lo];
  if (j >= draw_blocks(m[mGeom], B, blockDim.x, m[mCluster])) return;
  const float* rec = reinterpret_cast<const float*>(m[mRec]);
  const int64_t rs = m[mStride];
  const float* pool = reinterpret_cast<const float*>(w[gPool]) +
                      m[mCol] * w[gPool1];
  const int64_t ps = w[gPool0];
  auto row = [&](int64_t b, const float** x, float* u) {
    *x = rec + b * rs;
    *u = pool[b * ps];
  };
  draw_rows(m[mGeom], j, B, m[mV], m[mTile], m[mCluster], row,
            reinterpret_cast<int32_t*>(w[gOut]) + lo * B, buf4, shf, shs,
            &cs);
}

__global__ void __launch_bounds__(K17_THREADS)
    choice_row_kernel(const __grid_constant__ K17Plan p) {
  const int64_t* w = p.w;
  const int64_t b = (int64_t)blockIdx.x * K17_THREADS + threadIdx.x;
  if (b >= w[kB]) return;
  const int64_t off = rec_offset(w, b);
  if (w[kMode] == 2) {   // pick: the recorded value's bytes
    const int64_t es = w[kEsize];
    const uint8_t* src = reinterpret_cast<const uint8_t*>(w[kRec]) + off * es;
    uint8_t* dst = reinterpret_cast<uint8_t*>(w[kOut]) + b * es;
    switch (es) {
      case 1: *dst = *src; break;
      case 2: *reinterpret_cast<uint16_t*>(dst) =
                  *reinterpret_cast<const uint16_t*>(src); break;
      case 4: *reinterpret_cast<uint32_t*>(dst) =
                  *reinterpret_cast<const uint32_t*>(src); break;
      default: *reinterpret_cast<uint64_t*>(dst) =
                   *reinterpret_cast<const uint64_t*>(src);
    }
    return;
  }
  const int64_t rv = pclean_ld_i(w[kRv], w[kRvDt], b);
  int64_t chosen = rv;
  if (w[kHasDummy]) {
    const float* x = reinterpret_cast<const float*>(w[kRec]) + off;
    if (!(x[pclean_clamp(rv, w[kV])] > PCLEAN_NEG_INF / 2)) chosen = w[kDummy];
  }
  reinterpret_cast<int32_t*>(w[kOut])[b] = (int32_t)chosen;
}

// Launches `kernel` on `blocks` blocks of `threads`, in clusters of
// `cluster` blocks where cluster > 1.
template <class Kernel, class Plan>
cudaError_t launch(Kernel kernel, const Plan& p, int64_t blocks, int threads,
                   int smem, int64_t cluster, cudaStream_t st) {
  if (cluster > 1) {
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
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
    if (e != cudaSuccess) return e;
  } else {
    kernel<<<(unsigned)blocks, threads, smem, st>>>(p);
  }
  return cudaGetLastError();
}

// Threads a block of a draw launch: 512, or a warp a row for warp_rows(B)
// rows where every draw of the launch is a warp's.
inline int draw_threads(bool all_warp, int64_t B) {
  return all_warp ? 32 * (int)warp_rows(B) : kThreads;
}

}  // namespace

// words: the plan (ops.choice_sample's words, K17_WORDS of them); mode 0
// draw, 1 retained, 2 pick. Returns cudaErrorInvalidValue for a plan it
// does not take, the error of raising the shared-memory limit where the
// card refuses the draw's smem, else the launch's error or
// cudaGetLastError() after it.
extern "C" int pclean_choice_sample(const int64_t* words, int n_words,
                                    void* stream) {
  if (n_words != K17_WORDS) return (int)cudaErrorInvalidValue;
  K17Plan p;
  for (int i = 0; i < K17_WORDS; ++i) p.w[i] = words[i];
  const int64_t B = p.w[kB], mode = p.w[kMode];
  if (B < 0 || mode < 0 || mode > 2 || p.w[kV] < 1 || p.w[kNd] < 0 ||
      p.w[kNd] > K17_MAX_ANC || p.w[kRec] == 0 || p.w[kOut] == 0 ||
      (mode == 0 && p.w[kU] == 0) || (mode == 1 && p.w[kRv] == 0) ||
      (mode == 2 && p.w[kEsize] != 1 && p.w[kEsize] != 2 &&
       p.w[kEsize] != 4 && p.w[kEsize] != 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode != 0) {
    const int64_t blocks = (B + K17_THREADS - 1) / K17_THREADS;
    return (int)launch(choice_row_kernel, p, blocks, K17_THREADS, 0, 1, st);
  }
  const int64_t g = p.w[kGeom], cl = g == kGeomCluster ? p.w[kCluster] : 1;
  if (!geom_ok(g, p.w[kV], p.w[kTile], cl)) return (int)cudaErrorInvalidValue;
  const int smem = draw_smem(g, p.w[kV], p.w[kTile], cl);
  const int threads = draw_threads(g == kGeomWarp, B);
  const int64_t blocks = draw_blocks(g, B, threads, cl);
  cudaError_t e;
  switch (g) {
    case kGeomWarp: {
      e = launch(choice_draw_kernel<kGeomWarp>, p, blocks, threads, smem, cl,
                 st);
      break;
    }
    case kGeomCluster: {
      static int limit = 48 * 1024;
      e = smem_attr(choice_draw_kernel<kGeomCluster>, smem, &limit);
      if (e == cudaSuccess)
        e = launch(choice_draw_kernel<kGeomCluster>, p, blocks, threads,
                   smem, cl, st);
      break;
    }
    default: {   // block, stream: draw_row
      static int limit = 48 * 1024;
      e = smem_attr(choice_draw_kernel<kGeomBlock>, smem, &limit);
      if (e == cudaSuccess)
        e = launch(choice_draw_kernel<kGeomBlock>, p, blocks, threads, smem,
                   cl, st);
    }
  }
  return (int)e;
}

// words: the group plan (ops.choice_sample_group's words: the header and
// n_members x mWords member words, n_members <= K17_GROUP_MAX). Lays out
// the members' block runs (each a multiple of the launch's cluster size,
// the largest of its members'). Returns cudaErrorInvalidValue for a plan
// it does not take, else as pclean_choice_sample.
extern "C" int pclean_choice_sample_group(const int64_t* words, int n_words,
                                          void* stream) {
  if (n_words < gHead) return (int)cudaErrorInvalidValue;
  const int64_t n = words[gN], B = words[gB];
  if (n < 1 || n > K17_GROUP_MAX || n_words != gHead + mWords * n || B < 0 ||
      words[gPool] == 0 || words[gOut] == 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  K17Group p;
  for (int i = 0; i < K17_GROUP_WORDS; ++i)
    p.w[i] = i < n_words ? words[i] : 0;
  int64_t cl = 1;
  bool all_warp = true;
  int smem = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* m = p.w + gHead + mWords * i;
    const int64_t g = m[mGeom], c = g == kGeomCluster ? m[mCluster] : 1;
    if (m[mRec] == 0 || m[mStride] < 0 || m[mCol] < 0 ||
        !geom_ok(g, m[mV], m[mTile], c))
      return (int)cudaErrorInvalidValue;
    cl = c > cl ? c : cl;
    all_warp = all_warp && g == kGeomWarp;
    const int s = draw_smem(g, m[mV], m[mTile], c);
    smem = s > smem ? s : smem;
  }
  // every cluster member of the launch takes its cluster size
  const int threads = draw_threads(all_warp, B);
  int64_t at = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t* m = p.w + gHead + mWords * i;
    if (m[mGeom] == kGeomCluster) m[mCluster] = cl;
    p.start[i] = at;
    const int64_t nb = draw_blocks(m[mGeom], B, threads, m[mCluster]);
    at += (nb + cl - 1) / cl * cl;
  }
  // (a cluster member's slice at cl >= its own size is no longer)
  for (int64_t i = n; i <= K17_GROUP_MAX; ++i) p.start[i] = at;
  if (at > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  static int smem_limit = 48 * 1024;
  const cudaError_t e = smem_attr(choice_group_kernel, smem, &smem_limit);
  if (e != cudaSuccess) return (int)e;
  return (int)launch(choice_group_kernel, p, at, threads, smem, cl,
                     (cudaStream_t)stream);
}
